"""Batched banded alignment against haplotype-text windows (plain torch).

The PyTorch counterpart of vg_tpu/ops/align.py: the reference's DP kernel
stack (gssw graph Smith-Waterman, dozeu X-drop tails, banded global
aligner — reference: src/aligner.cpp, src/dozeu_interface.cpp,
src/banded_global_aligner.cpp) collapses, on the flat haplotype text, to
banded sequence-vs-sequence DP:

  score[r, c] = best semiglobal alignment of read r against the text
                window of candidate c

Semantics (vg's Aligner defaults, reference src/alignment_scorer.hpp:17-28):
match +1, mismatch -4, gap open 6, gap extend 1 (a length-g gap costs
open + (g-1)*ext), full-length bonus +5 per read end included in the
alignment; soft-clips free.

The DP is a loop over read rows; the in-row affine deletion recurrence is
resolved exactly with a cumulative max along the band
(E[j] = max_{j'<j}(H[j'] + ext*j') - open - ext*(j-1)). This module is the
plain version: the card runs the hand-written kernel in ops/cuda_align.py,
which reuses `banded_dp` below as its reference, for the unadjusted and
the quality-adjusted scoring (`banded_scores_qual`) alike.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

NEG = -(10**8)  # effective -inf for int32 DP
SENTINEL = 6    # window code that never matches any read code


@dataclass(frozen=True)
class Scoring:
    match: int = 1
    mismatch: int = 4
    gap_open: int = 6        # cost of a length-1 gap
    gap_extend: int = 1
    full_length_bonus: int = 5

    def gap_cost(self, length: int) -> int:
        if length <= 0:
            return 0
        return self.gap_open + (length - 1) * self.gap_extend


DEFAULT_SCORING = Scoring()


def banded_dp(win: torch.Tensor, rd: torch.Tensor, rlen: torch.Tensor,
              *, band_radius: int, match: int, mismatch: int,
              gap_open: int, gap_extend: int, bonus: int,
              row_scores=None, end_bonus=None) -> torch.Tensor:
    """DP over pre-gathered windows: win (..., TW) uint8 with
    TW >= RL + 2B, rd (..., RL) oriented reads, rlen (...) int32 read
    lengths (0 = no rows). Returns the best score (...) int32, >= 0.

    Row i aligns to window columns [i, i + 2B]; rows at i >= rlen leave
    the state untouched, and the full-length bonus joins at row rlen-1.

    Quality-adjusted scoring (banded_scores_qual) passes per-row scores
    instead of match / mismatch: row_scores = (match, mismatch) int32
    (..., RL), the mismatch signed, and end_bonus = (first, last) int32
    (...): the left bonus (the initial H) and the one that joins at row
    rlen-1. A read code >= 4 scores the row's mismatch either way."""
    RL = rd.shape[-1]
    W = 2 * band_radius + 1
    shape = rd.shape[:-1]
    dev = rd.device
    i32 = torch.int32
    win = win.to(i32)
    rd = rd.to(i32)
    rlen = rlen.to(i32)
    if row_scores is None:
        hit = miss = None
    else:
        hit, miss = (x.to(i32) for x in row_scores)
    if end_bonus is None:
        H = torch.full((*shape, W), bonus, dtype=i32, device=dev)
        last_bonus = bonus
    else:
        H = end_bonus[0].to(i32)[..., None].expand(*shape, W).clone()
        last_bonus = end_bonus[1].to(i32)
    F = torch.full((*shape, W), NEG, dtype=i32, device=dev)
    best = torch.zeros(shape, dtype=i32, device=dev)
    negcol = torch.full((*shape, 1), NEG, dtype=i32, device=dev)
    ramp = gap_extend * torch.arange(W, dtype=i32, device=dev)
    for i in range(RL):
        rrow = rd[..., i : i + 1]
        same = (win[..., i : i + W] == rrow) & (rrow < 4)
        if hit is None:
            sub = torch.where(same, match, -mismatch).to(i32)
        else:
            sub = torch.where(same, hit[..., i : i + 1], miss[..., i : i + 1])
        diag = H + sub
        shH = torch.cat([H[..., 1:], negcol], dim=-1)
        shF = torch.cat([F[..., 1:], negcol], dim=-1)
        Fn = torch.maximum(shH - gap_open, shF - gap_extend)
        Hn = torch.clamp_min(torch.maximum(diag, Fn), 0)
        G = torch.cummax(Hn + ramp, dim=-1).values
        Gprev = torch.cat([negcol, G[..., :-1]], dim=-1)
        Hf = torch.maximum(Hn, Gprev - gap_open - ramp + gap_extend)
        active = (i < rlen)[..., None]
        H = torch.where(active, Hf, H)
        F = torch.where(active, Fn, F)
        row_max = Hf.max(dim=-1).values
        best = torch.where(i < rlen, torch.maximum(best, row_max), best)
        best = torch.where(i + 1 == rlen,
                           torch.maximum(best, row_max + last_bonus), best)
    return best


def banded_scores(
    text: torch.Tensor,        # (T,) uint8 haplotype text codes
    reads: torch.Tensor,       # (R, RL) uint8, padded with code 4/5
    reads_rc: torch.Tensor,    # (R, RL) uint8 reverse complements (padded)
    rlen: torch.Tensor,        # (R,) int32 true lengths
    cand_start: torch.Tensor,  # (R, C) int32 window start in text (= diag - B)
    cand_lo: torch.Tensor,     # (R, C) int32 haplotype text range of candidate
    cand_hi: torch.Tensor,     # (R, C) int32
    cand_rev: torch.Tensor,    # (R, C) bool — align reverse complement of read
    cand_valid: torch.Tensor,  # (R, C) bool
    *,
    band_radius: int = 16,
    match: int = 1,
    mismatch: int = 4,
    gap_open: int = 6,
    gap_extend: int = 1,
    bonus: int = 5,
) -> torch.Tensor:
    """Best semiglobal score per (read, candidate); -1 for invalid slots.

    Window length is RL + 2*band_radius; read row i may align to window
    columns [i, i + 2B], i.e. text positions diag + [-B, +B].
    """
    win = text_windows(text, cand_start, cand_lo, cand_hi,
                       reads.shape[1] + 2 * band_radius)
    s = _score_windows(win, reads, reads_rc, rlen, cand_rev, band_radius,
                       match, mismatch, gap_open, gap_extend, bonus)
    return torch.where(cand_valid, s, -1).to(torch.int32)


def _score_windows(win, reads, reads_rc, rlen, cand_rev, band_radius,
                   match, mismatch, gap_open, gap_extend, bonus):
    """Orient each candidate's read and run banded_dp on (R, C) windows."""
    rd = torch.where(cand_rev[:, :, None], reads_rc[:, None, :],
                     reads[:, None, :])
    rl = rlen.to(torch.int32)[:, None].expand(cand_rev.shape)
    return banded_dp(win, rd, rl, band_radius=band_radius, match=match,
                     mismatch=mismatch, gap_open=gap_open,
                     gap_extend=gap_extend, bonus=bonus)


def text_windows(text: torch.Tensor, cand_start: torch.Tensor,
                 cand_lo: torch.Tensor, cand_hi: torch.Tensor,
                 TW: int) -> torch.Tensor:
    """(R, C, TW) uint8 windows text[start + j], masked to [lo, hi) and
    [0, T) with the sentinel."""
    T = text.shape[0]
    pos = (cand_start.to(torch.int64)[:, :, None]
           + torch.arange(TW, device=text.device))
    ok = ((pos >= cand_lo[:, :, None]) & (pos < cand_hi[:, :, None])
          & (pos >= 0) & (pos < T))
    return torch.where(ok, text[pos.clamp(0, T - 1)], SENTINEL).to(
        torch.uint8)


def banded_scores_qual(
    text: torch.Tensor, reads: torch.Tensor, reads_rc: torch.Tensor,
    quals: torch.Tensor,         # (R, RL) uint8 phred (forward orientation)
    rlen: torch.Tensor,
    cand_start: torch.Tensor, cand_lo: torch.Tensor, cand_hi: torch.Tensor,
    cand_rev: torch.Tensor, cand_valid: torch.Tensor,
    match_tab: torch.Tensor,     # (Q+1,) int32 per-quality match score
    mism_tab: torch.Tensor,      # (Q+1,) int32 SIGNED mismatch score
    bonus_tab: torch.Tensor,     # (Q+1,) int32 full-length bonus
    *,
    band_radius: int = 16,
    gap_open: int = 6,
    gap_extend: int = 1,
) -> torch.Tensor:
    """banded_scores with base-quality-adjusted match/mismatch scores and
    full-length bonuses (the QualAdjAligner role, reference
    src/aligner.hpp:218; tables from ops/qualadj). A low-quality base's
    mismatch costs little (an error was expected) and its match earns
    little. Gap costs stay unadjusted, as in the reference. The plain
    version of ops/cuda_align.banded_scores_qual_packed."""
    win = text_windows(text, cand_start, cand_lo, cand_hi,
                       reads.shape[1] + 2 * band_radius)
    s = score_windows_qual(win, reads, reads_rc, quals, rlen, cand_rev,
                           match_tab, mism_tab, bonus_tab, band_radius,
                           gap_open, gap_extend)
    return torch.where(cand_valid, s, -1).to(torch.int32)


def score_windows_qual(win, reads, reads_rc, quals, rlen, cand_rev,
                       match_tab, mism_tab, bonus_tab, band_radius,
                       gap_open, gap_extend):
    """The quality-adjusted DP on (R, C) windows. A reverse candidate's
    quality at row i is quals[clip(rlen-1-i, 0, RL-1)]; the table index
    is clipped to the tables' last entry; the left bonus is taken at the
    first oriented base's quality, the right one at row rlen-1's."""
    R, RL = reads.shape
    C = cand_rev.shape[1]
    rl = rlen[:R].to(torch.int64)
    ridx = torch.arange(RL, device=reads.device)
    qrev_idx = (rl[:, None] - 1 - ridx[None, :]).clamp(0, RL - 1)
    quals_rc = torch.gather(quals, 1, qrev_idx)
    qd = torch.where(cand_rev[:, :, None], quals_rc[:, None, :],
                     quals[:, None, :])                          # (R,C,RL)
    q_i = qd.to(torch.int64).clamp(0, match_tab.shape[0] - 1)
    qlast = torch.gather(q_i, 2, (rl - 1).clamp(0, RL - 1)[:, None, None]
                         .expand(R, C, 1))[:, :, 0]
    rd = torch.where(cand_rev[:, :, None], reads_rc[:, None, :],
                     reads[:, None, :])
    return banded_dp(win, rd, rl.to(torch.int32)[:, None].expand(R, C),
                     band_radius=band_radius, match=0, mismatch=0,
                     gap_open=gap_open, gap_extend=gap_extend, bonus=0,
                     row_scores=(match_tab[q_i], mism_tab[q_i]),
                     end_bonus=(bonus_tab[q_i[:, :, 0]], bonus_tab[qlast]))


def gapless_mismatches(
    text: np.ndarray, read: np.ndarray, diag: int, lo: int, hi: int
) -> np.ndarray:
    """Host helper: mismatch mask of read vs text[diag : diag+len] (clipped
    to [lo, hi)); out-of-range counts as mismatch."""
    L = len(read)
    pos = diag + np.arange(L)
    ok = (pos >= lo) & (pos < hi)
    t = np.where(ok, text[np.clip(pos, 0, len(text) - 1)], SENTINEL)
    return (t != read) | (read >= 4)
