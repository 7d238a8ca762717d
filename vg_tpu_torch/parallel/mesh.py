"""Single-device mapping steps: DP, pair selection, MAPQ, winner payloads.

The torch port of the single-device half of vg_tpu/parallel/mesh.py
(make_single_step, make_paired_step and their helpers). The reference
parallelizes with OpenMP threads over read batches
(vg::io::for_each_parallel, reference src/subcommand/giraffe_main.cpp:2369);
here one step scores every (read, candidate) on the card and selects
winners there, so only the winners' payload returns to the host.

Floating point follows the JAX reference operation by operation in
float32 (constants such as sqrt(2*pi), log(10) are rounded to float32
before use, as JAX does with x64 off), so MAPQs truncate identically.
The sharded steps and make_mesh wait for the multi-GPU port.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops import align as align_ops
from ..ops import cuda_align

F32 = torch.float32
NEGF = -1e30               # float32(-1e30) in the reference


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=F32, device=device)


def _mapq_scale(device) -> torch.Tensor:
    """-10 / log(10), evaluated in float32 like jnp.log(10.0)."""
    return -10.0 / torch.log(_f32(10.0, device))


def _one_minus(delta: torch.Tensor) -> torch.Tensor:
    """log(1 - exp(delta)) for delta < -1e-12, else -50 (reference)."""
    return torch.where(delta < -1e-12,
                       torch.log1p(-torch.exp(torch.clamp_max(delta, -1e-12))),
                       _f32(-50.0, delta.device))


def _take(a: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, 1, j.to(torch.int64)[:, None])[:, 0]


def _to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def winner_mismatch_bits(text, text_len, text_packed, B,
                         reads, reads_rc, rlen, start, lo_a, hi_a, rev_a,
                         j):
    """Mismatch bitmap of the chosen winner's gapless alignment at its
    seed diagonal, computed where the text already lives (device memory)
    so the host emit path never re-gathers R x RL text windows. Bit k of
    word w = mismatch at read column w*32+k. text is the byte text, or
    the 4-bit packed words (ops/cuda_align.pack_text) when text_packed."""
    R, RL = reads.shape
    W = (RL + 31) // 32
    dev = reads.device
    T = text_len if text_len is not None else text.shape[0]
    diag = _take(start, j).to(torch.int64) + B
    lo_w = _take(lo_a, j)
    hi_w = _take(hi_a, j)
    rev_w = _take(rev_a, j).to(torch.bool)
    pos = diag[:, None] + torch.arange(RL, device=dev)
    okm = ((pos >= lo_w[:, None]) & (pos < hi_w[:, None])
           & (pos >= 0) & (pos < T))
    nt = text.shape[0]
    if text_packed:
        # base at p is nibble p % 8 of int32 word p // 8
        words = text[(pos >> 3).clamp(0, nt - 1)].to(torch.int64)
        base = ((words & 0xFFFFFFFF) >> ((pos & 7) * 4)) & 15
    else:
        base = text[pos.clamp(0, nt - 1)]
    tw = torch.where(okm, base, align_ops.SENTINEL).to(torch.uint8)
    oriented = torch.where(rev_w[:, None], reads_rc, reads)
    inread = (torch.arange(RL, device=dev)[None, :]
              < rlen[:R, None].to(torch.int64))
    msk = ((tw != oriented) | (oriented >= 4)) & inread
    mm = msk.sum(dim=1).to(torch.int32)
    padded = torch.zeros((R, W * 32), dtype=torch.int64, device=dev)
    padded[:, :RL] = msk.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    words = (padded.reshape(R, W, 32) << shifts).sum(dim=2)
    return mm, _to_i32_bits(words)


def derive_candidate_meta(diag, hb, stp, steps, node_len, nrp, nro):
    """Per-candidate (lo, hi, refpath, refoff) derived ON DEVICE from the
    seed diagonal text position and resident index arrays — so the host
    uploads only (start, rev|valid) per candidate. Mirrors the host
    formula (GiraffeMapper._diag_refproj)."""
    diag = diag.contiguous()
    hap = (torch.searchsorted(hb, diag, right=True) - 1).clamp(
        0, hb.shape[0] - 2)
    lo = hb[hap]
    hi = hb[hap + 1]
    si = (torch.searchsorted(stp, diag, right=True) - 1).clamp(
        0, steps.shape[0] - 1)
    h = steps[si]
    nidx = (h >> 1).to(torch.int64)
    off_visit = diag - stp[si]
    fwd_off = torch.where((h & 1).to(torch.bool),
                          node_len[nidx] - off_visit, off_visit)
    return lo, hi, nrp[nidx], nro[nidx] + fwd_off


# ------------------------------------------------------- full paired step

def _top2_T(smT):
    """Candidate-major top-2: (max, second-max) along axis 0 of (C, R)."""
    t0 = smT.max(dim=0).values
    am = torch.argmax(smT, dim=0)
    idx = torch.arange(smT.shape[0], device=smT.device)
    masked = torch.where(idx[:, None] == am[None, :],
                         _f32(NEGF, smT.device), smT)
    return t0, masked.max(dim=0).values


def _distinct_mask_T(scoresT, revT, rpT, roT, validT, tol):
    """Distinct-placement mask, candidate-major: inputs (C, R), dup mask
    over (C_i, C_j, R). axis0 = the candidate being tested (i), axis1 =
    the competitor (j)."""
    C = scoresT.shape[0]
    same = ((revT[:, None, :] == revT[None, :, :])
            & (rpT[:, None, :] >= 0)
            & (rpT[:, None, :] == rpT[None, :, :])
            & ((roT[:, None, :] - roT[None, :, :]).abs() <= tol))
    idx = torch.arange(C, device=scoresT.device)
    better = (scoresT[None, :, :] > scoresT[:, None, :]) | (
        (scoresT[None, :, :] == scoresT[:, None, :])
        & (idx[None, :, None] < idx[:, None, None]))
    dup = (same & better & validT[None, :, :]).any(dim=1)
    return ~dup


def _pair_core_T(f1T, f2T, vd1T, vd2T, fragT, properT, rl1, rl2, mu, sd,
                 lam, unpaired_penalty, max_mapq, max_fragment_length):
    """Pair selection + MAPQ + fragment statistics, candidate-major
    (C, C, R) / (C, R) float32. Tie-breaking: flat combo index i*C+j,
    argmax takes the first max."""
    dev = f1T.device
    negf = _f32(NEGF, dev)
    C = f1T.shape[0]
    ll = (-((fragT - mu) ** 2) / (2 * sd * sd)
          - torch.log(sd * torch.sqrt(_f32(2 * math.pi, dev))))
    pair_scaled = torch.where(
        properT, lam * (f1T[:, None, :] + f2T[None, :, :]) + ll, negf)
    flat = pair_scaled.reshape(C * C, -1)
    best_pair, best_combo = flat.max(dim=0).values, torch.argmax(flat, dim=0)
    j1p = torch.div(best_combo, C, rounding_mode="floor")
    j2p = best_combo % C

    m1 = torch.where(vd1T, f1T, negf)
    m2 = torch.where(vd2T, f2T, negf)
    b1 = torch.argmax(m1, dim=0)
    b2 = torch.argmax(m2, dim=0)
    zero = _f32(0.0, dev)
    s1b = torch.where(vd1T.any(dim=0), m1.max(dim=0).values, zero)
    s2b = torch.where(vd2T.any(dim=0), m2.max(dim=0).values, zero)
    indep = lam * (s1b + s2b) - lam * unpaired_penalty
    use_pair = (best_pair > negf / 2) & (best_pair >= indep)

    # pair MAPQ: logsumexp over proper combos
    lsep = best_pair + torch.log(torch.exp(torch.where(
        flat > negf / 2, flat - best_pair[None, :], negf)).sum(dim=0))
    deltap = best_pair - lsep
    scale = _mapq_scale(dev)
    mq_pair = torch.clamp(scale * _one_minus(deltap), 0, max_mapq)

    def end_mapq(fT, vdT, chosen):
        sc = torch.where(vdT, fT * lam, negf)
        mx = sc.max(dim=0).values
        lse = mx + torch.log(torch.exp(sc - mx[None, :]).sum(dim=0))
        oh = (torch.arange(C, device=dev)[:, None] == chosen[None, :])
        ch = torch.where(oh, fT, zero).sum(dim=0) * lam
        return torch.clamp(scale * _one_minus(ch - lse), 0, max_mapq)

    j1 = torch.where(use_pair, j1p, b1)
    j2 = torch.where(use_pair, j2p, b2)
    mq1s = end_mapq(f1T, vd1T, j1)
    mq2s = end_mapq(f2T, vd2T, j2)
    mq1 = torch.where(use_pair, torch.minimum(mq_pair, mq1s + 25), mq1s)
    mq2 = torch.where(use_pair, torch.minimum(mq_pair, mq2s + 25), mq2s)
    ohc = (torch.arange(C * C, device=dev)[:, None] == best_combo[None, :])
    frags = torch.where(ohc, fragT.reshape(C * C, -1), zero).sum(dim=0)
    frags = torch.where(use_pair, frags, zero)

    # fragment statistics over confident proper pairs
    t1a, t1b = _top2_T(m1)
    uniq1 = (s1b >= 0.8 * rl1) & ((vd1T.sum(0) <= 1) | (t1b < t1a - 5))
    t2a, t2b = _top2_T(m2)
    uniq2 = (s2b >= 0.8 * rl2) & ((vd2T.sum(0) <= 1) | (t2b < t2a - 5))
    obs = (use_pair & uniq1 & uniq2 & (frags > 0)
           & (frags <= max_fragment_length))
    stat_n = obs.sum().to(F32)
    stat_sum = torch.where(obs, frags, zero).sum()
    stat_sumsq = torch.where(obs, frags * frags, zero).sum()
    return (j1, j2, mq1, mq2, use_pair, frags,
            torch.stack([stat_n, stat_sum, stat_sumsq]))


def _default_score_fn(band_radius, match, mismatch, gap_open, gap_extend,
                      bonus):
    """The byte-text DP (vg_tpu's default score function): the kernel's
    byte-text entry on the card, its plain version ops/align.banded_scores
    for CPU tensors."""
    def score_fn(text, reads, reads_rc, rlen, cand):
        return cuda_align.banded_scores_bytes(
            text, reads, reads_rc, rlen, *cand[:5],
            band_radius=band_radius, match=match, mismatch=mismatch,
            gap_open=gap_open, gap_extend=gap_extend, bonus=bonus)
    return score_fn


def make_single_step(band_radius: int = 16, match: int = 1,
                     mismatch: int = 4, gap_open: int = 6,
                     gap_extend: int = 1, bonus: int = 5,
                     max_mapq: int = 60, score_fn=None,
                     text_packed: bool = False,
                     text_len: Optional[int] = None):
    """Single-end device step: DP scores + distinct-placement dedup +
    winner + MAPQ + winner mismatch bitmaps, one call (the torch port of
    GiraffeMapper.emit_batch_encoded's host selection)."""
    from ..map.giraffe import PLACEMENT_TOL
    from ..map.mapq import log_base

    lam = log_base(match, mismatch)
    B = band_radius
    if score_fn is None:
        score_fn = _default_score_fn(band_radius, match, mismatch, gap_open,
                                     gap_extend, bonus)

    def step(text, reads, reads_rc, rlen, cand, tol_div):
        (c_start, c_lo, c_hi, c_rev, c_valid, c_rp, c_ro) = cand
        s = score_fn(text, reads, reads_rc, rlen, cand)
        dev = s.device
        negf = _f32(NEGF, dev)
        fT = s.T.to(F32)
        validT = (c_valid & (s > 0)).T
        any_valid = validT.any(dim=0)
        maskedT = torch.where(validT, fT, _f32(-1.0, dev))
        best_j = torch.argmax(maskedT, dim=0)
        best_s = maskedT.max(dim=0).values
        uniqT = _distinct_mask_T(s.T, c_rev.T, c_rp.T, c_ro.T, validT,
                                 PLACEMENT_TOL)
        sc = torch.where(validT & uniqT, fT * lam, negf)
        mx = torch.maximum(sc.max(dim=0).values, best_s * lam)
        lse = mx + torch.log(torch.exp(sc - mx[None, :]).sum(dim=0))
        delta = best_s * lam - lse
        mapq = torch.clamp(_mapq_scale(dev) * _one_minus(delta), 0,
                           max_mapq)
        mapq = torch.where(torch.isfinite(mapq), mapq,
                           _f32(max_mapq, dev))
        mm, bits = winner_mismatch_bits(
            text, text_len, text_packed, B, reads, reads_rc, rlen,
            c_start, c_lo, c_hi, c_rev, best_j)
        return (s, best_j.to(torch.int32), mapq.to(torch.int32),
                any_valid, mm, bits)

    return step


def make_paired_step(band_radius: int = 16, match: int = 1,
                     mismatch: int = 4, gap_open: int = 6,
                     gap_extend: int = 1, bonus: int = 5,
                     max_fragment_length: int = 2000,
                     unpaired_penalty: float = 30.0,
                     max_mapq: int = 60, n_buckets: int = 1024,
                     score_fn=None, text_packed: bool = False,
                     text_len: Optional[int] = None):
    """The full paired mapping step: seed-result candidate tables in ->
    per-mate DP scores, pair selection with the fragment model, pair/solo
    MAPQs, pack-style coverage histogram, and the fragment-length
    statistics out. Everything except host seeding and GAM emission runs
    on the device of its inputs."""
    from ..map.giraffe import PLACEMENT_TOL
    from ..map.mapq import log_base

    lam = log_base(match, mismatch)
    if score_fn is None:
        score_fn = _default_score_fn(band_radius, match, mismatch, gap_open,
                                     gap_extend, bonus)

    def step(text, r1, r1rc, rl1, c1, r2, r2rc, rl2, c2, mu, sd):
        (s1_start, s1_lo, s1_hi, s1_rev, s1_valid, s1_rp, s1_ro) = c1
        (s2_start, s2_lo, s2_hi, s2_rev, s2_valid, s2_rp, s2_ro) = c2
        s1 = score_fn(text, r1, r1rc, rl1, c1)
        s2 = score_fn(text, r2, r2rc, rl2, c2)
        B = band_radius
        dev = s1.device
        mu = torch.as_tensor(mu, dtype=F32, device=dev)
        sd = torch.as_tensor(sd, dtype=F32, device=dev)

        f1T = s1.T.to(F32)
        f2T = s2.T.to(F32)
        v1T = (s1_valid & (s1 > 0)).T
        v2T = (s2_valid & (s2 > 0)).T
        vd1T = v1T & _distinct_mask_T(s1.T, s1_rev.T, s1_rp.T, s1_ro.T,
                                      v1T, PLACEMENT_TOL)
        vd2T = v2T & _distinct_mask_T(s2.T, s2_rev.T, s2_rp.T, s2_ro.T,
                                      v2T, PLACEMENT_TOL)

        L1r = rl1.to(F32)[None, None, :]
        L2r = rl2.to(F32)[None, None, :]
        d1T = (s1_start + B).to(F32).T
        d2T = (s2_start + B).to(F32).T
        rev1T = s1_rev.T
        rev2T = s2_rev.T
        ffT = (d2T[None, :, :] + L2r) - d1T[:, None, :]
        frT = (d1T[:, None, :] + L1r) - d2T[None, :, :]
        frag_txtT = torch.where(rev1T[:, None, :], frT, ffT)
        same_copyT = s1_lo.T[:, None, :] == s2_lo.T[None, :, :]
        rp1T = s1_rp.T
        rp2T = s2_rp.T
        on_refT = (rp1T[:, None, :] >= 0) & (rp1T[:, None, :]
                                             == rp2T[None, :, :])
        ro1T = s1_ro.to(F32).T
        ro2T = s2_ro.to(F32).T
        rffT = (ro2T[None, :, :] + L2r) - ro1T[:, None, :]
        rfrT = (ro1T[:, None, :] + L1r) - ro2T[None, :, :]
        frag_refT = torch.where(rev1T[:, None, :], rfrT, rffT)
        fragT = torch.where(same_copyT, frag_txtT,
                            torch.where(on_refT, frag_refT,
                                        _f32(-1.0, dev)))
        properT = ((rev1T[:, None, :] != rev2T[None, :, :])
                   & (same_copyT | on_refT)
                   & (fragT > 0) & (fragT <= max_fragment_length)
                   & vd1T[:, None, :] & vd2T[None, :, :])
        (j1, j2, mq1, mq2, use_pair, frags, stats) = _pair_core_T(
            f1T, f2T, vd1T, vd2T, fragT, properT, rl1, rl2, mu, sd,
            lam, unpaired_penalty, max_mapq, max_fragment_length)

        mm1, bits1 = winner_mismatch_bits(
            text, text_len, text_packed, B, r1, r1rc, rl1,
            s1_start, s1_lo, s1_hi, s1_rev, j1)
        mm2, bits2 = winner_mismatch_bits(
            text, text_len, text_packed, B, r2, r2rc, rl2,
            s2_start, s2_lo, s2_hi, s2_rev, j2)

        # pack-style coverage histogram over winner placements
        start1 = _take(s1_start, j1)
        start2 = _take(s2_start, j2)
        bsz = max((text_len if text_len is not None
                   else text.shape[0]) // n_buckets, 1)
        cov = torch.zeros(n_buckets, dtype=torch.int32, device=dev)
        for st, vd in ((start1, vd1T), (start2, vd2T)):
            bucket = torch.div(st, bsz, rounding_mode="floor").clamp(
                0, n_buckets - 1).to(torch.int64)
            cov.index_add_(0, bucket, vd.any(dim=0).to(torch.int32))
        return (s1, s2, j1, j2,
                mq1.clamp(0, max_mapq).to(torch.int32),
                mq2.clamp(0, max_mapq).to(torch.int32),
                use_pair, frags, mm1, mm2, bits1, bits2, stats, cov)

    return step
