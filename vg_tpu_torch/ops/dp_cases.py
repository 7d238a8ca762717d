"""Inputs that drive the banded-DP kernel (ops/cuda_align.py) into the
edge cases of its valid-slot compaction, made with numpy from a seed.
tests/test_torch_kernel.py, tests/test_torch_align.py and chip_smoke.py
hold the kernel's three entries against their plain versions on them.

The kernel gives each block a fixed range of slots, a multiple of
BLOCK_SLOTS (read-major: slot n is read n // C, candidate n % C), and runs
only the valid ones, two a thread where the scoring allows; so the cases
set the valid flags BLOCK_SLOTS slots at a time: every slot valid, none,
one, every other one, and a random half.

`qual_case` adds per-base qualities for the quality entry
(banded_scores_qual_packed): phred 0-2 (the tables' zeros), 3-60, 61-93
(past the tables' end), and quality strings shorter than the read;
`signed_tables` gives tables whose mismatch scores take either sign.
`split_case` names the cases of the quality entry's split route (a
group of lanes a slot, each lane a run of band columns): row counts
mixed within one warp, insertions and deletions that cross lane edges,
signed tables, and phred past the end of short tables.
"""
from __future__ import annotations

import numpy as np

BLOCK_SLOTS = 128          # the kernels' block ranges are multiples of this
COMP = np.array([3, 2, 1, 0, 4, 5], np.uint8)
VALID_PATTERNS = ("all", "none", "one", "alternate", "half")


def block_valid(rng, R: int, C: int) -> np.ndarray:
    """(R, C) valid flags, VALID_PATTERNS in turn over the blocks of
    BLOCK_SLOTS slots (the last block may be partial)."""
    N = R * C
    valid = np.zeros(N, bool)
    for b, s0 in enumerate(range(0, N, BLOCK_SLOTS)):
        n = min(BLOCK_SLOTS, N - s0)
        kind = VALID_PATTERNS[b % len(VALID_PATTERNS)]
        if kind == "all":
            valid[s0 : s0 + n] = True
        elif kind == "one":
            valid[s0 + int(rng.integers(0, n))] = True
        elif kind == "alternate":
            valid[s0 + (b // len(VALID_PATTERNS)) % 2 : s0 + n : 2] = True
        elif kind == "half":
            valid[s0 : s0 + n] = rng.random(n) < 0.5
    return valid.reshape(R, C)


def _orient(r, rlen, strand, RL: int):
    """(reads, reads_rc) of the cases from oriented reads r (R, L):
    reverse-strand reads stored reverse-complemented, code 5 past rlen,
    reads_rc the reverse complements of the first rlen codes (columns past
    RL - 1 clipped to it)."""
    R, L = r.shape
    r = np.where(strand[:, None], COMP[r.astype(np.uint8)][:, ::-1], r)
    col = np.arange(RL)[None, :]
    reads = np.full((R, RL), 5, np.uint8)
    reads[:, :L] = r
    reads[col >= rlen[:, None]] = 5
    idx = np.clip(rlen[:, None] - 1 - col, 0, RL - 1)
    reads_rc = np.where(col < rlen[:, None],
                        COMP[np.take_along_axis(reads, idx, 1)],
                        5).astype(np.uint8)
    return reads, reads_rc


def block_case(rng, R: int = 160, C: int = 8, RL: int = 160, B: int = 16,
               T: int = 50_000, L: int = 150, text=None):
    """(text, reads, reads_rc, rlen, start, lo, hi, rev, valid): reads of
    up to L bases drawn from a random text of T bases, or from `text`
    (1% substitutions, 2-base indels, N bases, pad 5 past rlen, some rlen
    0 and some short), candidate 0 at the true window, the others anywhere
    (also below 0 and past the text end), lo / hi cutting some windows,
    and block_valid's flags."""
    if text is None:
        text = rng.integers(0, 4, T).astype(np.uint8)
        text[rng.random(T) < 0.003] = 4
    T = len(text)
    TW = RL + 2 * B
    L = min(L, RL)
    s = rng.integers(0, T - L, R)
    r = text[s[:, None] + np.arange(L)]
    mut = rng.random((R, L)) < 0.01
    r = np.where(mut, (r + 1 + rng.integers(0, 3, (R, L))) % 4, r)
    r[rng.random((R, L)) < 0.002] = 4
    for i in np.flatnonzero(rng.random(R) < 0.3):   # 2-base indels
        q = int(rng.integers(5, L - 5))
        if rng.random() < 0.5:
            tail = np.take(text, s[i] + L + np.arange(2), mode="clip")
            r[i] = np.concatenate([r[i, :q], r[i, q + 2 :], tail])
        else:
            ins = rng.integers(0, 4, 2)
            r[i] = np.concatenate([r[i, :q], ins, r[i, q : L - 2]])
    rlen = np.full(R, L, np.int32)
    short = rng.random(R) < 0.1
    rlen[short] = rng.integers(1, L, int(short.sum()))
    rlen[::23] = 0
    strand = rng.random(R) < 0.5
    reads, reads_rc = _orient(r, rlen, strand, RL)
    start = rng.integers(-TW, T, (R, C)).astype(np.int32)
    start[:, 0] = s - B + rng.integers(-3, 4, R)
    rev = rng.random((R, C)) < 0.5
    rev[:, 0] = strand
    lo = np.zeros((R, C), np.int32)
    hi = np.full((R, C), T, np.int32)
    cut = rng.random(R) < 0.1
    lo[cut, 0] = start[cut, 0] + rng.integers(0, TW // 3, int(cut.sum()))
    hi[cut, 0] = start[cut, 0] + TW - rng.integers(0, TW // 3,
                                                   int(cut.sum()))
    return (text, reads, reads_rc, rlen, start, lo, hi, rev,
            block_valid(rng, R, C))


def windows_of(args, B: int):
    """The windows entry's inputs for a block_case: (N, RL + 2B) windows
    masked to [lo, hi) ∩ [0, T) with sentinel 6, oriented reads, and
    lengths with rlen 0 in every invalid slot (the windows entry's empty
    slot), so its valid slots follow the same block patterns."""
    text, reads, reads_rc, rlen, start, lo, hi, rev, valid = args
    C = start.shape[1]
    TW = reads.shape[1] + 2 * B
    pos = start.reshape(-1).astype(np.int64)[:, None] + np.arange(TW)
    ok = ((pos >= lo.reshape(-1)[:, None]) & (pos < hi.reshape(-1)[:, None])
          & (pos >= 0) & (pos < len(text)))
    win = np.where(ok, text[np.clip(pos, 0, len(text) - 1)],
                   6).astype(np.uint8)
    rd = np.where(rev.reshape(-1)[:, None], np.repeat(reads_rc, C, 0),
                  np.repeat(reads, C, 0)).astype(np.uint8)
    rl = np.where(valid.reshape(-1), np.repeat(rlen, C), 0).astype(np.int32)
    return win, rd, rl


def read_quals(rng, rlen, RL: int) -> np.ndarray:
    """(R, RL) uint8 phred as the mappers build them: each read's quality
    string parsed into columns [0, len) and zeros past it. Qualities are
    drawn from 0-2, 3-60 and 61-93; a fifth of the strings are shorter
    than their read."""
    R = len(rlen)
    kind = rng.random((R, RL))
    q = np.where(kind < 0.1, rng.integers(0, 3, (R, RL)),
                 np.where(kind < 0.85, rng.integers(3, 61, (R, RL)),
                          rng.integers(61, 94, (R, RL))))
    qlen = np.asarray(rlen, np.int64).copy()
    short = rng.random(R) < 0.2
    qlen[short] = rng.integers(0, np.maximum(qlen[short], 1))
    q[np.arange(RL)[None, :] >= qlen[:, None]] = 0
    return q.astype(np.uint8)


def qual_case(rng, R: int = 160, C: int = 8, RL: int = 160, B: int = 16,
              T: int = 50_000, L: int = 150, text=None):
    """block_case's (text, reads, reads_rc, rlen, start, lo, hi, rev,
    valid) with read_quals after reads_rc: (text, reads, reads_rc, quals,
    rlen, ...). Both strands, rlen 0 on valid slots, short reads, N bases
    and windows cut by lo / hi or by the text's ends come from
    block_case."""
    text, reads, reads_rc, rlen, *cand = block_case(rng, R, C, RL, B, T, L,
                                                    text)
    return (text, reads, reads_rc, read_quals(rng, rlen, RL), rlen, *cand)


def signed_tables(rng, nq: int = 61):
    """(match, mismatch, bonus) int32 tables of nq entries: matches 0-3,
    mismatches -6 to +2 (either sign), bonuses 0-7."""
    return (rng.integers(0, 4, nq).astype(np.int32),
            rng.integers(-6, 3, nq).astype(np.int32),
            rng.integers(0, 8, nq).astype(np.int32))


SPLIT_CASES = ("rows", "indel", "signed", "past_end")


def qual_rows_case(rng, R: int = 64, C: int = 8, RL: int = 160, B: int = 16,
                   T: int = 20_000):
    """qual_case's tuple with every slot valid and the row counts a warp
    of groups runs side by side: each run of 8 reads has rlen 0, 1, 2, a
    random rl < RL, RL - 1, RL and RL + 7 (RL rows, no end bonus), and a
    random rl; C candidates a read are C consecutive slots, so one warp's
    groups (4 to 16 slots) mix them."""
    text = rng.integers(0, 4, T).astype(np.uint8)
    s = rng.integers(0, T - RL, R)
    r = text[s[:, None] + np.arange(RL)]
    mut = rng.random((R, RL)) < 0.02
    r = np.where(mut, (r + 1 + rng.integers(0, 3, (R, RL))) % 4, r)
    pattern = np.array([0, 1, 2, -1, RL - 1, RL, RL + 7, -1])
    rlen = pattern[np.arange(R) % len(pattern)]
    rnd = rlen < 0
    rlen[rnd] = rng.integers(3, RL - 1, int(rnd.sum()))
    rlen = rlen.astype(np.int32)
    strand = rng.random(R) < 0.5
    reads, reads_rc = _orient(r, rlen, strand, RL)
    start = (s[:, None] - B + rng.integers(-B, B + 1, (R, C))).astype(
        np.int32)
    rev = np.repeat(strand[:, None], C, 1)
    rev[:, 1::2] = ~rev[:, 1::2]
    lo = np.zeros((R, C), np.int32)
    hi = np.full((R, C), T, np.int32)
    return (text, reads, reads_rc, read_quals(rng, rlen, RL), rlen, start,
            lo, hi, rev, np.ones((R, C), bool))


def qual_indel_case(rng, R: int = 64, C: int = 8, RL: int = 160,
                    B: int = 16, T: int = 20_000, L: int = 150):
    """qual_case's tuple with one insertion or deletion of 1 .. 2B bases in
    the middle of each read, every slot valid, each candidate's window
    started so that the path enters the band at a random column from which
    the indel keeps it inside: the path moves across the band by the
    indel's length, up to the whole band, so it crosses the lane edges of
    every split (deletions through E' and the cross-lane carry, from the
    first lane to the last; insertions through F and the neighbour's
    column)."""
    text = rng.integers(0, 4, T).astype(np.uint8)
    L = min(L, RL)
    s = rng.integers(2 * B, T - L - 4 * B, R)
    r = np.empty((R, L), np.uint8)
    d = rng.integers(1, 2 * B + 1, R)
    for i in range(R):
        q = int(rng.integers(L // 4, 3 * L // 4))
        if i % 2:      # deletion: the read skips d text bases
            src = np.concatenate([np.arange(q), np.arange(q + d[i], L + d[i])])
            r[i] = text[s[i] + src]
        else:          # insertion: d read bases the text lacks
            r[i] = np.concatenate([text[s[i] : s[i] + q],
                                   rng.integers(0, 4, d[i]),
                                   text[s[i] + q : s[i] + L - d[i]]])
    mut = rng.random((R, L)) < 0.01
    r = np.where(mut, (r + 1 + rng.integers(0, 3, (R, L))) % 4, r)
    rlen = np.full(R, L, np.int32)
    strand = rng.random(R) < 0.5
    reads, reads_rc = _orient(r, rlen, strand, RL)
    # the path's band column before the indel: deletions move it up by d,
    # insertions down
    dele = (np.arange(R) % 2 == 1)[:, None]
    u = rng.random((R, C))
    k0 = np.where(dele, np.floor(u * (2 * B - d[:, None] + 1)),
                  d[:, None] + np.floor(u * (2 * B - d[:, None] + 1)))
    start = (s[:, None] - k0).astype(np.int32)
    lo = np.zeros((R, C), np.int32)
    hi = np.full((R, C), T, np.int32)
    return (text, reads, reads_rc, read_quals(rng, rlen, RL), rlen, start,
            lo, hi, np.repeat(strand[:, None], C, 1), np.ones((R, C), bool))


def split_case(name: str, rng, B: int, R: int = 64, RL: int = 160):
    """(qual_case-style tuple, (match, mismatch, bonus) tables) of a
    SPLIT_CASES entry: "rows" (qual_rows_case with signed_tables, whose
    positive mismatches raise the score of rows a slot does not have),
    "indel"
    (qual_indel_case), "signed" (qual_case with signed_tables), "past_end"
    (qual_case with qualadj's tables cut to 8 entries: most phred lie
    past their end)."""
    from .qualadj import qual_tables

    tabs = qual_tables(1, 4, 5)
    if name == "rows":        # positive mismatch scores: a row run past
        return qual_rows_case(rng, R=R, RL=RL, B=B), signed_tables(rng)
    if name == "indel":
        return qual_indel_case(rng, R=R, RL=RL, B=B), tabs
    args = qual_case(rng, R=R, RL=RL, B=B, T=20_000)
    if name == "signed":
        return args, signed_tables(rng)
    if name == "past_end":
        return args, tuple(np.ascontiguousarray(t[:8]) for t in tabs)
    raise ValueError(f"no split case {name!r}; SPLIT_CASES = {SPLIT_CASES}")
