"""Inputs that drive the banded-DP kernel (ops/cuda_align.py) into the
edge cases of its valid-slot compaction, made with numpy from a seed.
tests/test_torch_kernel.py, tests/test_torch_align.py and chip_smoke.py
hold the kernel's three entries against their plain versions on them.

The kernel gives each block a fixed range of slots, a multiple of
BLOCK_SLOTS (read-major: slot n is read n // C, candidate n % C), and runs
only the valid ones, two a thread where the scoring allows; so the cases
set the valid flags BLOCK_SLOTS slots at a time: every slot valid, none,
one, every other one, and a random half.
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
    r = np.where(strand[:, None], COMP[r.astype(np.uint8)][:, ::-1], r)
    col = np.arange(RL)[None, :]
    reads = np.full((R, RL), 5, np.uint8)
    reads[:, :L] = r
    reads[col >= rlen[:, None]] = 5
    idx = np.clip(rlen[:, None] - 1 - col, 0, RL - 1)
    reads_rc = np.where(col < rlen[:, None],
                        COMP[np.take_along_axis(reads, idx, 1)],
                        5).astype(np.uint8)
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
