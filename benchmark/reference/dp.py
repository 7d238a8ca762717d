"""The banded DP, plain: each slot's best local score of its read in the
band around its candidate diagonal, with giraffe's full-length bonuses.

Row i of the read meets text columns start + i + j, j = 0 .. 2B (the
band); text outside its haplotype is a base nothing matches. Local
affine scoring (Gotoh): a gap of length n costs open + (n - 1) * extend,
no cell falls below 0, an alignment that starts at the read's first base
adds the bonus, and one that ends at its last base adds it again.

    E[i][j] = max(H[i][j-1] - open, E[i][j-1] - extend)   text base skipped
    F[i][j] = max(H[i-1][j+1] - open, F[i-1][j+1] - extend)  read base skipped
    H[i][j] = max(0, H[i-1][j] + s(read[i], text[start+i+j]), E[i][j], F[i][j])

with H[-1][*] = bonus. Written from the recurrence, vectorised over
slots; imports nothing of the program.
"""
from __future__ import annotations

import numpy as np

NEG = -(1 << 28)


def banded_best(windows: np.ndarray, reads: np.ndarray, rlen: np.ndarray,
                band: int, match: int = 1, mismatch: int = 4,
                gap_open: int = 6, gap_extend: int = 1,
                bonus: int = 5) -> np.ndarray:
    """windows (N, RL + 2B) text codes (>= 4 matches nothing), reads
    (N, RL) oriented codes, rlen (N,). Returns (N,) int64 best scores."""
    N, RL = reads.shape
    W = 2 * band + 1
    windows = windows.astype(np.int64)
    reads = reads.astype(np.int64)
    H = np.full((N, W), bonus, np.int64)
    F = np.full((N, W), NEG, np.int64)
    best = np.zeros(N, np.int64)
    for i in range(RL):
        active = i < rlen
        if not active.any():
            break
        r = reads[:, i : i + 1]
        same = (windows[:, i : i + W] == r) & (r < 4)
        diag = H + np.where(same, match, -mismatch)
        Hn = np.empty_like(H)
        Fn = np.empty_like(F)
        Fn[:, : W - 1] = np.maximum(H[:, 1:] - gap_open,
                                    F[:, 1:] - gap_extend)
        Fn[:, W - 1] = NEG
        E = np.full(N, NEG, np.int64)
        for j in range(W):
            if j:
                E = np.maximum(Hn[:, j - 1] - gap_open, E - gap_extend)
            Hn[:, j] = np.maximum(np.maximum(diag[:, j], Fn[:, j]),
                                  np.maximum(E, 0))
        H = np.where(active[:, None], Hn, H)
        F = np.where(active[:, None], Fn, F)
        row = Hn.max(axis=1)
        best = np.where(active, np.maximum(best, row), best)
        last = i + 1 == rlen
        best = np.where(last, np.maximum(best, row + bonus), best)
    return best
