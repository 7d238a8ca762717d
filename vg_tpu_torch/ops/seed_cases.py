"""Inputs that drive the seeding kernels (ops/cuda_seed.py) into their
edge cases, made with numpy from a seed. tests/test_torch_seed_kernel.py
and chip_smoke.py hold each kernel against its plain version on them.

Scores are quantized to 1/256 (index/minimizer.minimizer_score_table), as
on the path, except in cluster_float_case. The kernels add scores in the
order their plain versions do, so every comparison is exact either way.
"""
from __future__ import annotations

import numpy as np

from ..index.minimizer import minimizer_score_table
from .cuda_seed import CLUSTER_WARP_T, I32MAX

ARGSORT_SIZES = (1, 200, 257, 2049, 4096, 6144, 8192, 16384)
# valid seeds a row holds in cluster_count_case: the warp's lane count and
# the warp path's limit T, each side of them, and a full row
CLUSTER_COUNTS = (1, 31, 32, 33, CLUSTER_WARP_T - 1, CLUSTER_WARP_T,
                  CLUSTER_WARP_T + 1, 4096)
QUANTIZED = np.array([1.0, 1.5, 2.25, 4.0, 3.125])
# minimizer columns of softcap_case rows: every mpad (128 to 1024) and both
# sides of each power of two
SOFTCAP_WIDTHS = (1, 127, 128, 129, 132, 256, 257, 1000, 1024)
# kept columns a row holds in softcap_kept_case: both sides of one and two
# warp widths
SOFTCAP_KEPT = (31, 32, 33, 63, 64, 65)


def softcap_case(rng, R: int, m: int = 132, hard_hit_cap: int = 500,
                 hit_cap: int = 10):
    """(mscore, keep, cheap, hs, cnt, cr) of shape (R, m): random hit
    counts, and rows with nothing kept, all cheap, none cheap, one score
    tied across the row, ties between pairs of columns, and a lone kept
    minimizer."""
    tab = minimizer_score_table(hard_hit_cap, hard_hit_cap)
    cnt = rng.integers(0, 40, (R, m))
    cnt[0::7] = 0                                   # nothing kept
    cnt[1::7] = rng.integers(1, hit_cap + 1, (len(cnt[1::7]), m))
    cnt[2::7] = rng.integers(hit_cap + 1, 31, (len(cnt[2::7]), m))
    cnt[3::7] = 17                                  # one tied score
    cnt[4::7, 1::2] = cnt[4::7, 0::2][:, : m // 2]  # tied neighbours
    cnt[5::7] = 0
    cnt[5::7, m // 2] = 12                          # one kept minimizer
    keep = (cnt > 0) & (cnt <= 30)
    ms = np.where(keep, tab[np.minimum(cnt, hard_hit_cap)], 0).astype(
        np.float32)
    cheap = keep & (cnt <= hit_cap)
    hs = rng.integers(0, 1 << 20, (R, m)).astype(np.int32)
    cr = rng.integers(0, 2, (R, m)).astype(np.int32)
    return ms, keep, cheap, hs, cnt.astype(np.int32), cr


def _softcap_extras(rng, keep, ms):
    """cheap, hs, cnt, cr for kept columns `keep` with scores `ms`."""
    R, m = ms.shape
    cheap = keep & (rng.random((R, m)) < 0.4)
    hs = rng.integers(0, 1 << 20, (R, m)).astype(np.int32)
    cnt = np.where(keep, rng.integers(1, 31, (R, m)), 0).astype(np.int32)
    cr = rng.integers(0, 2, (R, m)).astype(np.int32)
    return ms.astype(np.float32), keep, cheap, hs, cnt, cr


def softcap_kept_case(rng, m: int = 132, counts=SOFTCAP_KEPT,
                      copies: int = 2):
    """`copies` rows for each count of `counts`, each row keeping exactly
    that many columns (quantized scores >= 1, random columns, some tied);
    every other column scores 0, as on the path."""
    ks = np.repeat([k for k in counts if k <= m], copies)
    R = len(ks)
    keep = np.zeros((R, m), bool)
    for r, k in enumerate(ks):
        keep[r, rng.choice(m, size=int(k), replace=False)] = True
    ms = np.where(keep, rng.choice(QUANTIZED, (R, m)), 0.0)
    return _softcap_extras(rng, keep, ms)


def softcap_sign_case(rng, R: int, m: int = 132):
    """Scores off the path's pattern: zeros of either sign (kept and not
    kept), negative quantized scores, kept or not, next to positive ones;
    every third row has no positive score."""
    ms = rng.choice(np.concatenate([QUANTIZED, -QUANTIZED, [0.0, -0.0]]),
                    (R, m))
    ms[2::3] = -np.abs(ms[2::3])
    ms[rng.random((R, m)) < 0.2] = -0.0
    keep = rng.random((R, m)) < 0.6
    return _softcap_extras(rng, keep, ms)


def softcap_budget_case(rng, R: int, m: int = 132):
    """Rows whose exclusive score sum equals the budget exactly, at an
    expensive column, with score_fraction 0.5: kept scores X (>= 2.25, a
    few cheap) and four copies of X / 4 (<= 1, expensive), so the total
    is 2 sum(X) and the first X / 4 column sees sum(X) before it. The
    strict < must not take it. Use score_fraction=0.5."""
    ms = np.zeros((R, m))
    keep = np.zeros((R, m), bool)
    cheap = np.zeros((R, m), bool)
    for r in range(R):
        k = int(rng.integers(1, max(2, min(m // 5, 12)) + 1))
        if 5 * k > m:
            k = max(m // 5, 0)
        x = rng.choice(QUANTIZED[QUANTIZED >= 2.25], k)
        cols = rng.choice(m, size=5 * k, replace=False)
        ms[r, cols[:k]] = x
        ms[r, cols[k:]] = np.repeat(x / 4, 4)
        keep[r, cols] = True
        cheap[r, cols[:k]] = rng.random(k) < 0.3
    out = list(_softcap_extras(rng, keep, ms))
    out[2] = cheap
    return tuple(out)


def cluster_case(rng, R: int, S: int, B: int = 16):
    """(strandk, diagk, ok, score) of shape (R, S): seeds around a few
    diagonal hotspots with duplicate read offsets, and rows that are empty,
    hold one seed, chain diagonals at gaps of exactly 2B and 2B + 1, sit
    at the int32 ends of the diagonal range, tie cluster totals, or fill
    every slot."""
    valid = rng.random((R, S)) < 0.3
    strand = rng.integers(0, 2, (R, S))
    hot = rng.integers(0, 1 << 24, (R, 6))
    diag = hot[np.arange(R)[:, None], rng.integers(0, 6, (R, S))] \
        + rng.integers(-B, B + 1, (R, S))
    off = rng.integers(0, 120, (R, S))
    score = rng.choice(QUANTIZED, (R, S))
    for r in range(R):
        kind = r % 8
        if kind == 0:                               # empty row
            valid[r] = False
        elif kind == 1:                             # one seed
            valid[r] = False
            valid[r, rng.integers(0, S)] = True
        elif kind == 2:                             # gaps 2B and 2B + 1
            n = min(S, 40)
            valid[r] = False
            valid[r, :n] = True
            strand[r, :n] = 0
            steps = np.where(np.arange(n) % 3 == 0, 2 * B + 1, 2 * B)
            diag[r, :n] = 1000 + np.cumsum(steps)
        elif kind == 3:                             # int32 ends
            ends = np.array([-2**31, -2**31 + 5, 2**31 - 40, 2**31 - 2])
            diag[r] = ends[rng.integers(0, 4, S)] + rng.integers(0, 3, S)
        elif kind == 4:                             # tied cluster totals
            valid[r] = False
            n = min(S, 24)
            valid[r, :n] = True
            strand[r, :n] = np.arange(n) % 2
            diag[r, :n] = 5000 * (np.arange(n) // 2)
            off[r, :n] = np.arange(n)
            score[r, :n] = 2.0
        elif kind == 5:                             # every slot valid
            valid[r] = True
    return _cluster_arrays(valid, strand, diag, off, score)


def _cluster_arrays(valid, strand, diag, off, score):
    """(strandk, diagk, ok, score) as the path lays them out: strand 2,
    I32MAX and 0.0 in the invalid slots."""
    strandk = np.where(valid, strand, 2).astype(np.int32)
    diagk = np.where(valid, np.clip(diag, -2**31, 2**31 - 1),
                     I32MAX).astype(np.int32)
    ok = np.where(valid, off, I32MAX).astype(np.int32)
    return strandk, diagk, ok, np.where(valid, score, 0.0).astype(np.float32)


def cluster_count_case(rng, S: int, B: int = 16, counts=CLUSTER_COUNTS,
                       copies: int = 2):
    """`copies` rows for each count of `counts` up to S, each row holding
    exactly that many valid seeds in random slots, around a few diagonal
    hotspots with duplicate read offsets and quantized scores."""
    ks = np.repeat([k for k in counts if k <= S], copies)
    R = len(ks)
    strand = rng.integers(0, 2, (R, S))
    hot = rng.integers(0, 1 << 24, (R, 6))
    diag = hot[np.arange(R)[:, None], rng.integers(0, 6, (R, S))] \
        + rng.integers(-B, B + 1, (R, S))
    off = rng.integers(0, 120, (R, S))
    score = rng.choice(QUANTIZED, (R, S))
    valid = np.zeros((R, S), bool)
    for r, k in enumerate(ks):
        valid[r, rng.choice(S, size=int(k), replace=False)] = True
    return _cluster_arrays(valid, strand, diag, off, score)


def cluster_float_case(rng, R: int, S: int, B: int = 16):
    """Scores drawn as arbitrary float32. Each row holds six pairs of
    clusters; the two clusters of a pair carry the same scores at permuted
    read offsets (so a different order in the score scan), and their
    totals differ, or tie, by rounding alone. Some clusters repeat a read
    offset with another score. Every fourth row also carries filler seeds
    that take it past CLUSTER_WARP_T, where S allows."""
    valid = np.zeros((R, S), bool)
    strand = np.zeros((R, S), np.int64)
    diag = np.zeros((R, S), np.int64)
    off = np.zeros((R, S), np.int64)
    score = np.zeros((R, S), np.float32)
    for r in range(R):
        slots = rng.permutation(S)
        used = 0

        def put(k, st, dg, of, sc):
            nonlocal used
            at = slots[used : used + k]
            used += k
            valid[r, at] = True
            strand[r, at], diag[r, at], off[r, at], score[r, at] = \
                st, dg, of, sc

        for q in range(6):
            k = int(rng.integers(2, 13))
            sc = (rng.random(k) * 4 + 0.01).astype(np.float32)
            for half, order in enumerate((np.arange(k), rng.permutation(k))):
                if used + k + 1 > S:
                    break
                d0 = 1000 + (2 * q + half) * 50 * B
                st = int(rng.integers(0, 2))
                put(k, st, d0 + rng.integers(0, 2 * B + 1, k), order, sc)
                if rng.random() < 0.3:             # a repeated offset
                    put(1, st, d0 + int(rng.integers(0, 2 * B + 1)),
                        int(order[0]), np.float32(rng.random() * 4 + 0.01))
        fill = CLUSTER_WARP_T + 1 + int(rng.integers(0, 40)) - used
        if r % 4 == 3 and used + fill <= S:
            put(fill, rng.integers(0, 2, fill),
                rng.integers(-(1 << 20), 1 << 20, fill),
                rng.integers(0, 120, fill),
                (rng.random(fill) * 4 + 0.01).astype(np.float32))
    return _cluster_arrays(valid, strand, diag, off, score)


def argsort_case(rng, n: int) -> np.ndarray:
    """n int32 keys, a third of them I32MAX and the rest drawn from a small
    range, so most keys tie."""
    keys = rng.integers(-50, 50, n).astype(np.int32)
    keys[rng.random(n) < 1 / 3] = I32MAX
    return keys
