"""The explored-minimizer MAPQ cap, plain, and the index's key set.

A frozen copy of giraffe's faster_cap as the port's host copy has it
(vg_tpu_torch/map/mapqcap.py: minimizer_agglomerations, faster_cap,
explored_cap; reference src/minimizer_mapper.cpp:2940-3080) with the
minimizer hashing it rests on (index/minimizer.py: _rolling_kmers,
wang_hash_64). One change: the probabilities are carried in `ftype`,
float64 as the configuration states, or float32 for the control.

The cap keeps the minimizers the index holds. The key set is worked out
again from the haplotype texts: every (k, w) minimizer of each haplotype
(canonical kmers, Wang's hash, all ties of a window kept, kmers over N
left out), as the port's MinimizerIndex.build selects them.
"""
from __future__ import annotations

from typing import List

import numpy as np

_U64_MAX = float(2.0 ** 64)


def wang_hash_64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (~x) + (x << np.uint64(21))
        x = x ^ (x >> np.uint64(24))
        x = (x + (x << np.uint64(3))) + (x << np.uint64(8))
        x = x ^ (x >> np.uint64(14))
        x = (x + (x << np.uint64(2))) + (x << np.uint64(4))
        x = x ^ (x >> np.uint64(28))
        x = x + (x << np.uint64(31))
    return x


def rolling_kmers(codes: np.ndarray, k: int):
    n = len(codes)
    if n < k:
        z = np.zeros(0, np.uint64)
        return z, z, np.zeros(0, bool)
    valid_base = codes < 4
    c2 = np.where(valid_base, codes, 0).astype(np.uint64)
    m = n - k + 1
    fwd = np.zeros(m, np.uint64)
    rev = np.zeros(m, np.uint64)
    three = np.uint64(3)
    for j in range(k):
        sl = c2[j : j + m]
        fwd |= sl << np.uint64(2 * (k - 1 - j))
        rev |= (three - sl) << np.uint64(2 * j)
    cs = np.zeros(n + 1, np.int64)
    np.cumsum(~valid_base, out=cs[1:])
    valid = (cs[k:] - cs[:-k]) == 0
    return fwd, rev, valid


def minimizer_keys(codes: np.ndarray, k: int, w: int,
                   whole_windows: bool = False) -> np.ndarray:
    """Canonical keys of every (k, w) minimizer of one text, ties kept.
    With `whole_windows`, only windows whose kmers are all valid count."""
    fwd, rev, valid = doubling_kmers(codes, k)
    if len(fwd) == 0:
        return np.zeros(0, np.uint64)
    keys = np.where(rev < fwd, rev, fwd)
    hashes = np.where(valid, wang_hash_64(keys),
                      np.uint64(0xFFFFFFFFFFFFFFFF))
    m = len(hashes)
    w_eff = min(w, m)
    nw = m - w_eff + 1
    mins = hashes[:nw].copy()
    for j in range(1, w_eff):
        np.minimum(mins, hashes[j : j + nw], out=mins)
    if whole_windows:
        cs = np.zeros(m + 1, np.int64)
        np.cumsum(~valid, out=cs[1:])
        whole = (cs[w_eff:] - cs[:-w_eff]) == 0
        mins = np.where(whole, mins, np.uint64(0xFFFFFFFFFFFFFFFF))
    chosen = np.zeros(m, bool)
    for j in range(w_eff):
        chosen[j : j + nw] |= hashes[j : j + nw] == mins
    chosen &= valid
    return np.unique(keys[chosen])


def index_keys(texts: List[np.ndarray], k: int, w: int) -> np.ndarray:
    """The sorted key set of an index over these haplotype texts."""
    return np.unique(np.concatenate([minimizer_keys(t, k, w)
                                     for t in texts]))


def haplotype_keys(haps, k: int, w: int) -> np.ndarray:
    """index_keys(haps.texts, k, w), with the work of one text and the
    variants' neighbourhoods rather than of every haplotype.

    A window of a haplotype (w kmers, w + k - 1 bases) that holds no base
    of an applied alt allele is a window of the reference, and a
    minimizer is a function of its window alone. So the key set is the
    reference text's keys and those of every window that holds an alt
    base: each such window lies inside its allele widened by w + k - 2
    bases a side. Those stretches, merged, are laid end to end with an N
    between them, and only windows whose kmers are all valid count."""
    reach = w + k - 2
    keys = [minimizer_keys(haps.texts[0], k, w)]
    for text, spans in zip(haps.texts[1:], haps.alt_spans[1:]):
        if len(spans):
            keys.append(minimizer_keys(_stretches(text, spans, reach), k, w,
                                       whole_windows=True))
    return np.unique(np.concatenate(keys))


def _stretches(text: np.ndarray, spans: np.ndarray, reach: int):
    """The spans widened by `reach` a side, merged, laid end to end with
    one N (code 4) after each."""
    a = np.maximum(spans[:, 0] - reach, 0)
    b = np.minimum(spans[:, 1] + reach, len(text))
    order = np.argsort(a, kind="stable")
    a, b = a[order], np.maximum.accumulate(b[order])
    new = np.ones(len(a), bool)
    new[1:] = a[1:] > b[:-1]
    s = a[new]
    e = b[np.r_[np.nonzero(new)[0][1:] - 1, len(b) - 1]]
    lens = e - s
    seg = np.repeat(np.arange(len(s)), lens)
    within = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens)
    out = np.full(int(lens.sum()) + len(s), 4, np.uint8)
    dst = np.cumsum(lens + 1) - (lens + 1)
    out[dst[seg] + within] = text[s[seg] + within]
    return out


def doubling_kmers(codes: np.ndarray, k: int):
    """rolling_kmers(codes, k) built from kmers of powers of two: a few
    passes over a text instead of k."""
    n = len(codes)
    if n < k:
        z = np.zeros(0, np.uint64)
        return z, z, np.zeros(0, bool)
    valid_base = codes < 4
    c2 = np.where(valid_base, codes, 0).astype(np.uint64)
    m = n - k + 1
    fwd = np.zeros(m, np.uint64)
    rev = np.zeros(m, np.uint64)
    f1, r1, span = c2, np.uint64(3) - c2, 1   # kmers of length `span`
    done = 0                                  # bases of fwd / rev so far
    bit = 0
    while (1 << bit) <= k:
        if k >> bit & 1:
            # append a `span`-mer starting at k - done - span from the
            # right: the kmer's bases done .. done + span - 1
            fwd = (fwd << np.uint64(2 * span)) | f1[done : done + m]
            rev = rev | (r1[done : done + m] << np.uint64(2 * done))
            done += span
        nxt = len(f1) - span
        if (2 << bit) <= k:
            f1 = (f1[:nxt] << np.uint64(2 * span)) | f1[span : span + nxt]
            r1 = r1[:nxt] | (r1[span : span + nxt] << np.uint64(2 * span))
        span *= 2
        bit += 1
    cs = np.zeros(n + 1, np.int64)
    np.cumsum(~valid_base, out=cs[1:])
    valid = (cs[k:] - cs[:-k]) == 0
    return fwd, rev, valid


def agglomerations(codes: np.ndarray, k: int, w: int):
    n = len(codes)
    if n < k:
        z = np.zeros(0, np.int64)
        return z, np.zeros(0, np.uint64), z, z, np.zeros(0, np.uint64)
    fwd, rev, valid = rolling_kmers(codes, k)
    keys = np.where(rev < fwd, rev, fwd)
    hashes = np.where(valid, wang_hash_64(keys),
                      np.uint64(0xFFFFFFFFFFFFFFFF))
    m = len(hashes)
    w_eff = min(w, m)
    nw = m - w_eff + 1
    mins = hashes[:nw].copy()
    for j in range(1, w_eff):
        np.minimum(mins, hashes[j : j + nw], out=mins)
    first_w = np.full(m, 1 << 30, np.int64)
    last_w = np.full(m, -1, np.int64)
    t = np.arange(nw)
    for j in range(w_eff):
        eq = hashes[j : j + nw] == mins
        sel = t[eq] + j
        first_w[sel] = np.minimum(first_w[sel], t[eq])
        last_w[sel] = np.maximum(last_w[sel], t[eq])
    chosen = (last_w >= 0) & valid
    offs = np.nonzero(chosen)[0].astype(np.int64)
    agg_start = first_w[offs]
    agg_len = (last_w[offs] + w_eff - 1 + k) - agg_start
    return offs, hashes[offs], agg_start, agg_len, keys[offs]


def faster_cap(offs, hashes, agg_start, agg_len, k: int, quals: np.ndarray,
               ftype=np.float64) -> float:
    """Phred cap: -10 log10 of the likeliest way base errors disrupt
    every explored minimizer (the sorted interval sweep and its DP)."""
    n = len(offs)
    if n == 0 or quals is None or len(quals) == 0:
        return float("inf")
    one = ftype(1.0)
    mins = [dict(off=int(offs[i]), hash=ftype(float(hashes[i])),
                 agg_start=int(agg_start[i]), agg_len=int(agg_len[i]))
            for i in range(n)]
    mins.sort(key=lambda m: (m["agg_start"] + m["agg_len"], m["agg_start"]))
    u64 = ftype(_U64_MAX)

    def col_prob(idx: int, group) -> float:
        p = ftype(10.0) ** (-ftype(float(quals[idx])) / ftype(10.0))
        for mn in group:
            if mn["off"] <= idx < mn["off"] + k:
                continue
            possible = max(min(k, idx - mn["agg_start"] + 1,
                               mn["agg_start"] + mn["agg_len"] - idx), 0)
            p_beat = min(mn["hash"] / u64, one)
            p = p * (one - (one - p_beat) ** ftype(possible))
        return p

    c = np.full(n + 1, -np.inf, dtype=ftype)
    c[0] = 0.0

    def interval(left: int, right: int, bottom: int, top: int) -> None:
        if left >= right:
            return
        group = mins[bottom:top]
        p = col_prob(left, group)
        for i in range(left + 1, right):
            cp = col_prob(i, group)
            p = p + cp - p * cp
        here = np.log10(p) if p > 0 else ftype(-np.inf)
        val = c[bottom] + here
        for i in range(bottom + 1, top + 1):
            if c[i] < val:
                c[i] = val

    stack = [mins[0]]
    state = {"left": mins[0]["agg_start"], "bottom": 0}
    read_len = len(quals)

    def emit_preceding(right: int) -> None:
        while state["left"] < right:
            top_end = stack[0]["agg_start"] + stack[0]["agg_len"]
            b = state["bottom"]
            if top_end <= right:
                interval(state["left"], top_end, b, b + len(stack))
                state["left"] = right if len(stack) == 1 else top_end
                state["bottom"] = b + 1
                stack.pop(0)
            else:
                interval(state["left"], right, b, b + len(stack))
                state["left"] = right

    for mn in mins[1:]:
        emit_preceding(mn["agg_start"])
        stack.append(mn)
    emit_preceding(read_len)
    return float(-10.0 * c[-1]) if np.isfinite(c[-1]) else float("inf")


def explored_cap(codes: np.ndarray, quals: np.ndarray, keys: np.ndarray,
                 k: int, w: int, ftype=np.float64) -> float:
    """The cap of one read: its minimizers that the index holds (`keys`,
    sorted), their agglomerations, faster_cap. NaN where the sweep runs
    past the qualities (the copy's IndexError)."""
    offs, hashes, a_start, a_len, kk = agglomerations(codes, k, w)
    if len(kk):
        i = np.minimum(np.searchsorted(keys, kk), len(keys) - 1)
        keep = keys[i] == kk
        offs, hashes = offs[keep], hashes[keep]
        a_start, a_len = a_start[keep], a_len[keep]
    try:
        return faster_cap(offs, hashes, a_start, a_len, k,
                          np.minimum(quals, 93), ftype)
    except IndexError:
        return float("nan")


def round_half_even(x: float) -> float:
    """The port's rounding of a finite cap (torch.round, at least 0)."""
    return max(float(np.round(x)), 0.0)
