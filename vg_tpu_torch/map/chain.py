"""Anchor chaining DP for long reads.

Reference: algorithms/chain_items.{hpp,cpp} — the chaining engine behind
giraffe's hifi/r10 presets (chain_items_dp, find_best_chains,
src/algorithms/chain_items.hpp:581-616), with transition costs from read
gap vs graph min-distance. On the haplotype text the "graph distance"
between anchors is plain subtraction, so the DP is exactly colinear
chaining: f[i] = score[i] + max_j (f[j] - gap_cost(j, i)) over a bounded
predecessor window (vg bounds lookback at 20000bp; we additionally bound
the candidate count, the standard sparse-chaining trick).

Vectorized: anchors sorted by text position; each anchor considers the
previous `lookback_cands` anchors as a (n, J) numpy block.

Copied from vg_tpu/map/chain.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class ChainParams:
    kmer: int = 29
    max_lookback: int = 20000       # reference: chaining lookback (hifi)
    lookback_cands: int = 64
    max_indel: int = 5000           # reference: max-indel cap
    gap_scale: float = 0.1          # per-base gap cost (hifi ~0.105)
    gap_open: float = 1.0
    min_chain_score: float = 40.0
    max_chains: int = 4             # chains kept per read (mapq evidence)


@dataclass
class Chain:
    anchors: np.ndarray      # indices into the anchor arrays, chain order
    score: float
    read_start: int
    read_end: int
    text_start: int
    text_end: int
    is_rev: bool
    roff: Optional[np.ndarray] = None   # anchor read offsets, chain order
    tpos: Optional[np.ndarray] = None   # anchor text positions, chain order


def chain_anchors(roff: np.ndarray, tpos: np.ndarray,
                  ascore: np.ndarray, params: ChainParams
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Forward DP. Returns (f, parent) for anchors sorted by (tpos, roff).
    Caller must pass arrays already sorted."""
    n = len(roff)
    J = min(params.lookback_cands, max(n - 1, 1))
    f = ascore.astype(np.float64).copy()
    parent = np.full(n, -1, dtype=np.int64)
    if n <= 1:
        return f, parent
    from ..native import native_chain_anchors

    res = native_chain_anchors(roff, tpos, ascore, J, params.kmer,
                               params.max_lookback, params.max_indel,
                               params.gap_scale, params.gap_open)
    if res is not None:
        return res
    k = params.kmer
    for i in range(1, n):
        j0 = max(0, i - J)
        js = np.arange(j0, i)
        dt = tpos[i] - tpos[js]
        dr = roff[i] - roff[js]
        ok = (dr > 0) & (dt > 0) & (dt <= params.max_lookback) & \
             (np.abs(dt - dr) <= params.max_indel)
        if not ok.any():
            continue
        gap = np.abs(dt - dr)
        # gain: new matched bases (capped at k), minus affine gap cost
        gain = np.minimum(np.minimum(dr, dt), k).astype(np.float64)
        cost = np.where(gap > 0, params.gap_open + params.gap_scale * gap, 0.0)
        cand = f[js] + gain - cost
        cand = np.where(ok, cand, -np.inf)
        best = int(np.argmax(cand))
        if cand[best] > f[i]:
            f[i] = float(cand[best])
            parent[i] = js[best]
    return f, parent


def backtrack_chains(f: np.ndarray, parent: np.ndarray,
                     params: ChainParams) -> List[np.ndarray]:
    """Greedy non-overlapping chain extraction by descending score."""
    n = len(f)
    used = np.zeros(n, dtype=bool)
    order = np.argsort(-f)
    chains: List[np.ndarray] = []
    for tip in order:
        if len(chains) >= params.max_chains:
            break
        if used[tip] or f[tip] < params.min_chain_score:
            continue
        walk = []
        i = int(tip)
        clean = True
        while i >= 0:
            if used[i]:
                clean = False
                break
            walk.append(i)
            i = int(parent[i])
        if not clean or not walk:
            continue
        walk.reverse()
        for i in walk:
            used[i] = True
        chains.append(np.array(walk, dtype=np.int64))
    return chains


def find_chains(roff: np.ndarray, tpos: np.ndarray, ascore: np.ndarray,
                is_rev: bool, params: ChainParams) -> List[Chain]:
    """Sort anchors, run the DP, extract chains with their intervals."""
    if len(roff) == 0:
        return []
    order = np.lexsort((roff, tpos))
    roff_s, tpos_s, ascore_s = roff[order], tpos[order], ascore[order]
    f, parent = chain_anchors(roff_s, tpos_s, ascore_s, params)
    out: List[Chain] = []
    for walk in backtrack_chains(f, parent, params):
        idx = order[walk]
        out.append(Chain(
            anchors=walk, score=float(f[walk[-1]]),
            read_start=int(roff_s[walk[0]]),
            read_end=int(roff_s[walk[-1]]) + params.kmer,
            text_start=int(tpos_s[walk[0]]),
            text_end=int(tpos_s[walk[-1]]) + params.kmer,
            is_rev=is_rev))
        # store sorted-coordinate views for the stitcher
        out[-1].roff = roff_s[walk]
        out[-1].tpos = tpos_s[walk]
    return out
