"""Graph minimum-distance queries.

Reference: SnarlDistanceIndex (src/snarl_distance_index.cpp, bdsg) answers
min-distance between any two graph positions from a precomputed snarl-tree
oracle; giraffe consumes it through zipcodes. vg_tpu's mapping pipeline
replaced those queries with haplotype-text arithmetic, but the general
oracle is still part of the surface (vg gamcompare -d, distance debugging
tools). This is a bounded Dijkstra over handle space — exact within
`limit`, the standard fallback the reference's own tests validate the
index against (unittest snarl_distance_index fuzzers use brute-force
search the same way).

Copied from vg_tpu/graph/distance.py.
"""
from __future__ import annotations

import heapq
from typing import Optional, Tuple

from .arraygraph import ArrayGraph

Position = Tuple[int, int, bool]   # (node_id, offset, is_reverse)


def min_distance(g: ArrayGraph, a: Position, b: Position,
                 limit: int = 1 << 30) -> Optional[int]:
    """Minimum number of bases between position a and position b walking
    forward from a (oriented), or None if unreachable within limit.

    Matches the reference's minimum_distance semantics: distance from the
    base *at* a to the base at b, 0 if identical."""
    a_id, a_off, a_rev = a
    b_id, b_off, b_rev = b
    if not (g.has_node(a_id) and g.has_node(b_id)):
        return None
    ha = g.handle(a_id, a_rev)
    hb = g.handle(b_id, b_rev)
    la = g.node_len(a_id)
    if ha == hb and b_off >= a_off:
        return b_off - a_off
    # distance from a to the end of its handle
    first_hop = la - a_off
    # Dijkstra over handles: dist[h] = bases from position a to the start
    # of handle h
    dist = {ha: None}
    pq = [(first_hop, int(c)) for c in g.follow(ha)]
    heapq.heapify(pq)
    best = {}
    while pq:
        d, h = heapq.heappop(pq)
        if d > limit:
            break
        if h in best and best[h] <= d:
            continue
        best[h] = d
        if h == hb:
            return d + b_off
        nlen = g.handle_len(h)
        for c in g.follow(h):
            c = int(c)
            nd = d + nlen
            if nd <= limit and (c not in best or best[c] > nd):
                heapq.heappush(pq, (nd, c))
    return None


def positions_within(g: ArrayGraph, a: Position, limit: int):
    """All (node_id, is_reverse, distance-to-node-start) reachable within
    limit bases (rescue-window extraction helper, reference
    extract_connecting/containing_graph roles)."""
    a_id, a_off, a_rev = a
    ha = g.handle(a_id, a_rev)
    first_hop = g.node_len(a_id) - a_off
    out = {}
    pq = [(first_hop, int(c)) for c in g.follow(ha)]
    heapq.heapify(pq)
    while pq:
        d, h = heapq.heappop(pq)
        if d > limit or (h in out and out[h] <= d):
            continue
        out[h] = d
        nlen = g.handle_len(h)
        for c in g.follow(h):
            if d + nlen <= limit:
                heapq.heappush(pq, (d + nlen, int(c)))
    return [(int(g.node_id[h >> 1]), bool(h & 1), d) for h, d in out.items()]
