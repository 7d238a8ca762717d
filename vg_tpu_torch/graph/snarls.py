"""Snarl (superbubble) decomposition over the handle graph.

The reference's IntegratedSnarlFinder builds a cactus-graph decomposition
(reference: src/integrated_snarl_finder.cpp, SnarlManager src/snarls.hpp:408)
to find nested snarls in arbitrary bidirected graphs. vg_tpu's first
implementation enumerates snarls as *directed superbubbles in handle
space*: every orientation of every node is a vertex, so inversion edges
are handled naturally; the classic single-entrance/single-exit validation
(Onodera et al.) runs from candidate start handles.

For calling we enumerate snarls whose endpoints lie on a chosen backbone
path (every FASTA+VCF-constructed bubble has its endpoints on the
reference path), yielding the same top-level chain the reference's
call pipeline walks (GraphCaller::call_top_level_snarls,
src/graph_caller.cpp:23-83).

Copied from vg_tpu/graph/snarls.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .arraygraph import ArrayGraph


@dataclass
class Snarl:
    start: int               # handle (traversal enters through this)
    end: int                 # handle (traversal exits through this)
    contents: List[int]      # node indices strictly inside
    parent: Optional[int] = None   # index into the snarl list, or None

    def key(self) -> Tuple[int, int]:
        return (self.start, self.end)


def find_superbubble(graph: ArrayGraph, s: int,
                     max_nodes: int = 1000) -> Optional[Snarl]:
    """Smallest superbubble starting at handle ``s`` (directed, handle
    space, Onodera-style validation); returns None if s doesn't open one.

    A vertex becomes pushable once every parent edge has been visited; the
    bubble closes when exactly one vertex remains unexplained and nothing
    else is in flight."""
    if graph.degree_out(s) == 0:
        return None
    seen: Set[int] = {s}
    visited: Set[int] = set()
    remaining: Dict[int, int] = {}
    pushable: List[int] = [s]
    while pushable:
        v = pushable.pop()
        visited.add(v)
        if len(visited) > max_nodes:
            return None
        children = graph.follow(v)
        if len(children) == 0:
            return None                      # tip inside: not a bubble
        kids = [int(c) for c in children]
        for c in kids:                       # register first: sibling order
            if c == s or (c ^ 1) == s:      # must not fake an early exit
                return None                  # cycle back into the entrance
            if (c ^ 1) in seen:
                return None                  # orientation clash: needs cactus
            if c not in seen:
                seen.add(c)
                remaining[c] = len(graph.predecessors(c))
        for c in kids:
            remaining[c] -= 1
            if remaining[c] == 0:
                if not pushable and seen - visited == {c}:
                    # c is the exit — unless it loops straight back to s
                    if any(int(x) in (s, s ^ 1) for x in graph.follow(c)):
                        return None
                    inner = {h >> 1 for h in visited if h != s}
                    inner.discard(c >> 1)
                    return Snarl(start=s, end=c, contents=sorted(inner))
                pushable.append(c)
    return None


def snarls_along_path(graph: ArrayGraph, path_name_or_idx,
                      max_nodes_per_snarl: int = 1000) -> List[Snarl]:
    """Top-level snarls whose endpoints are consecutive anchors on the given
    backbone path: the chain the caller iterates (reference: vg call's
    top-level snarl chain)."""
    handles = graph.path_handles(path_name_or_idx)
    out: List[Snarl] = []
    i = 0
    hset = {int(h) for h in handles}
    pos_of = {int(h): i for i, h in enumerate(handles)}
    while i < len(handles) - 1:
        h = int(handles[i])
        nxt = graph.follow(h)
        if len(nxt) == 1 and int(nxt[0]) == int(handles[i + 1]) and \
                len(graph.predecessors(int(handles[i + 1]))) == 1:
            i += 1
            continue                      # trivial chain link, no snarl
        sn = find_superbubble(graph, h, max_nodes_per_snarl)
        if sn is not None and sn.end in pos_of and pos_of[sn.end] > i:
            out.append(sn)
            i = pos_of[sn.end]
        else:
            i += 1
    return out


def snarl_traversals(graph: ArrayGraph, sn: Snarl,
                     max_traversals: int = 32,
                     max_steps: int = 200) -> List[List[int]]:
    """Enumerate directed handle walks start..end through the snarl
    (reference: traversal finders, src/traversal_finder.hpp:51-636 —
    this is the exhaustive finder with caps; support ranking happens in
    the caller)."""
    inner = set(sn.contents)
    results: List[List[int]] = []
    stack: List[List[int]] = [[sn.start]]
    while stack and len(results) < max_traversals:
        walk = stack.pop()
        cur = walk[-1]
        if len(walk) > max_steps:
            continue
        for c in graph.follow(cur):
            c = int(c)
            if c == sn.end:
                results.append(walk + [c])
                if len(results) >= max_traversals:
                    break
            elif (c >> 1) in inner:
                if (c >> 1) not in {w >> 1 for w in walk[1:]}:
                    stack.append(walk + [c])
    return results


def haplotype_traversals(haps, sn: Snarl,
                         max_traversals: int = 32) -> List[List[int]]:
    """Snarl traversals restricted to walks the indexed haplotypes actually
    take (reference: GBWTTraversalFinder, src/traversal_finder.hpp:457-521 —
    there a GBWT search from the snarl start; here a scan over the
    materialized haplotype step walks, vectorized over occurrence sites).

    Returns deduplicated directed handle walks start..end, each oriented
    with the snarl (reverse-strand haplotype passes are flipped)."""
    steps = haps.steps
    bounds = haps.steps_start
    out: List[List[int]] = []
    seen = set()

    def scan(anchor: int, stop: int, flip: bool):
        occ = np.nonzero(steps == anchor)[0]
        for pos in occ:
            hap = int(np.searchsorted(bounds, pos, side="right")) - 1
            end = int(bounds[hap + 1])
            for j in range(int(pos) + 1, min(end, int(pos) + 200)):
                if int(steps[j]) == stop:
                    walk = [int(h) for h in steps[pos : j + 1]]
                    if flip:
                        walk = [h ^ 1 for h in reversed(walk)]
                    key = tuple(walk)
                    if key not in seen:
                        seen.add(key)
                        out.append(walk)
                    break
            if len(out) >= max_traversals:
                return

    scan(sn.start, sn.end, flip=False)          # forward passes
    if len(out) < max_traversals:
        scan(sn.end ^ 1, sn.start ^ 1, flip=True)  # reverse-strand passes
    return out
