"""Flow traversal finder: k widest paths through a snarl by support.

The reference's `vg call` default allele enumerator is
FlowTraversalFinder (src/traversal_finder.hpp:588), which runs Yen's
algorithm over WIDEST paths (src/algorithms/k_widest_paths.cpp):
path width = min over its nodes/edges of the pack coverage, and the
K best-width start->end walks become candidate alleles. Unlike the
exhaustive finder with a traversal cap, this is guided by read support,
so dense snarls (many combinatorial walks) still surface the two or
three alleles the reads actually take (round-2 verdict item 7).

Handles are vg_tpu's int side-handles (node<<1 | orient); the graph is
an ArrayGraph. Weights come from the Packer (node average coverage and
edge support), matching FlowCaller's use.

Copied from vg_tpu/graph/flowtrav.py.
"""
from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

INF = float("inf")


def widest_dijkstra(graph, source: int, sink: int, inner: Set[int],
                    node_w: Callable[[int], float],
                    edge_w: Callable[[int, int], float],
                    forgotten_nodes: Optional[Set[int]] = None,
                    forgotten_edges: Optional[Set[Tuple[int, int]]] = None,
                    ) -> Tuple[float, List[int]]:
    """Maximum-bottleneck (widest) path source->sink through the snarl's
    contents (reference widest_dijkstra, k_widest_paths.cpp:18-150,
    min-flow accumulation). The source's own weight is not counted,
    like the reference. Returns (width, handle walk) or (0, [])."""
    forgotten_nodes = forgotten_nodes or set()
    forgotten_edges = forgotten_edges or set()
    visited: Dict[int, int] = {}
    heap: List[Tuple[float, int, int, int]] = [(-INF, 0, source, -1)]
    counter = 1
    while heap:
        ns, _, cur, prev = heapq.heappop(heap)
        if cur in visited:
            continue
        visited[cur] = prev
        score = -ns
        if cur == sink:
            walk = [cur]
            while walk[-1] != source:
                walk.append(visited[walk[-1]])
            walk.reverse()
            return (score if score != INF else 0.0, walk)
        for nxt in graph.follow(cur):
            nxt = int(nxt)
            if nxt in visited or nxt in forgotten_nodes:
                continue
            if nxt != sink and (nxt >> 1) not in inner:
                continue
            if (cur, nxt) in forgotten_edges:
                continue
            s2 = min(score, edge_w(cur, nxt))
            if nxt != sink:
                s2 = min(s2, node_w(nxt))
            heapq.heappush(heap, (-s2, counter, nxt, cur))
            counter += 1
    return (0.0, [])


def _path_width(walk: Sequence[int], node_w, edge_w) -> float:
    """Width of a full walk, source and sink weights excluded (matches
    the dijkstra accumulation)."""
    width = INF
    for i in range(len(walk) - 1):
        width = min(width, edge_w(walk[i], walk[i + 1]))
        if i + 1 < len(walk) - 1:
            width = min(width, node_w(walk[i + 1]))
    return width if width != INF else 0.0


def yens_k_widest(graph, source: int, sink: int, inner: Set[int], K: int,
                  node_w: Callable[[int], float],
                  edge_w: Callable[[int, int], float],
                  ) -> List[Tuple[float, List[int]]]:
    """Yen's algorithm over widest paths with Lawler's spur-skip
    (reference yens_k_widest_paths, k_widest_paths.cpp:156-270).
    Returns up to K (width, walk) pairs, best first."""
    first = widest_dijkstra(graph, source, sink, inner, node_w, edge_w)
    if not first[1]:
        return []
    best: List[Tuple[float, List[int]]] = [first]
    best_spurs = [0]
    seen = {tuple(first[1])}
    candidates: Dict[tuple, Tuple[float, int]] = {}   # path -> (width, spur)

    while len(best) < K:
        prev_path = best[-1][1]
        for i in range(best_spurs[-1], len(prev_path) - 1):
            root = prev_path[: i + 1]
            forgotten_edges: Set[Tuple[int, int]] = set()
            for _, p in best:
                if len(p) > i and p[: i + 1] == root:
                    forgotten_edges.add((p[i], p[i + 1]))
            forgotten_nodes = set(prev_path[:i])
            w, spur_path = widest_dijkstra(
                graph, prev_path[i], sink, inner, node_w, edge_w,
                forgotten_nodes, forgotten_edges)
            if not spur_path:
                continue
            cand = tuple(prev_path[:i] + spur_path)
            if cand in seen:
                continue
            cw = _path_width(cand, node_w, edge_w)
            old = candidates.get(cand)
            if old is None or cw > old[0]:
                candidates[cand] = (cw, i)
        if not candidates:
            break
        cand, (cw, spur) = max(candidates.items(),
                               key=lambda kv: (kv[1][0], -len(kv[0])))
        del candidates[cand]
        best.append((cw, list(cand)))
        best_spurs.append(spur)
        seen.add(cand)
    return best


def flow_traversals(graph, pack, sn, K: int,
                    navg=None) -> List[List[int]]:
    """FlowTraversalFinder.find_weighted_traversals role
    (src/traversal_finder.cpp:3397-3420): K widest start->end walks of
    the snarl under pack coverage weights. `navg` may pass a
    precomputed node_avg_all() array."""
    if navg is None:
        navg = pack.node_avg_all()
    inner = set(sn.contents)

    def node_w(h: int) -> float:
        return float(navg[h >> 1])

    def edge_w(a: int, b: int) -> float:
        return float(pack.edge_support(a, b))

    out = yens_k_widest(graph, sn.start, sn.end, inner, K, node_w, edge_w)
    return [walk for _, walk in out]
