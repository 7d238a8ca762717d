"""Cactus-graph snarl decomposition for arbitrary bidirected graphs.

TPU-native re-think of the reference's IntegratedSnarlFinder
(src/integrated_snarl_finder.cpp, SnarlManager
src/snarls.hpp:408): the construction follows the ultrabubble/cactus
theory — biedged graph -> adjacency components -> 3-edge-connected
component merge -> cactus forest -> rooted snarl/chain tree — with host
numpy/union-find doing the graph contraction and a linear-time
cycle-equivalence pass (program-structure-tree bracket algorithm) doing
the 3ECC work the reference delegates to
src/algorithms/three_edge_connected_components.cpp.

Unlike the round-1 backbone superbubble finder (graph/snarls.py), this
handles cyclic graphs, inversions, and off-path bubbles, and produces
nested snarls organised into chains, which is what `call`, `snarls`, and
`simplify` need on real pangenome GFAs.

Conventions: a node side is ``node_idx * 2 + end`` (end 0 = left side of
the forward orientation, 1 = right side). A handle is ``node_idx * 2 +
orient``. A snarl's ``start`` is a handle whose forward traversal enters
the snarl, ``end`` a handle whose forward traversal exits it (same
convention as graph/snarls.py:Snarl).

Copied from vg_tpu/graph/cactus.py; the reference file above is named
without its checkout's directory, the copy's only change.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .arraygraph import ArrayGraph


# --------------------------------------------------------------- union-find

class _UF:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, x: int) -> int:
        p = self.p
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[rb] = ra


# ------------------------------------------------- cycle equivalence (PST)

class _Br:
    __slots__ = ("anc_dfs", "edge", "capping", "prev", "next",
                 "recent_size", "recent_class")

    def __init__(self, anc_dfs, edge, capping):
        self.anc_dfs = anc_dfs
        self.edge = edge            # edge id, or -1 for capping brackets
        self.capping = capping
        self.prev = None
        self.next = None
        self.recent_size = -1
        self.recent_class = -1


class _BList:
    __slots__ = ("head", "tail", "size")

    def __init__(self):
        self.head = None
        self.tail = None
        self.size = 0

    def push(self, b):
        b.next = self.head
        b.prev = None
        if self.head is not None:
            self.head.prev = b
        self.head = b
        if self.tail is None:
            self.tail = b
        self.size += 1

    def delete(self, b):
        if b.prev is not None:
            b.prev.next = b.next
        else:
            self.head = b.next
        if b.next is not None:
            b.next.prev = b.prev
        else:
            self.tail = b.prev
        b.prev = b.next = None
        self.size -= 1

    def concat_under(self, other):
        """Append other's brackets below self's."""
        if other.size == 0:
            return
        if self.size == 0:
            self.head, self.tail, self.size = (other.head, other.tail,
                                               other.size)
            return
        self.tail.next = other.head
        other.head.prev = self.tail
        self.tail = other.tail
        self.size += other.size


def cut_pair_edges(n: int, edges: Sequence[Tuple[int, int]]) -> Set[int]:
    """Edge indices participating in some 2-edge-cut of the undirected
    multigraph (bridges excluded — remove them first or filter after).

    Johnson–Pearson–Pingali cycle-equivalence ("The program structure
    tree", PLDI'94): two distinct edges form a 2-edge-cut iff they are
    cycle-equivalent; one DFS with bracket lists computes the classes.
    Self-loops are ignored (never separating). Bridges come out as
    singleton classes and are not returned."""
    edge_class = _cycle_classes(n, edges)
    counts = Counter(c for c in edge_class if c >= 0)
    return {ei for ei, c in enumerate(edge_class)
            if c >= 0 and counts[c] >= 2}


def _cycle_classes(n: int, edges: Sequence[Tuple[int, int]]) -> List[int]:
    """Cycle-equivalence class id per edge (-1 for self-loops/unreached);
    the JPP bracket-list pass behind cut_pair_edges and the cactus
    builder. Valid within 2-edge-connected components (run on a
    bridge-free graph when classes are interpreted as cut pairs)."""
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for ei, (u, v) in enumerate(edges):
        if u == v:
            continue
        adj[u].append((v, ei))
        adj[v].append((u, ei))

    NIL = 1 << 60
    dfsnum = [-1] * n
    parent = [-1] * n
    parent_edge = [-1] * n
    order: List[int] = []
    is_tree = [False] * len(edges)

    # true DFS with iterator stack
    for root in range(n):
        if dfsnum[root] != -1:
            continue
        dfsnum[root] = len(order)
        order.append(root)
        stack = [(root, iter(adj[root]))]
        while stack:
            v, it = stack[-1]
            advanced = False
            for (w, ei) in it:
                if dfsnum[w] == -1:
                    dfsnum[w] = len(order)
                    order.append(w)
                    parent[w] = v
                    parent_edge[w] = ei
                    is_tree[ei] = True
                    stack.append((w, iter(adj[w])))
                    advanced = True
                    break
            if not advanced:
                stack.pop()

    # backedges oriented descendant -> ancestor
    by_desc: Dict[int, List[Tuple[int, int]]] = {}   # v -> [(anc, edge id)]
    for ei, (u, v) in enumerate(edges):
        if u == v or is_tree[ei]:
            continue
        if dfsnum[u] < dfsnum[v]:
            u, v = v, u
        by_desc.setdefault(u, []).append((v, ei))

    children: Dict[int, List[int]] = {}
    for v in order:
        if parent[v] >= 0:
            children.setdefault(parent[v], []).append(v)

    n_classes = 0
    edge_class = [-1] * len(edges)
    blists: Dict[int, _BList] = {}
    hi: Dict[int, int] = {}
    ends_at: Dict[int, List[_Br]] = {}   # dfsnum of ancestor -> brackets

    for v in reversed(order):
        dv = dfsnum[v]
        my_back = by_desc.get(v, [])
        hi0 = min((dfsnum[a] for (a, ei) in my_back), default=NIL)
        kids = children.get(v, [])
        kid_his = sorted(hi[c] for c in kids) if kids else []
        hi1 = kid_his[0] if kid_his else NIL
        hi2 = kid_his[1] if len(kid_his) > 1 else NIL
        hi[v] = min(hi0, hi1)

        bl = _BList()
        for c in kids:
            bl.concat_under(blists.pop(c))
        for b in ends_at.pop(dv, ()):
            bl.delete(b)
            if not b.capping and edge_class[b.edge] == -1:
                edge_class[b.edge] = n_classes
                n_classes += 1
        # push backedge brackets (nearest ancestor pushed last = topmost)
        for (a, ei) in sorted(my_back, key=lambda t: dfsnum[t[0]]):
            b = _Br(dfsnum[a], ei, False)
            bl.push(b)
            ends_at.setdefault(dfsnum[a], []).append(b)
        if hi2 < hi0 and hi2 < dv:
            # capping bracket (hi2 == dv would be a bracket to v itself:
            # no constraint, and it could never be deleted again)
            b = _Br(hi2, -1, True)
            bl.push(b)
            ends_at.setdefault(hi2, []).append(b)

        pe = parent_edge[v]
        if pe >= 0:
            if bl.size == 0:
                edge_class[pe] = n_classes      # bridge: singleton class
                n_classes += 1
            else:
                b = bl.head
                if b.recent_size != bl.size:
                    b.recent_size = bl.size
                    b.recent_class = n_classes
                    n_classes += 1
                edge_class[pe] = b.recent_class
                if bl.size == 1 and not b.capping:
                    edge_class[b.edge] = edge_class[pe]
        blists[v] = bl

    return edge_class


def three_edge_connected_components(n: int,
                                    edges: Sequence[Tuple[int, int]]
                                    ) -> List[int]:
    """Component id per vertex such that two vertices share an id iff they
    are 3-edge-connected (same component after removing every bridge and
    every edge participating in a 2-edge-cut).

    Cycle equivalence == 2-cut only holds inside a 2-edge-connected
    graph, so bridges are removed first and the bracket pass runs on the
    bridge-free graph (whose components are exactly the 2ECCs). Each
    cut class then refines the partition independently: u,v are 3EC iff
    no single class's removal separates them (removing all classes at
    once over-separates — different classes can each cut a different
    one of three edge-disjoint paths)."""
    bridges = find_bridges(n, edges)
    kept = [e for ei, e in enumerate(edges)
            if ei not in bridges and e[0] != e[1]]
    classes = _cycle_classes(n, kept)
    by_class: Dict[int, List[int]] = {}
    for li, c in enumerate(classes):
        if c >= 0:
            by_class.setdefault(c, []).append(li)
    cut_classes = [v for v in by_class.values() if len(v) >= 2]

    # adjacency of the bridge-free graph, with local edge ids
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for li, (u, v) in enumerate(kept):
        adj[u].append((v, li))
        adj[v].append((u, li))

    # label = refined partition id; start with 2ECC (connected component
    # of the bridge-free graph)
    label = [-1] * n
    nl = 0
    for root in range(n):
        if label[root] != -1 or not adj[root]:
            continue
        stack = [root]
        label[root] = nl
        while stack:
            x = stack.pop()
            for (y, _) in adj[x]:
                if label[y] == -1:
                    label[y] = nl
                    stack.append(y)
        nl += 1
    for v in range(n):
        if label[v] == -1:
            label[v] = nl        # isolated vertices: own labels
            nl += 1

    for cls in cut_classes:
        removed = set(cls)
        # BFS the 2ECC containing this class with class edges removed;
        # each piece refines the labels of its vertices
        seeds: List[int] = []
        for li in cls:
            seeds.extend(kept[li])
        seen: Dict[int, int] = {}
        piece = 0
        for s in seeds:
            if s in seen:
                continue
            stack = [s]
            seen[s] = piece
            while stack:
                x = stack.pop()
                for (y, li) in adj[x]:
                    if li in removed or y in seen:
                        continue
                    seen[y] = piece
                    stack.append(y)
            piece += 1
        if piece <= 1:
            continue
        remap: Dict[Tuple[int, int], int] = {}
        for v, pc in seen.items():
            key = (label[v], pc)
            if key not in remap:
                remap[key] = nl
                nl += 1
            label[v] = remap[key]
    return label


def find_bridges(n: int, edges: Sequence[Tuple[int, int]]) -> Set[int]:
    """Bridge edge indices (undirected multigraph; parallel edges are
    never bridges, handled naturally by skipping the parent *edge id*,
    not the parent vertex)."""
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    for ei, (u, v) in enumerate(edges):
        if u == v:
            continue
        adj[u].append((v, ei))
        adj[v].append((u, ei))
    disc = [-1] * n
    low = [0] * n
    bridges: Set[int] = set()
    timer = 0
    for root in range(n):
        if disc[root] != -1:
            continue
        disc[root] = low[root] = timer
        timer += 1
        stack = [(root, -1, iter(adj[root]))]
        while stack:
            v, pe, it = stack[-1]
            advanced = False
            for (w, ei) in it:
                if ei == pe:
                    continue
                if disc[w] == -1:
                    disc[w] = low[w] = timer
                    timer += 1
                    stack.append((w, ei, iter(adj[w])))
                    advanced = True
                    break
                low[v] = min(low[v], disc[w])
            if not advanced:
                stack.pop()
                if stack:
                    u = stack[-1][0]
                    if low[v] > disc[u]:
                        bridges.add(pe)
                    low[u] = min(low[u], low[v])
    return bridges


# ------------------------------------------------------------ cactus build

@dataclass
class Cactus:
    """Cactus graph of a bidirected sequence graph.

    vertices: merged adjacency components (after 3ECC contraction),
    edges: one per graph node, classified into self-loops, bridges, and
    simple-cycle members (each non-bridge edge lies on exactly one cycle).
    """
    n_vertices: int
    side_cv: np.ndarray            # (2n,) cactus vertex per node side
    edge_cv: np.ndarray            # (n, 2) cactus vertex of (left, right)
    self_loops: Dict[int, List[int]]   # cactus vertex -> node ids
    bridges: List[int]                 # node ids that are cactus bridges
    bridge_at: Dict[int, List[int]]    # cactus vertex -> bridge node ids
    cycles: List[Tuple[List[int], List[int]]]  # (edge nodes, vertices)
    cycles_at: Dict[int, List[int]]    # cactus vertex -> cycle ids


def build_cactus(graph: ArrayGraph) -> Cactus:
    n = graph.node_count
    uf = _UF(2 * n)
    # adjacency components: union sides joined by edges.
    # handle h: start side = 2*(h>>1) + (h&1), end side = 2*(h>>1) + 1-(h&1)
    for h in range(2 * n):
        for t in graph.follow(h):
            t = int(t)
            end_side = 2 * (h >> 1) + 1 - (h & 1)
            start_side = 2 * (t >> 1) + (t & 1)
            uf.union(end_side, start_side)
    comp_of = {}
    side_comp = np.zeros(2 * n, np.int64)
    for s in range(2 * n):
        r = uf.find(s)
        if r not in comp_of:
            comp_of[r] = len(comp_of)
        side_comp[s] = comp_of[r]
    ncomp = len(comp_of)
    a_edges = [(int(side_comp[2 * i]), int(side_comp[2 * i + 1]))
               for i in range(n)]
    labels = three_edge_connected_components(ncomp, a_edges)
    relabel = {}
    cv_sides = np.zeros(2 * n, np.int64)
    for s in range(2 * n):
        l = labels[side_comp[s]]
        if l not in relabel:
            relabel[l] = len(relabel)
        cv_sides[s] = relabel[l]
    ncv = len(relabel)
    edge_cv = np.stack([cv_sides[0::2], cv_sides[1::2]], axis=1)

    self_loops: Dict[int, List[int]] = {}
    bridge_at: Dict[int, List[int]] = {}
    cycles_at: Dict[int, List[int]] = {}
    non_loop = []
    for i in range(n):
        u, v = int(edge_cv[i, 0]), int(edge_cv[i, 1])
        if u == v:
            self_loops.setdefault(u, []).append(i)
        else:
            non_loop.append(i)
    c_edges = [(int(edge_cv[i, 0]), int(edge_cv[i, 1])) for i in non_loop]
    br_local = find_bridges(ncv, c_edges)
    bridges = [non_loop[li] for li in br_local]
    for b in bridges:
        bridge_at.setdefault(int(edge_cv[b, 0]), []).append(b)
        bridge_at.setdefault(int(edge_cv[b, 1]), []).append(b)

    # cycle extraction on the non-bridge, non-self-loop subgraph: DFS;
    # each backedge closes exactly one cycle (cactus property) made of
    # the backedge plus the tree path, and tree paths are edge-disjoint
    cyc_nodes = [non_loop[li] for li in range(len(non_loop))
                 if li not in br_local]
    adj: Dict[int, List[Tuple[int, int]]] = {}
    for i in cyc_nodes:
        u, v = int(edge_cv[i, 0]), int(edge_cv[i, 1])
        adj.setdefault(u, []).append((v, i))
        adj.setdefault(v, []).append((u, i))
    cycles: List[Tuple[List[int], List[int]]] = []
    used: Set[int] = set()
    depth: Dict[int, int] = {}
    par: Dict[int, Tuple[int, int]] = {}   # vertex -> (parent vertex, edge)
    for root in adj:
        if root in depth:
            continue
        depth[root] = 0
        stack = [(root, iter(adj[root]))]
        while stack:
            v, it = stack[-1]
            advanced = False
            for (w, ei) in it:
                if par.get(v, (None, -1))[1] == ei:
                    continue
                if w not in depth:
                    depth[w] = depth[v] + 1
                    par[w] = (v, ei)
                    stack.append((w, iter(adj[w])))
                    advanced = True
                    break
                if depth[w] <= depth[v] and ei not in used:
                    # backedge (or parallel-edge 2-cycle): close the
                    # unique cycle = tree path w..v plus this edge
                    path_vertices = [v]
                    path_edges: List[int] = []
                    x = v
                    while x != w:
                        px, pe = par[x]
                        path_edges.append(pe)
                        path_vertices.append(px)
                        x = px
                    vert_seq = list(reversed(path_vertices))   # [w..v]
                    edges_walk = list(reversed(path_edges)) + [ei]
                    used.update(edges_walk)
                    cid = len(cycles)
                    cycles.append((edges_walk, vert_seq))
                    for vv in vert_seq:
                        cycles_at.setdefault(vv, []).append(cid)
            if not advanced:
                stack.pop()
    return Cactus(n_vertices=ncv, side_cv=cv_sides, edge_cv=edge_cv,
                  self_loops=self_loops, bridges=bridges,
                  bridge_at=bridge_at, cycles=cycles, cycles_at=cycles_at)


# ------------------------------------------------------- snarl/chain tree

@dataclass
class CSnarl:
    start: int                     # handle entering the snarl
    end: int                       # handle exiting the snarl
    chain: int                     # chain this snarl belongs to (-1: root)
    children: List[int] = field(default_factory=list)   # child chain ids
    region: List[int] = field(default_factory=list)     # cactus vertices


@dataclass
class CChain:
    nodes: List[int]               # chain-link handles in chain order
    snarls: List[int]              # snarl ids between consecutive links
    parent_snarl: int = -1
    is_cyclic: bool = False


class SnarlDecomposition:
    """Nested snarl/chain forest of a bidirected graph (the reference's
    SnarlManager role, src/snarls.hpp:408). Root "snarls" (start == -1)
    hold each connected component's top-level chains."""

    def __init__(self, graph: ArrayGraph):
        self.graph = graph
        self.snarls: List[CSnarl] = []
        self.chains: List[CChain] = []
        self._contents: Optional[Dict[int, List[int]]] = None

    # -- queries ---------------------------------------------------------

    def real_snarls(self) -> List[int]:
        return [si for si, s in enumerate(self.snarls) if s.start >= 0]

    def top_chains(self) -> List[int]:
        roots = {si for si, s in enumerate(self.snarls) if s.start < 0}
        return [ci for ci, c in enumerate(self.chains)
                if c.parent_snarl in roots or c.parent_snarl == -1]

    def snarl_contents(self, si: int) -> List[int]:
        """Node indices strictly inside snarl si (recursive)."""
        if self._contents is None:
            self._compute_contents()
        return self._contents.get(si, [])

    def _chain_node_set(self, ci: int) -> Set[int]:
        c = self.chains[ci]
        s: Set[int] = {h >> 1 for h in c.nodes}
        for si in c.snarls:
            s |= set(self._contents.get(si, ()))
        return s

    def _compute_contents(self) -> None:
        self._contents = {}
        # bottom-up over the snarl tree
        order: List[int] = []
        seen = set()

        def visit_chain(ci: int):
            for si in self.chains[ci].snarls:
                if si in seen:
                    continue
                seen.add(si)
                for cc in self.snarls[si].children:
                    visit_chain(cc)
                order.append(si)

        for ci in range(len(self.chains)):
            visit_chain(ci)
        for si in order:
            acc: Set[int] = set()
            sn = self.snarls[si]
            for cc in sn.children:
                acc |= self._chain_node_set(cc)
            acc.discard(sn.start >> 1)
            acc.discard(sn.end >> 1)
            self._contents[si] = sorted(acc)

    def validate(self) -> List[str]:
        """Structural checks (used by the fuzzer): every node appears in
        exactly one chain; snarl boundaries separate their contents."""
        problems = []
        owner: Dict[int, int] = {}
        for ci, c in enumerate(self.chains):
            for h in c.nodes:
                nid = h >> 1
                if nid in owner:
                    problems.append(f"node {nid} in chains {owner[nid]},{ci}")
                owner[nid] = ci
        for nid in range(self.graph.node_count):
            if nid not in owner:
                problems.append(f"node {nid} in no chain")
        return problems


def _oriented_handle(edge_cv: np.ndarray, node: int, end_cv: int) -> int:
    """Handle of ``node`` oriented so its END side maps to cactus vertex
    end_cv (forward traversal of the handle reads INTO end_cv)."""
    if int(edge_cv[node, 1]) == end_cv:
        return node * 2
    assert int(edge_cv[node, 0]) == end_cv, (node, end_cv)
    return node * 2 + 1


class _Decomposer:
    def __init__(self, graph: ArrayGraph):
        self.g = graph
        self.cac = build_cactus(graph)
        self.dec = SnarlDecomposition(graph)
        cac = self.cac
        self.node_len = np.asarray(
            [graph.seq_start[i + 1] - graph.seq_start[i]
             for i in range(graph.node_count)], np.int64)
        # bridge forest
        bf = _UF(cac.n_vertices)
        for (es, vs) in cac.cycles:
            for v in vs[1:]:
                bf.union(vs[0], v)
        self.bf_of = [bf.find(v) for v in range(cac.n_vertices)]
        self.bf_adj: Dict[int, List[Tuple[int, int]]] = {}
        for b in cac.bridges:
            u = self.bf_of[int(cac.edge_cv[b, 0])]
            v = self.bf_of[int(cac.edge_cv[b, 1])]
            self.bf_adj.setdefault(u, []).append((v, b))
            self.bf_adj.setdefault(v, []).append((u, b))
        self.done_cycles: Set[int] = set()
        self.done_selfloops: Set[int] = set()
        self.done_bridges: Set[int] = set()
        self._subtree_w: Dict[Tuple[int, int], int] = {}

    # ---------------------------------------------------------- plumbing

    def new_chain(self, parent_snarl: int, cyclic: bool = False) -> int:
        self.dec.chains.append(
            CChain(nodes=[], snarls=[], parent_snarl=parent_snarl,
                   is_cyclic=cyclic))
        return len(self.dec.chains) - 1

    def new_root_snarl(self) -> int:
        self.dec.snarls.append(CSnarl(start=-1, end=-1, chain=-1))
        return len(self.dec.snarls) - 1

    def subtree_weight(self, to_bf: int, via: int) -> int:
        """bp weight of the bridge subtree entered by crossing bridge
        `via` into BF vertex to_bf."""
        key = (to_bf, via)
        if key in self._subtree_w:
            return self._subtree_w[key]
        w = int(self.node_len[via])
        self._subtree_w[key] = w   # breaks cycles defensively (tree anyway)
        for (other, bn) in self.bf_adj.get(to_bf, ()):
            if bn == via:
                continue
            w += self.subtree_weight(other, bn)
        self._subtree_w[key] = w
        return w

    def deepest_path(self, w_bf: int, avoid: int) -> List[Tuple[int, int]]:
        """Heaviest bridge descent from BF vertex w_bf (not back across
        bridge `avoid`): list of (bridge node, far BF vertex)."""
        out = []
        cur = w_bf
        prev = avoid
        while True:
            best = None
            for (other, bn) in self.bf_adj.get(cur, ()):
                if bn == prev:
                    continue
                wt = self.subtree_weight(other, bn)
                if best is None or wt > best[0] or (wt == best[0]
                                                   and bn < best[1]):
                    best = (wt, bn, other)
            if best is None:
                return out
            out.append((best[1], best[2]))
            prev = best[1]
            cur = best[2]

    def cycle_path(self, a: int, b: int) -> List[Tuple[int, int, int]]:
        """Path of (cycle id, entry vertex, exit vertex) from cactus
        vertex a to b through the cycle tree of one BF vertex."""
        if a == b:
            return []
        cac = self.cac
        prev: Dict[int, Optional[Tuple[int, int, int]]] = {a: None}
        queue = [a]
        qi = 0
        while qi < len(queue) and b not in prev:
            x = queue[qi]
            qi += 1
            for cid in cac.cycles_at.get(x, ()):
                for y in cac.cycles[cid][1]:
                    if y not in prev:
                        prev[y] = (cid, x, y)
                        queue.append(y)
        assert b in prev, "no cycle path (corrupt cactus)"
        path = []
        y = b
        while prev[y] is not None:
            path.append(prev[y])
            y = prev[y][1]
        return list(reversed(path))

    def cut_cycle(self, cid: int, x: int, y: int):
        """Split cycle cid at distinct vertices x, y into two directed
        arcs x -> y of (node, from_cv, to_cv)."""
        es, vs = self.cac.cycles[cid]
        k = len(es)
        ix = vs.index(x)
        iy = vs.index(y)
        arc1 = []
        i = ix
        while i != iy:
            arc1.append((es[i], vs[i], vs[(i + 1) % k]))
            i = (i + 1) % k
        arc2 = []
        i = iy
        while i != ix:
            arc2.append((es[i], vs[i], vs[(i + 1) % k]))
            i = (i + 1) % k
        arc2 = [(e, t, f) for (e, f, t) in reversed(arc2)]
        return arc1, arc2

    # ---------------------------------------------------------- emission

    def emit_chain(self, dedges, parent_snarl: int,
                   cyclic: bool = False) -> int:
        ci = self.new_chain(parent_snarl, cyclic)
        ch = self.dec.chains[ci]
        for (e, f, t) in dedges:
            ch.nodes.append(_oriented_handle(self.cac.edge_cv, e, t))
        pairs = list(zip(dedges, dedges[1:]))
        if cyclic and dedges:
            pairs.append((dedges[-1], dedges[0]))
        for (e1, f1, t1), (e2, f2, t2) in pairs:
            ch.snarls.append(self.make_snarl(e1, t1, e2, f2, ci))
        return ci

    def attach_vertex(self, si: int, v: int) -> None:
        """Attach cactus vertex v's dangling structure (other cycles,
        self-loops, bridges) to snarl si as child chains."""
        cac = self.cac
        sn = self.dec.snarls[si]
        for cid in cac.cycles_at.get(v, ()):
            if cid in self.done_cycles:
                continue
            self.done_cycles.add(cid)
            es, vs = cac.cycles[cid]
            k = len(es)
            iv = vs.index(v)
            walk = [(es[(iv + j) % k], vs[(iv + j) % k],
                     vs[(iv + j + 1) % k]) for j in range(k)]
            sn.children.append(self.emit_chain(walk, si))
        for nl in cac.self_loops.get(v, ()):
            if nl in self.done_selfloops:
                continue
            self.done_selfloops.add(nl)
            ci = self.new_chain(si)
            self.dec.chains[ci].nodes.append(nl * 2)
            sn.children.append(ci)
        for (other, bn) in self.bf_adj.get(self.bf_of[v], ()):
            if bn in self.done_bridges:
                continue
            # this bridge must attach at v itself, not elsewhere in the
            # same BF vertex
            if int(cac.edge_cv[bn, 0]) != v and int(cac.edge_cv[bn, 1]) != v:
                continue
            far_bf = (self.bf_of[int(cac.edge_cv[bn, 1])]
                      if self.bf_of[int(cac.edge_cv[bn, 0])]
                      == self.bf_of[v]
                      else self.bf_of[int(cac.edge_cv[bn, 0])])
            self.done_bridges.add(bn)
            bpath = [(bn, far_bf)] + self.deepest_path(far_bf, bn)
            for (b2, _) in bpath[1:]:
                self.done_bridges.add(b2)
            sn.children.append(self.emit_bridge_chain(bpath, v, si))

    def make_snarl(self, e_in: int, a: int, e_out: int, b: int,
                   chain: int) -> int:
        """Snarl between directed edge e_in entering at cactus vertex a
        and e_out leaving from cactus vertex b."""
        cac = self.cac
        si = len(self.dec.snarls)
        start = _oriented_handle(cac.edge_cv, e_in, a)
        end = _oriented_handle(cac.edge_cv, e_out, b) ^ 1
        sn = CSnarl(start=start, end=end, chain=chain)
        self.dec.snarls.append(sn)

        region = [a]
        path = self.cycle_path(a, b)
        for (cid, x, y) in path:
            self.done_cycles.add(cid)
            if y not in region:
                region.append(y)
            arc1, arc2 = self.cut_cycle(cid, x, y)
            sn.children.append(self.emit_chain(arc1, si))
            sn.children.append(self.emit_chain(arc2, si))
        sn.region = region
        i = 0
        while i < len(sn.region):       # region can grow via bridge merges
            self.attach_vertex(si, sn.region[i])
            i += 1
        return si

    def emit_bridge_chain(self, bpath, att: int, parent_snarl: int) -> int:
        """Chain along a bridge path starting at cactus vertex att; the
        far leaf attachment merges into the parent snarl's region."""
        cac = self.cac
        ci = self.new_chain(parent_snarl)
        ch = self.dec.chains[ci]
        cur_att = att
        prev: Optional[Tuple[int, int]] = None
        for (bn, far_bf) in bpath:
            u, v = int(cac.edge_cv[bn, 0]), int(cac.edge_cv[bn, 1])
            # near attachment = endpoint in the current BF vertex (it may
            # differ from the previous bridge's far attachment: bridges
            # enter and leave a BF vertex at different cactus vertices,
            # connected inside by cycles)
            if self.bf_of[u] == self.bf_of[cur_att]:
                near_att, far_att = u, v
            else:
                near_att, far_att = v, u
            ch.nodes.append(_oriented_handle(cac.edge_cv, bn, far_att))
            if prev is not None:
                pbn, p_entry = prev
                ch.snarls.append(self.make_snarl(pbn, p_entry, bn,
                                                 near_att, ci))
            prev = (bn, far_att)
            cur_att = far_att
        sn = self.dec.snarls[parent_snarl]
        if cur_att not in sn.region:
            sn.region.append(cur_att)
            if sn.start >= 0:
                pass   # make_snarl's growth loop will pick it up if still
                       # iterating; otherwise attach now
            self.attach_vertex(parent_snarl, cur_att)
        return ci

    # ------------------------------------------------------------- roots

    def run(self) -> SnarlDecomposition:
        cac = self.cac
        comp_seen: Set[int] = set()
        bf_verts: Dict[int, List[int]] = {}
        for v in range(cac.n_vertices):
            bf_verts.setdefault(self.bf_of[v], []).append(v)
        for start_bf in sorted(bf_verts):
            if start_bf in comp_seen:
                continue
            comp = [start_bf]
            comp_seen.add(start_bf)
            qi = 0
            while qi < len(comp):
                x = comp[qi]
                qi += 1
                for (y, bn) in self.bf_adj.get(x, ()):
                    if y not in comp_seen:
                        comp_seen.add(y)
                        comp.append(y)
            self._run_component(comp, bf_verts)
        return self.dec

    def _run_component(self, comp: List[int], bf_verts) -> None:
        cac = self.cac
        root = self.new_root_snarl()
        # longest tip-tip bridge path (weighted diameter of the BF tree)
        start_v, path_edges = self._diameter(comp)
        path_w = sum(int(self.node_len[bn]) for (bn, _) in path_edges)
        # longest not-yet-done cycle in the component
        best_cycle, best_w = -1, -1
        for bfv in comp:
            for v in bf_verts.get(bfv, ()):
                for cid in cac.cycles_at.get(v, ()):
                    if cid in self.done_cycles:
                        continue
                    w = sum(int(self.node_len[e])
                            for e in cac.cycles[cid][0])
                    if w > best_w:
                        best_w, best_cycle = w, cid
        if best_cycle >= 0 and best_w > path_w:
            # root on the longest cycle: cyclic top-level chain
            self.done_cycles.add(best_cycle)
            es, vs = cac.cycles[best_cycle]
            k = len(es)
            walk = [(es[j], vs[j], vs[(j + 1) % k]) for j in range(k)]
            sn = self.dec.snarls[root]
            sn.children.append(self.emit_chain(walk, root, cyclic=True))
        elif path_edges:
            # root on the tip-tip path: top-level bridge chain; contents
            # at the two path ends spill into the root snarl
            cac_edge = path_edges[0][0]
            u, v = int(cac.edge_cv[cac_edge, 0]), int(cac.edge_cv[cac_edge, 1])
            att0 = u if self.bf_of[u] == start_v else v
            for (bn, _) in path_edges:
                self.done_bridges.add(bn)
            sn = self.dec.snarls[root]
            sn.region.append(att0)
            sn.children.append(
                self.emit_bridge_chain(path_edges, att0, root))
            self.attach_vertex(root, att0)
        else:
            # single BF vertex, no bridges, no cycles: self-loops only
            sn = self.dec.snarls[root]
            for v in bf_verts.get(comp[0], ()):
                sn.region.append(v)
                self.attach_vertex(root, v)

    def _diameter(self, comp: List[int]) -> Tuple[int, List[Tuple[int, int]]]:
        """Weighted diameter path of the BF tree component: returns
        (start BF vertex, [(bridge node, next BF vertex), ...])."""
        def farthest(src: int):
            dist = {src: 0}
            par: Dict[int, Tuple[int, int]] = {}
            stack = [src]
            best, bd = src, 0
            while stack:
                x = stack.pop()
                for (y, bn) in self.bf_adj.get(x, ()):
                    if y in dist or (x in par and par[x][1] == bn):
                        continue
                    dist[y] = dist[x] + int(self.node_len[bn])
                    par[y] = (x, bn)
                    if dist[y] > bd or (dist[y] == bd and y < best):
                        best, bd = y, dist[y]
                    stack.append(y)
            return best, par

        a, _ = farthest(comp[0])
        b, par = farthest(a)
        # walk back from b to a
        path = []
        x = b
        while x in par:
            px, bn = par[x]
            path.append((bn, x))
            x = px
        return a, list(reversed(path))


def decompose(graph: ArrayGraph) -> SnarlDecomposition:
    """Full nested snarl decomposition (IntegratedSnarlFinder-equivalent,
    reference src/integrated_snarl_finder.cpp:1093 find_snarls_impl)."""
    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        return _Decomposer(graph).run()
    finally:
        sys.setrecursionlimit(old)


# ------------------------------------------------ integration adapters

def snarls_on_path(graph: ArrayGraph, path_name_or_idx,
                   dec: Optional[SnarlDecomposition] = None):
    """Snarls (legacy graph.snarls.Snarl records) whose boundary nodes lie
    on the given path, oriented along it, with nesting information.

    Returns (snarls, children) where children[i] lists indices of snarls
    directly nested inside snarl i, and top-level snarls have parent None.
    Replaces snarls_along_path for arbitrary graphs (cyclic, inversions,
    off-path bubbles all handled by the cactus decomposition)."""
    from .snarls import Snarl

    if dec is None:
        dec = decompose(graph)
    handles = graph.path_handles(path_name_or_idx)
    pos = {int(h): i for i, h in enumerate(handles)}
    kept: Dict[int, int] = {}       # dec snarl id -> output index
    out: List[Snarl] = []
    for si in dec.real_snarls():
        s = dec.snarls[si]
        placed = None
        for (st, en) in ((s.start, s.end), (s.end ^ 1, s.start ^ 1)):
            if st in pos and en in pos and pos[st] < pos[en]:
                placed = (st, en)
                break
        if placed is None:
            continue
        contents = dec.snarl_contents(si)
        if not contents:
            continue                 # trivial chain link, not a variant site
        kept[si] = len(out)
        out.append(Snarl(start=placed[0], end=placed[1],
                         contents=list(contents)))
    children: List[List[int]] = [[] for _ in out]
    for si, oi in kept.items():
        ci = dec.snarls[si].chain
        ps = dec.chains[ci].parent_snarl if ci >= 0 else -1
        # walk up through non-kept ancestors to the nearest kept one
        while ps >= 0 and ps not in kept and dec.snarls[ps].start >= 0:
            pci = dec.snarls[ps].chain
            ps = dec.chains[pci].parent_snarl if pci >= 0 else -1
        if ps in kept:
            out[oi].parent = kept[ps]
            children[kept[ps]].append(oi)
    order = sorted(range(len(out)), key=lambda i: pos[out[i].start])
    remap = {old: new for new, old in enumerate(order)}
    out2 = [out[i] for i in order]
    children2 = [[remap[c] for c in children[i]] for i in order]
    for i, sn in enumerate(out2):
        if sn.parent is not None:
            sn.parent = remap[sn.parent]
    return out2, children2
