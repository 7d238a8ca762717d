"""Precomputed, serialized min-distance index over the snarl tree.

Reference: SnarlDistanceIndex (src/snarl_distance_index.cpp, 2441 LoC,
bdsg) — a snarl-tree-structured oracle built once and mmapped, answering
minimum_distance between any two positions without graph search.

TPU-era redesign: the cactus decomposition (graph/cactus.py) assigns
every node to exactly one chain; chains nest through snarls. The index
precomputes

- per chain: prefix coordinates of every link (node lengths plus each
  intervening snarl's minimum through-distance),
- per snarl: shortest distances from its two boundaries to every content
  node's two sides (bounded Dijkstra inside the snarl — snarl contents
  are small),
- the chain -> parent snarl -> parent chain attachment coordinates,

so a query lifts both positions to their common chain frame in O(depth)
array lookups and combines coordinates. Each lift follows an actual
walk, so the result is an ADMISSIBLE UPPER BOUND on the true minimum
distance; `min_distance` therefore answers "is the distance <= limit?"
instantly in the overwhelmingly common case and falls back to the exact
bounded Dijkstra only when the bound is inconclusive — the hybrid the
reference's own unittest fuzzers use as their oracle, inverted.

Serialization: one .npz of flat arrays (`save`/`load`).

Copied from vg_tpu/graph/distindex.py.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from .arraygraph import ArrayGraph
from .cactus import SnarlDecomposition, decompose
from .distance import min_distance as dijkstra_min_distance

Position = Tuple[int, int, bool]
INF = np.int64(1 << 60)


class DistanceIndex:
    def __init__(self):
        # per node (graph index):
        self.node_chain = None        # chain id owning the node
        self.node_link = None         # link index within the chain
        self.node_fwd = None          # chain traverses node forward?
        # per chain:
        self.chain_parent_snarl = None   # snarl id or -1
        self.chain_start = None          # coord array offsets
        self.link_coord = None        # flat: coord of each link's start
        # per snarl: distances from (start boundary inner side) and
        # (end boundary inner side) to each child chain's two ends
        self.snarl_chain = None       # chain id the snarl lives in
        self.snarl_link = None        # link index (snarl sits after it)
        self.snarl_through = None     # min start->end through distance
        # per chain: distance from parent snarl's boundaries to this
        # chain's two endpoints (4 values: ss, se, es, ee)
        self.chain_attach = None

    # ------------------------------------------------------------- build

    @classmethod
    def build(cls, g: ArrayGraph,
              dec: Optional[SnarlDecomposition] = None,
              snarl_search_cap: int = 200_000) -> "DistanceIndex":
        if dec is None:
            dec = decompose(g)
        self = cls()
        n = g.node_count
        n_chains = len(dec.chains)
        node_chain = np.full(n, -1, np.int64)
        node_link = np.zeros(n, np.int64)
        node_fwd = np.ones(n, bool)
        chain_parent = np.full(n_chains, -1, np.int64)
        chain_start = np.zeros(n_chains + 1, np.int64)
        snarl_through: Dict[int, int] = {}

        for ci, ch in enumerate(dec.chains):
            ps = ch.parent_snarl
            if ps >= 0 and dec.snarls[ps].start >= 0:
                chain_parent[ci] = ps
            for li, h in enumerate(ch.nodes):
                node_chain[h >> 1] = ci
                node_link[h >> 1] = li
                node_fwd[h >> 1] = not (h & 1)

        # snarl through-distances + boundary->content distances
        #   dist from the inner side of the start boundary (i.e. entering
        #   the snarl through `start`) to each content handle's start
        self._content_dist: Dict[int, Dict[int, int]] = {}
        self._content_dist_end: Dict[int, Dict[int, int]] = {}
        snarl_of_interest = dec.real_snarls()
        for si in snarl_of_interest:
            sn = dec.snarls[si]
            content = set(dec.snarl_contents(si))
            allowed = content | {sn.start >> 1, sn.end >> 1}
            d_start = _bounded_dijkstra_in(g, sn.start, allowed,
                                           snarl_search_cap)
            d_end = _bounded_dijkstra_in(g, sn.end ^ 1, allowed,
                                         snarl_search_cap)
            self._content_dist[si] = d_start
            self._content_dist_end[si] = d_end
            thr = d_start.get(sn.end, None)
            snarl_through[si] = (int(thr) if thr is not None else int(INF))

        # chain coordinates: coord of link i's START, walking the chain.
        # A snarl with no through-path breaks the chain's walkable line:
        # links get a "run" id and coordinates only compare within a run.
        link_coord_parts: List[np.ndarray] = []
        link_run_parts: List[np.ndarray] = []
        for ci, ch in enumerate(dec.chains):
            coords = np.zeros(len(ch.nodes), np.int64)
            runs = np.zeros(len(ch.nodes), np.int64)
            c = 0
            run = 0
            for li in range(len(ch.nodes)):
                coords[li] = c
                runs[li] = run
                h = ch.nodes[li]
                c += g.handle_len(h)
                if li < len(ch.snarls):
                    si = ch.snarls[li]
                    thr = snarl_through.get(si, 0)
                    # adjacent links (trivial snarl with direct edge):
                    # through distance 0; else the snarl's min
                    if dec.snarls[si].start >= 0:
                        nxt = ch.nodes[li + 1] if li + 1 < len(ch.nodes) \
                            else None
                        if nxt is not None and g.has_edge(h, nxt):
                            thr = 0
                        if thr >= INF:
                            run += 1       # broken line: new run
                            c = 0
                        else:
                            c += int(thr)
            chain_start[ci + 1] = chain_start[ci] + len(coords)
            link_coord_parts.append(coords)
            link_run_parts.append(runs)

        self.node_chain = node_chain
        self.node_link = node_link
        self.node_fwd = node_fwd
        self.chain_parent_snarl = chain_parent
        self.chain_start = chain_start
        self.link_coord = (np.concatenate(link_coord_parts)
                           if link_coord_parts else np.zeros(0, np.int64))
        self.link_run = (np.concatenate(link_run_parts)
                         if link_run_parts else np.zeros(0, np.int64))
        sn_chain = np.full(len(dec.snarls), -1, np.int64)
        sn_link = np.zeros(len(dec.snarls), np.int64)
        for ci, ch in enumerate(dec.chains):
            for li, si in enumerate(ch.snarls):
                sn_chain[si] = ci
                sn_link[si] = li
        self.snarl_chain = sn_chain
        self.snarl_link = sn_link
        self.snarl_through = np.array(
            [snarl_through.get(si, 0) for si in range(len(dec.snarls))],
            np.int64)
        self._dec = dec
        self._graph = g
        return self

    # ------------------------------------------------------------ queries

    def _lift_to_chain(self, nid_idx: int, off: int,
                       max_frames: int = 64):
        """All ((chain id, run id), anchor, detour) frames of a position:
        `anchor` is a base coordinate ON the chain's walkable line (a run
        is a maximal walkable stretch), `detour` the walk distance from
        that base to the position's base. For two positions sharing a
        frame, |anchorA - anchorB| + detourA + detourB is an achievable
        walk — the admissible bound. Climbing out of a snarl collapses a
        position to the boundary base with the detour absorbed."""
        g = self._graph
        dec = self._dec
        ci = int(self.node_chain[nid_idx])
        if ci < 0:
            return []
        li = int(self.node_link[nid_idx])
        cs = int(self.chain_start[ci])
        base = int(self.link_coord[cs + li])
        run = int(self.link_run[cs + li])
        if self.node_fwd[nid_idx]:
            anchor = base + off
        else:
            anchor = base + (int(g.node_len_idx(nid_idx)) - 1 - off)
        # dir: line direction the detour leaves its anchor with
        # (+1 forward, -1 backward, 0 = empty detour / either)
        frontier = [(ci, run, anchor, 0, 0)]
        out = []
        while frontier and len(out) < max_frames:
            ci, run, anchor, detour, ddir = frontier.pop()
            out.append(((ci, run), anchor, detour, ddir))
            ps = int(self.chain_parent_snarl[ci])
            if ps < 0:
                continue
            pci = int(self.snarl_chain[ps])
            if pci < 0:
                continue
            ch = dec.chains[ci]
            cs = int(self.chain_start[ci])
            n_links = len(ch.nodes)
            first_run = int(self.link_run[cs])
            last_run = int(self.link_run[cs + n_links - 1])
            h0 = ch.nodes[0]
            hl = ch.nodes[-1]
            ds = self._content_dist.get(ps, {})
            de = self._content_dist_end.get(ps, {})
            pcs = int(self.chain_start[pci])
            pli = int(self.snarl_link[ps])
            pch = dec.chains[pci]
            # via the snarl's start boundary: walk position -> child
            # chain start (needs same run) -> boundary's last base
            if run == first_run:
                via_start = ds.get(h0, None)
                if via_start is not None:
                    pbase = int(self.link_coord[pcs + pli])
                    blen = g.handle_len(pch.nodes[pli])
                    frontier.append((
                        pci, int(self.link_run[pcs + pli]),
                        pbase + blen - 1,
                        detour + anchor + 1 + via_start, +1))
            # via the end boundary: walk position -> child chain end ->
            # end boundary's first base
            if run == last_run and pli + 1 < len(pch.nodes):
                via_end = de.get(hl ^ 1, None)
                if via_end is not None:
                    chain_len = int(self.link_coord[cs + n_links - 1]) \
                        + g.handle_len(hl)
                    ebase = int(self.link_coord[pcs + pli + 1])
                    frontier.append((
                        pci, int(self.link_run[pcs + pli + 1]),
                        ebase,
                        detour + (chain_len - 1 - anchor) + 1 + via_end,
                        -1))
        return out

    def upper_bound(self, a: Position, b: Position) -> Optional[int]:
        """Admissible upper bound on min graph distance a -> b (offset
        semantics as graph/distance.min_distance); None if the frames
        never meet."""
        g = self._graph
        if not (g.has_node(a[0]) and g.has_node(b[0])):
            return None
        ia = g.idx(a[0])
        ib = g.idx(b[0])
        ca: Dict = {}
        for frame, anchor, detour, ddir in self._lift_to_chain(ia, a[1]):
            ca.setdefault(frame, []).append((anchor, detour, ddir))
        best = None
        for frame, anchor_b, detour_b, dir_b in self._lift_to_chain(
                ib, b[1]):
            for anchor_a, detour_a, dir_a in ca.get(frame, ()):
                # the combined walk runs B -> anchorB -> anchorA -> A:
                # reversing B's detour arrives at anchorB facing -dir_b,
                # the line hop needs s = sign(anchorA - anchorB), and
                # entering A's detour needs facing dir_a (0 = either)
                s = (anchor_a > anchor_b) - (anchor_a < anchor_b)
                if s != 0:
                    if dir_b != 0 and -dir_b != s:
                        continue
                    if dir_a != 0 and dir_a != s:
                        continue
                else:
                    if dir_a != 0 and dir_b != 0 and dir_a != -dir_b:
                        continue
                d = abs(anchor_b - anchor_a) + detour_a + detour_b
                if best is None or d < best:
                    best = d
        return best

    def within(self, a: Position, b: Position, limit: int) -> bool:
        """Is the ORIENTATION-FREE min distance between the two bases
        <= limit? (min over both walk directions and both node
        orientations — chain frames are undirected lines, so this is the
        relaxation the bound naturally answers; for the gamcompare
        correctness question "did the read land near the truth?" it is
        the right measure, like the refpos flavor which also ignores
        orientation.) The bound confirms most true positives without
        search; bounded Dijkstra decides the rest exactly."""
        ub1 = self.upper_bound(a, b)
        if ub1 is not None and ub1 <= limit:
            return True
        g = self._graph
        for (x, y) in _orientation_combos(g, a, b):
            d = dijkstra_min_distance(g, x, y, limit=limit)
            if d is not None and d <= limit:
                return True
        return False

    # ------------------------------------------------------- serialization

    def save(self, path: str) -> None:
        cd_keys, cd_vals = _flatten_dist(self._content_dist)
        ce_keys, ce_vals = _flatten_dist(self._content_dist_end)
        np.savez_compressed(
            path, node_chain=self.node_chain, node_link=self.node_link,
            node_fwd=self.node_fwd,
            chain_parent_snarl=self.chain_parent_snarl,
            chain_start=self.chain_start, link_coord=self.link_coord,
            link_run=self.link_run,
            snarl_chain=self.snarl_chain, snarl_link=self.snarl_link,
            snarl_through=self.snarl_through,
            cd_keys=cd_keys, cd_vals=cd_vals,
            ce_keys=ce_keys, ce_vals=ce_vals,
            chain_nodes=np.array(
                [h for ch in self._dec.chains for h in ch.nodes], np.int64),
            chain_nodes_start=np.cumsum(
                [0] + [len(ch.nodes) for ch in self._dec.chains]),
            chain_snarls=np.array(
                [s for ch in self._dec.chains for s in ch.snarls], np.int64),
            chain_snarls_start=np.cumsum(
                [0] + [len(ch.snarls) for ch in self._dec.chains]),
            snarl_bounds=np.array(
                [[s.start, s.end] for s in self._dec.snarls]
                if self._dec.snarls else np.zeros((0, 2)), np.int64))

    @classmethod
    def load(cls, path: str, g: ArrayGraph) -> "DistanceIndex":
        z = np.load(path)
        self = cls()
        for k in ("node_chain", "node_link", "node_fwd",
                  "chain_parent_snarl", "chain_start", "link_coord",
                  "link_run", "snarl_chain", "snarl_link",
                  "snarl_through"):
            setattr(self, k, z[k])
        self._graph = g
        # reconstruct the minimal decomposition view used by queries
        dec = SnarlDecomposition(g)
        from .cactus import CChain, CSnarl

        cns, cns_s = z["chain_nodes"], z["chain_nodes_start"]
        csn, csn_s = z["chain_snarls"], z["chain_snarls_start"]
        for ci in range(len(cns_s) - 1):
            dec.chains.append(CChain(
                nodes=[int(h) for h in cns[cns_s[ci]:cns_s[ci + 1]]],
                snarls=[int(s) for s in csn[csn_s[ci]:csn_s[ci + 1]]],
                parent_snarl=int(self.chain_parent_snarl[ci])))
        for (st, en) in z["snarl_bounds"]:
            dec.snarls.append(CSnarl(start=int(st), end=int(en), chain=-1))
        self._dec = dec
        self._content_dist = _unflatten_dist(z["cd_keys"], z["cd_vals"])
        self._content_dist_end = _unflatten_dist(z["ce_keys"], z["ce_vals"])
        return self


def _orientation_combos(g: ArrayGraph, a: Position, b: Position):
    """All 8 (direction, orientation) variants of walking base a<->b."""
    def flips(p):
        nid, off, rev = p
        ln = g.node_len(nid)
        return [(nid, off, rev), (nid, ln - 1 - off, not rev)]

    for x in flips(a):
        for y in flips(b):
            yield (x, y)
            yield (y, x)


def _flatten_dist(d: Dict[int, Dict[int, int]]):
    keys, vals = [], []
    for si, m in d.items():
        for h, dist in m.items():
            keys.append((si, h))
            vals.append(dist)
    return (np.array(keys, np.int64).reshape(-1, 2),
            np.array(vals, np.int64))


def _unflatten_dist(keys, vals):
    out: Dict[int, Dict[int, int]] = {}
    for (si, h), v in zip(keys, vals):
        out.setdefault(int(si), {})[int(h)] = int(v)
    return out


def _bounded_dijkstra_in(g: ArrayGraph, from_handle: int, allowed_nodes,
                         cap: int) -> Dict[int, int]:
    """Distances from the END of from_handle to the START of each handle,
    restricted to the allowed node set (snarl content + boundaries)."""
    out: Dict[int, int] = {}
    start_len = 0
    pq = [(0, int(c)) for c in g.follow(from_handle)
          if (int(c) >> 1) in allowed_nodes]
    heapq.heapify(pq)
    steps = 0
    while pq and steps < cap:
        steps += 1
        d, h = heapq.heappop(pq)
        if h in out and out[h] <= d:
            continue
        out[h] = d
        nlen = g.handle_len(h)
        for c in g.follow(h):
            c = int(c)
            if (c >> 1) in allowed_nodes and (c not in out
                                              or out[c] > d + nlen):
                heapq.heappush(pq, (d + nlen, c))
    return out
