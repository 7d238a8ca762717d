"""Pack: per-base and per-edge coverage from alignments.

Reference: Packer (src/packer.hpp:25-178) shards atomic counters across
mutex-guarded bins and serializes sdsl vectors. Here coverage is two dense
arrays (per graph base, per edge) filled with vectorized scatter-adds —
the multi-thread merge becomes a single np.add.at per batch (and a psum
across device shards in the multi-host path, SURVEY.md §2.3 item 4).

Copied from vg_tpu/call/pack.py.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from ..graph.arraygraph import ArrayGraph, canonical_edge
from ..io.gam import Alignment


class Packer:
    def __init__(self, graph: ArrayGraph):
        self.graph = graph
        self.base_coverage = np.zeros(graph.total_seq_len, dtype=np.int32)
        self.edge_coverage = np.zeros(graph.edge_count, dtype=np.int32)
        self._edge_index: Dict[Tuple[int, int], int] = {
            (int(a), int(b)): i for i, (a, b) in enumerate(graph.edge_pairs)}
        self.n_alignments = 0

    # -- filling ------------------------------------------------------------

    def add(self, aln: Alignment) -> None:
        self.add_batch([aln])

    def add_batch(self, alns: Iterable[Alignment]) -> None:
        g = self.graph
        starts: List[int] = []
        ends: List[int] = []
        edge_ids: List[int] = []
        for aln in alns:
            if aln.path is None or not aln.path.mappings:
                continue
            self.n_alignments += 1
            prev_handle = None
            for mp in aln.path.mappings:
                p = mp.position
                idx = g.idx(p.node_id)
                nlen = int(g.seq_start[idx + 1] - g.seq_start[idx])
                handle = idx * 2 + int(p.is_reverse)
                # covered interval on the node in *forward node coords*
                from_len = sum(e.from_length for e in mp.edits)
                if from_len > 0:
                    if p.is_reverse:
                        a = nlen - p.offset - from_len
                        b = nlen - p.offset
                    else:
                        a = p.offset
                        b = p.offset + from_len
                    base = int(g.seq_start[idx])
                    starts.append(base + max(0, a))
                    ends.append(base + min(nlen, b))
                if prev_handle is not None:
                    e = canonical_edge(prev_handle, handle)
                    ei = self._edge_index.get(e)
                    if ei is not None:
                        edge_ids.append(ei)
                prev_handle = handle
        if starts:
            # interval scatter-add via diff trick
            diff = np.zeros(len(self.base_coverage) + 1, dtype=np.int32)
            np.add.at(diff, np.asarray(starts), 1)
            np.add.at(diff, np.asarray(ends), -1)
            self.base_coverage += np.cumsum(diff[:-1]).astype(np.int32)
        if edge_ids:
            np.add.at(self.edge_coverage, np.asarray(edge_ids), 1)
        self._node_avg_all = None   # invalidate the cached per-node means

    # -- queries -------------------------------------------------------------

    def node_coverage(self, node_id: int) -> np.ndarray:
        g = self.graph
        i = g.idx(node_id)
        return self.base_coverage[g.seq_start[i] : g.seq_start[i + 1]]

    def node_avg(self, node_id: int) -> float:
        c = self.node_coverage(node_id)
        return float(c.mean()) if len(c) else 0.0

    def node_avg_all(self) -> np.ndarray:
        """(n_nodes,) mean base coverage per node index, computed once for
        the whole graph (the vectorized form the snarl-calling loop reads —
        the reference parallelizes per-snarl support with OpenMP,
        src/graph_caller.cpp; here the heavy reduction is one reduceat)."""
        if getattr(self, "_node_avg_all", None) is None:
            g = self.graph
            if len(self.base_coverage) == 0 or g.node_count == 0:
                self._node_avg_all = np.zeros(g.node_count)
            else:
                sums = np.add.reduceat(
                    self.base_coverage.astype(np.int64), g.seq_start[:-1])
                lens = np.maximum(np.diff(g.seq_start), 1)
                self._node_avg_all = sums / lens
        return self._node_avg_all

    def node_min(self, node_id: int) -> float:
        c = self.node_coverage(node_id)
        return float(c.min()) if len(c) else 0.0

    def edge_support(self, h1: int, h2: int) -> int:
        ei = self._edge_index.get(canonical_edge(h1, h2))
        return int(self.edge_coverage[ei]) if ei is not None else 0

    def mean_coverage(self, path_name_or_idx=None) -> float:
        """Genome-wide (or path-restricted) average depth — the caller's
        expected-depth baseline (reference: Packers avg depth use in
        call_main.cpp:852)."""
        if path_name_or_idx is None:
            return float(self.base_coverage.mean()) if len(self.base_coverage) else 0.0
        g = self.graph
        hs = g.path_handles(path_name_or_idx)
        tot = 0.0
        n = 0
        for h in hs:
            i = int(h) >> 1
            c = self.base_coverage[g.seq_start[i] : g.seq_start[i + 1]]
            tot += float(c.sum())
            n += len(c)
        return tot / n if n else 0.0

    # -- serialization --------------------------------------------------------

    def save(self, path: str) -> None:
        np.savez_compressed(path, base=self.base_coverage,
                            edge=self.edge_coverage,
                            n=np.array([self.n_alignments]))

    @classmethod
    def load(cls, graph: ArrayGraph, path: str) -> "Packer":
        import os

        self = cls(graph)
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path += ".npz"  # np.savez appends .npz to extensionless names
        data = np.load(path)
        self.base_coverage = data["base"].astype(np.int32)
        self.edge_coverage = data["edge"].astype(np.int32)
        self.n_alignments = int(data["n"][0])
        return self

    def as_table(self) -> Iterable[Tuple[int, int, int]]:
        """(node_id, offset, coverage) rows — vg pack -d equivalent."""
        g = self.graph
        for i, nid in enumerate(g.node_id):
            for off, c in enumerate(
                    self.base_coverage[g.seq_start[i] : g.seq_start[i + 1]]):
                yield int(nid), off, int(c)
