"""Inject: SAM/BAM records -> GAM against the embedded reference paths.

Reference: vg inject (src/subcommand/inject_main.cpp) lifts linear
alignments onto the graph by walking the reference path and splitting
the CIGAR at node boundaries — the inverse of surjection.

Copied from vg_tpu/map/inject.py.
"""
from __future__ import annotations

from typing import Iterable, List

from ..graph.arraygraph import ArrayGraph
from ..io.gam import Alignment, Edit, Mapping, Path, Position
from ..io.sam import FLAG_REVERSE, FLAG_UNMAPPED, SamRecord, cigar_ops
from ..map.project import reverse_complement_path
from ..utils import dna


class Injector:
    def __init__(self, graph: ArrayGraph):
        self.graph = graph
        self._paths = {}
        for m in graph.path_meta:
            pi = graph.path_index(m.name)
            self._paths[m.name] = (graph.path_handles(pi),
                                   graph.path_step_offsets(pi))

    def inject(self, rec: SamRecord) -> Alignment:
        aln = Alignment(name=rec.qname)
        seq = rec.seq if rec.seq != "*" else ""
        is_rev = bool(rec.flag & FLAG_REVERSE)
        aln.sequence = dna.revcomp_str(seq) if is_rev else seq
        if rec.qual != "*":
            q = bytes(ord(c) - 33 for c in rec.qual)
            aln.quality = q[::-1] if is_rev else q
        aln.mapping_quality = rec.mapq
        if (rec.flag & FLAG_UNMAPPED) or rec.rname == "*" \
                or rec.rname not in self._paths:
            return aln
        handles, offs = self._paths[rec.rname]
        g = self.graph

        # locate starting step
        import numpy as np

        pos0 = rec.pos - 1
        si = int(np.searchsorted(offs[1:], pos0, side="right"))
        path = Path()
        cur = None
        read_i = 0

        def open_mapping(si, off_in_step):
            h = int(handles[si])
            return Mapping(position=Position(
                node_id=int(g.node_id[h >> 1]), offset=int(off_in_step),
                is_reverse=bool(h & 1)))

        step_off = pos0 - int(offs[si])
        cur = open_mapping(si, step_off)
        read_seq = rec.seq

        def step_len(si):
            return int(offs[si + 1] - offs[si])

        for op, n in cigar_ops(rec.cigar):
            if op in ("S", "I"):
                cur.edits.append(Edit(from_length=0, to_length=n,
                                      sequence=read_seq[read_i : read_i + n]))
                read_i += n
            elif op in ("M", "=", "X", "D", "N"):
                consume_read = op in ("M", "=", "X")
                left = n
                while left > 0:
                    room = step_len(si) - step_off
                    if room == 0:
                        path.mappings.append(cur)
                        si += 1
                        step_off = 0
                        cur = open_mapping(si, 0)
                        room = step_len(si)
                    take = min(left, room)
                    if consume_read:
                        cur.edits.append(Edit(from_length=take,
                                              to_length=take))
                        read_i += take
                    else:
                        cur.edits.append(Edit(from_length=take, to_length=0))
                    step_off += take
                    left -= take
            elif op == "H":
                pass
        path.mappings.append(cur)
        if is_rev:
            path = reverse_complement_path(g, path)
        for rank, mp in enumerate(path.mappings, 1):
            mp.rank = rank
        aln.path = path
        aln.score = sum(e.from_length for mp in path.mappings
                        for e in mp.edits if e.from_length == e.to_length)
        return aln

    def inject_all(self, recs: Iterable[SamRecord]) -> List[Alignment]:
        return [self.inject(r) for r in recs]
