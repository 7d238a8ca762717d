"""Transcriptome projection (vg rna).

Reference: Transcriptome (src/transcriptome.cpp, SURVEY.md §2.1) projects
GTF/GFF transcripts onto the graph as paths — chopping nodes at exon
boundaries — and can emit haplotype-specific transcripts and a
pantranscriptome for rpvg. This implementation covers reference
transcripts: node chopping via graph.ops.split_nodes, one embedded path
per transcript (reverse-strand transcripts walk flipped handles), plus
transcript FASTA and the info table (vg rna -n equivalent).

Copied from vg_tpu/rna/transcriptome.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from ..graph.arraygraph import SENSE_GENERIC, ArrayGraph, GraphBuilder
from ..graph.ops import split_nodes
from ..io.gtf import Transcript
from ..utils import dna


@dataclass
class ProjectedTranscript:
    transcript_id: str
    path_name: str
    length: int
    n_exons: int
    strand: str


@dataclass
class HaplotypeTranscript:
    """One collapsed haplotype-specific transcript (pantranscriptome row:
    distinct walk + the haplotypes that spell it)."""
    transcript_id: str
    path_name: str
    strand: str
    haplotypes: List[str]
    steps: List[Tuple[int, bool]]


class Transcriptome:
    def __init__(self, graph: ArrayGraph):
        self.graph = graph

    def project(self, transcripts: Sequence[Transcript]
                ) -> Tuple[ArrayGraph, List[ProjectedTranscript]]:
        g = self.graph
        # 1. collect exon-boundary cuts per node along each chromosome path
        cuts: Dict[int, set] = {}
        per_chrom: Dict[str, List[Transcript]] = {}
        for t in transcripts:
            if not g.has_path(t.chrom):
                continue
            per_chrom.setdefault(t.chrom, []).append(t)
        step_cache = {}
        for chrom, ts in per_chrom.items():
            pi = g.path_index(chrom)
            hs = g.path_handles(pi)
            offs = g.path_step_offsets(pi)
            step_cache[chrom] = (hs, offs)
            import numpy as np

            for t in ts:
                for s, e in t.exons:
                    for bp in (s, e):
                        si = int(np.searchsorted(offs[1:], bp, side="right"))
                        if si >= len(hs):
                            continue
                        h = int(hs[si])
                        within = bp - int(offs[si])
                        nlen = int(offs[si + 1] - offs[si])
                        if 0 < within < nlen:
                            fwd_off = within if not (h & 1) else nlen - within
                            cuts.setdefault(int(g.node_id[h >> 1]),
                                            set()).add(fwd_off)
        g2, pieces = split_nodes(g, {k: sorted(v) for k, v in cuts.items()})
        self._pieces = pieces
        self._exon_walks: Dict[str, Tuple[List[List[Tuple[int, bool]]], str]] = {}

        # 2. walk each transcript's exons along the chopped path
        b_paths: List[ProjectedTranscript] = []
        builder_steps: Dict[str, List[Tuple[int, bool]]] = {}
        for chrom, ts in per_chrom.items():
            pi2 = g2.path_index(chrom)
            hs2 = g2.path_handles(pi2)
            offs2 = g2.path_step_offsets(pi2)
            import numpy as np

            for t in ts:
                steps: List[Tuple[int, bool]] = []
                exon_walks: List[List[Tuple[int, bool]]] = []
                ok = True
                length = 0
                for s, e in t.exons:
                    i0 = int(np.searchsorted(offs2[1:], s, side="right"))
                    cur = s
                    exon: List[Tuple[int, bool]] = []
                    while cur < e and i0 < len(hs2):
                        if int(offs2[i0]) != cur:
                            ok = False
                            break
                        h = int(hs2[i0])
                        exon.append((int(g2.node_id[h >> 1]), bool(h & 1)))
                        cur = int(offs2[i0 + 1])
                        i0 += 1
                    steps.extend(exon)
                    exon_walks.append(exon)
                    length += e - s
                    if not ok:
                        break
                if not ok or not steps:
                    continue
                self._exon_walks[t.transcript_id] = (exon_walks, t.strand)
                if t.strand == "-":
                    steps = [(nid, not rev) for nid, rev in reversed(steps)]
                builder_steps[t.transcript_id] = steps
                b_paths.append(ProjectedTranscript(
                    transcript_id=t.transcript_id,
                    path_name=t.transcript_id, length=length,
                    n_exons=len(t.exons), strand=t.strand))

        # 3. rebuild with transcript paths embedded
        b = GraphBuilder()
        for i, nid in enumerate(g2.node_id):
            b.add_node(g2.seq[g2.seq_start[i] : g2.seq_start[i + 1]],
                       node_id=int(nid))
        for f_id, f_rev, t_id, t_rev in g2.iter_edges():
            b.add_edge(f_id, t_id, f_rev, t_rev)
        for pi3, meta in enumerate(g2.path_meta):
            steps = [(int(g2.node_id[int(h) >> 1]), bool(int(h) & 1))
                     for h in g2.path_handles(pi3)]
            b.add_path(meta.name, steps, meta.sense, meta.sample,
                       meta.locus, meta.haplotype, meta.is_circular)
        for pt in b_paths:
            steps = builder_steps[pt.transcript_id]
            # splice-junction edges between consecutive exons (vg rna adds
            # novel splice edges to the graph, src/transcriptome.cpp)
            for (n1, r1), (n2, r2) in zip(steps[:-1], steps[1:]):
                b.add_edge(n1, n2, r1, r2)
            b.add_path(pt.path_name, steps, SENSE_GENERIC,
                       locus=pt.transcript_id)
        g3 = b.freeze()
        return g3, b_paths

    def project_haplotypes(self, transcripts: Sequence[Transcript], haps
                           ) -> Tuple[ArrayGraph,
                                      List["HaplotypeTranscript"]]:
        """Haplotype-specific transcripts / pantranscriptome (reference:
        Transcriptome::project_transcripts with -l GBWT haplotypes,
        src/transcriptome.cpp — there a GBWT walk per transcript region;
        here each haplotype walk is translated onto the exon-chopped graph
        and sliced between the exons' boundary anchor nodes, so variant
        alleles inside exons follow the haplotype).

        Identical walks collapse into one embedded path carrying the list
        of source haplotypes (the pantranscriptome's collapsed paths,
        vg rna -n info table). Returns (graph with all transcript paths,
        haplotype transcript records)."""
        from ..graph.ops import _builder_from

        g3, ref_projs = self.project(transcripts)
        self._last_projected = ref_projs
        ref_names = {p.transcript_id for p in ref_projs}

        # translate haplotype walks onto the chopped graph, index occurrences
        hap_walks: List[List[Tuple[int, bool]]] = []
        hap_occ: List[Dict[int, List[int]]] = []
        for k in range(haps.count):
            s0, s1 = int(haps.steps_start[k]), int(haps.steps_start[k + 1])
            walk: List[Tuple[int, bool]] = []
            for h in haps.steps[s0:s1]:
                h = int(h)
                nid, rev = int(self.graph.node_id[h >> 1]), bool(h & 1)
                parts = self._pieces.get(nid, [(nid, 0)])
                if rev:
                    parts = list(reversed(parts))
                walk.extend((p, rev) for p, _ in parts)
            occ: Dict[int, List[int]] = {}
            for i, (nid, _) in enumerate(walk):
                occ.setdefault(nid, []).append(i)
            hap_walks.append(walk)
            hap_occ.append(occ)

        collapsed: Dict[Tuple, "HaplotypeTranscript"] = {}
        for t in transcripts:
            if t.transcript_id not in ref_names or \
                    t.transcript_id not in self._exon_walks:
                continue
            exon_walks, strand = self._exon_walks[t.transcript_id]
            for k in range(haps.count):
                walk, occ = hap_walks[k], hap_occ[k]
                steps: List[Tuple[int, bool]] = []
                cursor = 0
                ok = True
                for exon in exon_walks:
                    # first/last exon nodes present in this haplotype
                    # anchor the haplotype-specific exon sub-walk
                    i_start = i_end = None
                    for nid, _ in exon:
                        sites = [i for i in occ.get(nid, ()) if i >= cursor]
                        if sites:
                            i_start = sites[0]
                            break
                    for nid, _ in reversed(exon):
                        sites = [i for i in occ.get(nid, ())
                                 if i_start is not None and i >= i_start]
                        if sites:
                            i_end = sites[0]
                            break
                    if i_start is None or i_end is None:
                        ok = False   # exon fully deleted in this haplotype
                        break
                    steps.extend(walk[i_start : i_end + 1])
                    cursor = i_end + 1
                if not ok or not steps:
                    continue
                if strand == "-":
                    steps = [(nid, not rev) for nid, rev in reversed(steps)]
                key = (t.transcript_id, tuple(steps))
                if key in collapsed:
                    collapsed[key].haplotypes.append(haps.metas[k].name)
                else:
                    collapsed[key] = HaplotypeTranscript(
                        transcript_id=t.transcript_id,
                        path_name="", strand=strand,
                        haplotypes=[haps.metas[k].name], steps=steps)

        # embed collapsed haplotype transcripts (skip ones identical to the
        # reference transcript path, which project() already embedded);
        # _builder_from carries over g3's nodes, edges and paths
        b = _builder_from(g3)
        ref_steps = {pid: [(int(g3.node_id[int(h) >> 1]), bool(int(h) & 1))
                           for h in g3.path_handles(g3.path_index(pid))]
                     for pid in ref_names}
        out: List[HaplotypeTranscript] = []
        counters: Dict[str, int] = {}
        for (tid, _), ht in collapsed.items():
            if ht.steps == ref_steps.get(tid):
                continue
            counters[tid] = counters.get(tid, 0) + 1
            ht.path_name = f"{tid}_H{counters[tid]}"
            for (n1, r1), (n2, r2) in zip(ht.steps[:-1], ht.steps[1:]):
                b.add_edge(n1, n2, r1, r2)   # splice junctions (novel ok)
            b.add_path(ht.path_name, ht.steps, SENSE_GENERIC, locus=tid)
            out.append(ht)
        return b.freeze(), out

    @staticmethod
    def pantranscriptome_haplotypes(g: ArrayGraph,
                                    projected: Sequence[ProjectedTranscript],
                                    hap_ts: Sequence["HaplotypeTranscript"]
                                    = ()):
        """Index the transcript paths (reference + haplotype-specific) as
        the haplotype text for RNA read mapping. This is the TPU-native
        answer to mpmap's spliced multipath alignment (reference
        src/multipath_mapper.cpp splice handling): introns are absent from
        transcript texts, so a junction-spanning read aligns contiguously
        and its graph projection crosses the splice edge."""
        import numpy as np

        from ..index.haplotypes import HaplotypeMeta, HaplotypeSet

        metas, walks = [], []
        for name in ([p.path_name for p in projected]
                     + [h.path_name for h in hap_ts]):
            hs = g.path_handles(g.path_index(name))
            if len(hs) == 0:
                continue
            metas.append(HaplotypeMeta(name=name, contig=name))
            walks.append(np.asarray(hs, dtype=np.int64))
        return HaplotypeSet(g, metas, walks)

    @staticmethod
    def transcript_fasta(g: ArrayGraph,
                         projected: Sequence[ProjectedTranscript]) -> str:
        out = []
        for pt in projected:
            seq = g.path_seq(pt.path_name)
            out.append(f">{pt.transcript_id}")
            for i in range(0, len(seq), 80):
                out.append(seq[i : i + 80])
        return "\n".join(out) + "\n"
