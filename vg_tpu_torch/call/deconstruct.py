"""Deconstruct: graph + haplotypes -> VCF of all embedded variation.

Reference: Deconstructor (src/deconstructor.cpp, SURVEY.md §2.1) walks
snarls along a reference path, enumerates each sample haplotype's
traversal through the snarl, clusters alleles, and emits phased VCF —
the HPRC pipeline's graph->VCF step.

Here haplotype traversals come straight from the HaplotypeSet's walks
(the GBWT role): per snarl we slice each haplotype's handle walk between
the boundary handles, so allele extraction is an index lookup, not a
graph search.

Copied from vg_tpu/call/deconstruct.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..graph.arraygraph import ArrayGraph
from ..graph.snarls import Snarl, snarls_along_path
from ..index.haplotypes import HaplotypeSet


@dataclass
class DeconstructedVariant:
    chrom: str
    pos: int                   # 1-based, anchored
    ref: str
    alts: List[str]
    sample_gts: Dict[str, List[Optional[int]]]   # sample -> allele per phase

    def vcf_line(self, samples: Sequence[str]) -> str:
        cols = [self.chrom, str(self.pos), ".", self.ref,
                ",".join(self.alts) or ".", "60", "PASS", ".", "GT"]
        for s in samples:
            gt = self.sample_gts.get(s)
            if gt is None:
                cols.append(".")
            else:
                cols.append("|".join("." if a is None else str(a) for a in gt))
        return "\t".join(cols)


class Deconstructor:
    def __init__(self, graph: ArrayGraph, haps: HaplotypeSet, ref_path: str):
        self.graph = graph
        self.haps = haps
        self.ref_path = ref_path
        pi = graph.path_index(ref_path)
        self.ref_handles = [int(h) for h in graph.path_handles(pi)]
        offs = graph.path_step_offsets(pi)
        self.ref_offset = {h: int(offs[i])
                           for i, h in enumerate(self.ref_handles)}
        # per-haplotype: handle -> step index (first occurrence)
        self._hap_pos: List[Dict[int, int]] = []
        for h in range(haps.count):
            s0, s1 = int(haps.steps_start[h]), int(haps.steps_start[h + 1])
            d: Dict[int, int] = {}
            for si in range(s0, s1):
                hd = int(haps.steps[si])
                if hd not in d:
                    d[hd] = si
            self._hap_pos.append(d)

    def _hap_allele(self, hap: int, sn: Snarl) -> Optional[str]:
        """Sequence this haplotype spells strictly inside the snarl, or
        None if it doesn't traverse it."""
        d = self._hap_pos[hap]
        si = d.get(sn.start)
        se = d.get(sn.end)
        if si is None or se is None or se < si:
            return None
        g = self.graph
        inner = self.haps.steps[si + 1 : se]
        return "".join(g.handle_seq(int(h)) for h in inner)

    def deconstruct(self) -> Tuple[List[str], List[DeconstructedVariant]]:
        g = self.graph
        samples = sorted({m.sample for m in self.haps.metas if m.sample})
        out: List[DeconstructedVariant] = []
        for sn in snarls_along_path(g, self.ref_path):
            start_off = self.ref_offset.get(sn.start)
            if start_off is None:
                continue
            ref_allele_seq = self._ref_between(sn)
            if ref_allele_seq is None:
                continue
            alleles: List[str] = [ref_allele_seq]
            sample_gts: Dict[str, List[Optional[int]]] = {}
            any_alt = False
            for hi, meta in enumerate(self.haps.metas):
                if not meta.sample:
                    continue
                seq = self._hap_allele(hi, sn)
                if seq is None:
                    a = None
                else:
                    if seq in alleles:
                        a = alleles.index(seq)
                    else:
                        alleles.append(seq)
                        a = len(alleles) - 1
                    if a > 0:
                        any_alt = True
                gts = sample_gts.setdefault(meta.sample, [])
                while len(gts) <= meta.phase:
                    gts.append(None)
                gts[meta.phase] = a
            if not any_alt:
                continue
            anchor = g.handle_seq(sn.start)[-1]
            anchor_off = start_off + g.node_len(
                int(g.node_id[sn.start >> 1])) - 1
            out.append(DeconstructedVariant(
                chrom=self.ref_path, pos=anchor_off + 1,
                ref=anchor + ref_allele_seq,
                alts=[anchor + a for a in alleles[1:]],
                sample_gts=sample_gts))
        out.sort(key=lambda v: v.pos)
        return samples, out

    def _ref_between(self, sn: Snarl) -> Optional[str]:
        try:
            i0 = self.ref_handles.index(sn.start)
        except ValueError:
            return None
        seq = []
        for h in self.ref_handles[i0 + 1 :]:
            if h == sn.end:
                return "".join(seq)
            seq.append(self.graph.handle_seq(h))
        return None

    def write_vcf(self, fileobj) -> None:
        samples, variants = self.deconstruct()
        clen = self.graph.path_len(self.ref_path)
        fileobj.write("##fileformat=VCFv4.2\n")
        fileobj.write(f"##contig=<ID={self.ref_path},length={clen}>\n")
        fileobj.write('##FORMAT=<ID=GT,Number=1,Type=String,'
                      'Description="Genotype">\n')
        fileobj.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                      + "\t".join(samples) + "\n")
        for v in variants:
            fileobj.write(v.vcf_line(samples) + "\n")
