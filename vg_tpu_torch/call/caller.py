"""Snarl-by-snarl genotyping -> VCF (vg pack + vg call equivalents).

Reference pipeline (SURVEY.md §3.5): FlowCaller +
GraphCaller::call_top_level_snarls (src/graph_caller.cpp:23-83) enumerates
traversals per snarl, a support-based SnarlCaller genotypes them, and
VCFOutputCaller emits sorted VCF. The genotype model here follows
PoissonSupportSnarlCaller (src/snarl_caller.cpp:195+): per-genotype
expected depths from the pack's average coverage, Poisson likelihood of
each allele's support, small error floor; GQ from the likelihood gap.

Batching note: genotype likelihoods per snarl are a handful of Poisson
terms; the host loop over snarls is cheap next to mapping. Snarl-parallel
batching onto device (segmented reductions over snarl-bucketed supports,
SURVEY.md §2.3 item 3) becomes worthwhile at whole-genome scale.

Copied from vg_tpu/call/caller.py.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..graph.arraygraph import ArrayGraph
from ..graph.snarls import Snarl, snarl_traversals, snarls_along_path
from ..utils import dna
from .pack import Packer


@dataclass
class CallParams:
    max_traversals: int = 32
    max_alleles: int = 6                  # genotyped alleles per site
    # allele enumerator: 'flow' = support-guided k-widest paths (vg call
    # default, FlowTraversalFinder); 'exhaustive' = capped DFS
    traversal_finder: str = "flow"
    max_snarl_nodes: int = 400            # descend into children above this
    min_allele_support: float = 1.0
    baseline_error_small: float = 0.005   # reference snarl_caller.cpp:469-486
    baseline_error_large: float = 0.01
    min_total_support_for_call: float = 2.0
    avg_support_switch_len: int = 50      # min->avg support switch
    max_gq: int = 256
    # binomial allele-balance filter (reference XADL,
    # snarl_caller.cpp:351-368): hets whose balance is this improbable
    # under Binomial(n, 0.5) get FILTER=lowad
    min_ad_log_likelihood: float = -9.0


@dataclass
class VariantCall:
    chrom: str
    pos: int                  # 1-based VCF position
    ref: str
    alts: List[str]
    genotype: Tuple[int, int]
    gq: int
    depth: float
    allele_supports: List[float]
    filter: str = "PASS"
    snarl: Optional[Tuple[int, int]] = None
    # handle walks of the emitted alleles (ref first), for -T GAF output
    traversals: Optional[List[List[int]]] = None

    def vcf_line(self, sample_done: bool = True) -> str:
        alt_s = ",".join(self.alts) if self.alts else "."
        gt = "/".join(str(a) for a in self.genotype)
        info = f"DP={int(round(self.depth))}"
        fmt = "GT:GQ:DP:AD"
        ad = ",".join(str(int(round(s))) for s in self.allele_supports)
        sample = f"{gt}:{self.gq}:{int(round(self.depth))}:{ad}"
        return "\t".join([
            self.chrom, str(self.pos), ".", self.ref, alt_s, str(self.gq),
            self.filter, info, fmt, sample])


def _log_binom(n: float, k: float) -> float:
    n, k = float(n), float(k)
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1))


def _log_poisson(k: float, lam: float) -> float:
    lam = max(lam, 1e-9)
    return k * math.log(lam) - lam - math.lgamma(k + 1.0)


class SnarlCaller:
    def __init__(self, graph: ArrayGraph, pack: Packer,
                 ref_path: str, params: Optional[CallParams] = None,
                 sample_name: str = "SAMPLE", haplotypes=None):
        self.graph = graph
        self.pack = pack
        self.ref_path = ref_path
        self.params = params or CallParams()
        self.sample_name = sample_name
        # when a HaplotypeSet is given, allele enumeration is restricted to
        # walks the haplotypes take (vg call -g / GBWTTraversalFinder role)
        self.haplotypes = haplotypes
        self.exp_depth = pack.mean_coverage(ref_path)
        # path offset of every step on the ref path
        pi = graph.path_index(ref_path)
        self.ref_handles = [int(h) for h in graph.path_handles(pi)]
        offs = graph.path_step_offsets(pi)
        self.ref_offset: Dict[int, int] = {
            h: int(offs[i]) for i, h in enumerate(self.ref_handles)}

    # -------------------------------------------------------------- support

    def traversal_support(self, walk: Sequence[int]) -> float:
        """Support of a traversal: min of node/edge supports for short
        alleles, average for long ones (reference
        get_average_traversal_support_switch_threshold,
        src/graph_caller.cpp:2452-2467)."""
        g = self.graph
        navg = self.pack.node_avg_all()   # vectorized once per pack state
        vals: List[float] = []
        length = 0
        for i, h in enumerate(walk):
            if 0 < i < len(walk) - 1:
                vals.append(float(navg[h >> 1]))
                length += g.node_len(int(g.node_id[h >> 1]))
            if i + 1 < len(walk):
                vals.append(float(self.pack.edge_support(h, int(walk[i + 1]))))
        if not vals:
            return 0.0
        if length >= self.params.avg_support_switch_len:
            return float(np.mean(vals))
        return float(np.min(vals))

    def walk_seq(self, walk: Sequence[int], include_ends: bool = False) -> str:
        g = self.graph
        inner = walk if include_ends else walk[1:-1]
        return "".join(g.handle_seq(int(h)) for h in inner)

    # ------------------------------------------------------------- genotype

    def genotype_snarl(self, sn: Snarl) -> Optional[VariantCall]:
        p = self.params
        g = self.graph
        if self.haplotypes is not None:
            from ..graph.snarls import haplotype_traversals
            travs = haplotype_traversals(self.haplotypes, sn,
                                         p.max_traversals)
        elif p.traversal_finder == "flow":
            # vg call default: support-guided k-widest-paths enumeration
            # (FlowTraversalFinder, reference traversal_finder.hpp:588 +
            # algorithms/k_widest_paths.cpp) — dense snarls surface the
            # alleles the reads take instead of the first max_traversals
            # walks the exhaustive finder happens to reach
            from ..graph.flowtrav import flow_traversals
            travs = flow_traversals(g, self.pack, sn, p.max_traversals,
                                    navg=self.pack.node_avg_all())
            if len(travs) < 2:   # no/flat coverage: exhaustive fallback
                travs = snarl_traversals(g, sn, p.max_traversals)
        else:
            travs = snarl_traversals(g, sn, p.max_traversals)
        start_off = self.ref_offset.get(sn.start)
        if start_off is None:
            return None
        ref_walk = self._ref_walk(sn)
        if ref_walk is None:
            return None
        # the reference traversal is always a candidate allele, even when
        # the enumeration cap dropped it (vg's PathTraversalFinder role)
        if ref_walk not in travs:
            travs.append(ref_walk)
        if len(travs) < 2:
            return None
        supports = [self.traversal_support(t) for t in travs]
        seqs = [self.walk_seq(t) for t in travs]
        ref_ti = travs.index(ref_walk)
        ref_between = seqs[ref_ti]

        # alleles: ref plus every traversal with real support, best first,
        # capped at max_alleles (the round-1 three-allele cap is gone)
        order = np.argsort(-np.asarray(supports))
        chosen: List[int] = [ref_ti]
        for a in order:
            a = int(a)
            if a == ref_ti:
                continue
            if supports[a] >= p.min_allele_support or len(chosen) < 2:
                chosen.append(a)
            if len(chosen) >= p.max_alleles:
                break
        alleles = sorted(set(chosen))
        total = sum(supports[a] for a in alleles)
        if total < p.min_total_support_for_call:
            return None

        # Poisson genotype likelihoods over unordered pairs of `alleles`
        d = max(self.exp_depth, 1e-3)
        err = (p.baseline_error_small
               if max(len(s) for s in seqs) < p.avg_support_switch_len
               else p.baseline_error_large)
        combos = []
        for i in range(len(alleles)):
            for j in range(i, len(alleles)):
                combos.append((alleles[i], alleles[j]))
        logliks = []
        for (a1, a2) in combos:
            ll = 0.0
            for a in set(alleles):
                copies = (a1 == a) + (a2 == a)
                lam = d / 2.0 * copies + err * d
                ll += _log_poisson(supports[a], lam)
            logliks.append(ll)
        bi = int(np.argmax(logliks))
        sorted_ll = sorted(logliks, reverse=True)
        gq = p.max_gq if len(sorted_ll) < 2 else int(
            min(p.max_gq, round(10.0 / math.log(10.0)
                                * (sorted_ll[0] - sorted_ll[1]))))
        a1, a2 = combos[bi]
        if a1 == ref_ti and a2 == ref_ti:
            return None                       # hom-ref: no VCF record
        # allele-balance filter for hets (binomial log-likelihood at p=0.5)
        filt = "PASS"
        if a1 != a2:
            s1v, s2v = supports[a1], supports[a2]
            n_tot = s1v + s2v
            kmin = min(s1v, s2v)
            if n_tot >= 4:
                xadl = (_log_binom(n_tot, kmin) + n_tot * math.log(0.5))
                if xadl < p.min_ad_log_likelihood:
                    filt = "lowad"

        # VCF record: left-anchor at the last base of the start node
        anchor_off = start_off + g.node_len(int(g.node_id[sn.start >> 1])) - 1
        g_ref = self.graph
        anchor_base = g_ref.handle_seq(sn.start)[-1]
        alt_ids = [a for a in alleles if a != ref_ti]
        vcf_alleles = {ref_ti: 0}
        alts = []
        for a in alt_ids:
            alts.append(anchor_base + seqs[a])
            vcf_alleles[a] = len(alts)
        ref_allele = anchor_base + ref_between
        # trim shared suffix (normalize) minimally: keep as-is for clarity
        gt = tuple(sorted((vcf_alleles[a1], vcf_alleles[a2])))
        return VariantCall(
            chrom=self.ref_path, pos=anchor_off + 1, ref=ref_allele,
            alts=alts, genotype=gt, gq=max(gq, 0),
            depth=self.exp_depth,
            allele_supports=[supports[ref_ti]] + [supports[a] for a in alt_ids],
            filter=filt,
            snarl=(sn.start, sn.end),
            traversals=[list(travs[ref_ti])]
            + [list(travs[a]) for a in alt_ids])

    def _ref_walk(self, sn: Snarl) -> Optional[List[int]]:
        """Handle walk along the reference path from snarl start to end."""
        try:
            i0 = self.ref_handles.index(sn.start)
        except ValueError:
            return None
        walk = [sn.start]
        for h in self.ref_handles[i0 + 1 :]:
            walk.append(h)
            if h == sn.end:
                return walk
        return None

    # ----------------------------------------------------------------- call

    def call(self) -> List[VariantCall]:
        """Genotype the nested snarl decomposition along the reference
        path: top-level snarls are typed as units; when a snarl is too
        big to enumerate (or can't be typed), its on-path children are
        typed instead (the FlowCaller / NestedFlowCaller split,
        reference src/graph_caller.hpp:373,466)."""
        from ..graph.cactus import snarls_on_path

        try:
            snarls, children = snarls_on_path(self.graph, self.ref_path)
        except Exception:
            # fallback: backbone superbubble finder
            snarls = snarls_along_path(self.graph, self.ref_path)
            children = [[] for _ in snarls]
        out: List[VariantCall] = []

        def process(i: int) -> None:
            sn = snarls[i]
            vc = None
            if len(sn.contents) <= self.params.max_snarl_nodes:
                vc = self.genotype_snarl(sn)
            if vc is not None:
                out.append(vc)
            else:
                for c in children[i]:
                    process(c)

        for i, sn in enumerate(snarls):
            if sn.parent is None:
                process(i)
        out.sort(key=lambda v: v.pos)
        return out

    def genotype_given_vcf(self, vcf) -> List[VariantCall]:
        """VCFGenotyper mode (reference src/graph_caller.hpp:49 /
        `vg call -v`): genotype exactly the given VCF's sites using the
        embedded alt paths ("_alt_<hash>_<i>", construct -a), emitting
        records with the ORIGINAL positions and alleles."""
        from ..construct.constructor import make_variant_id

        p = self.params
        g = self.graph
        navg = self.pack.node_avg_all()
        out: List[VariantCall] = []
        for rec in vcf.records:
            if rec.chrom != self.ref_path:
                continue
            name = make_variant_id(rec)
            walks: List[List[int]] = []
            ok = True
            for ai in range(1 + len(rec.alts)):
                pname = f"_alt_{name}_{ai}"
                if not g.has_path(pname):
                    # pure-deletion alt allele has an empty walk
                    walks.append([])
                    continue
                walks.append([int(h) for h in g.path_handles(pname)])
            if not any(walks):
                continue
            supports = []
            for w in walks:
                if not w:
                    # deletion allele: support = edge skipping the site is
                    # not directly recorded; use min of flanking edges via
                    # the non-empty ref walk bounds
                    supports.append(self._deletion_support(rec, walks))
                else:
                    vals = [float(navg[h >> 1]) for h in w]
                    for a, b2 in zip(w, w[1:]):
                        vals.append(float(self.pack.edge_support(a, b2)))
                    supports.append(float(np.min(vals)) if vals else 0.0)
            alleles = list(range(len(walks)))
            total = sum(supports)
            if total < p.min_total_support_for_call:
                continue
            d = max(self.exp_depth, 1e-3)
            err = p.baseline_error_small
            combos = []
            for i in range(len(alleles)):
                for j in range(i, len(alleles)):
                    combos.append((i, j))
            logliks = []
            for (a1, a2) in combos:
                ll = 0.0
                for a in alleles:
                    copies = (a1 == a) + (a2 == a)
                    lam = d / 2.0 * copies + err * d
                    ll += _log_poisson(supports[a], lam)
                logliks.append(ll)
            bi = int(np.argmax(logliks))
            sorted_ll = sorted(logliks, reverse=True)
            gq = p.max_gq if len(sorted_ll) < 2 else int(
                min(p.max_gq, round(10.0 / math.log(10.0)
                                    * (sorted_ll[0] - sorted_ll[1]))))
            a1, a2 = combos[bi]
            out.append(VariantCall(
                chrom=rec.chrom, pos=rec.pos, ref=rec.ref,
                alts=list(rec.alts), genotype=(a1, a2), gq=max(gq, 0),
                depth=self.exp_depth, allele_supports=supports))
        out.sort(key=lambda v: v.pos)
        return out

    def _deletion_support(self, rec, walks) -> float:
        """Support of an empty (pure deletion) allele walk: coverage of
        the edge joining the site's flanks."""
        ref_walk = next((w for w in walks if w), None)
        if not ref_walk:
            return 0.0
        first, last = ref_walk[0], ref_walk[-1]
        best = 0.0
        for pre in self.graph.predecessors(first):
            for nxt in self.graph.follow(last):
                s = self.pack.edge_support(int(pre), int(nxt))
                best = max(best, float(s))
        return best

    def vcf_header(self, contig_len: Optional[int] = None) -> List[str]:
        if contig_len is None:
            contig_len = self.graph.path_len(self.ref_path)
        return [
            "##fileformat=VCFv4.2",
            f"##contig=<ID={self.ref_path},length={contig_len}>",
            '##INFO=<ID=DP,Number=1,Type=Integer,Description="Total depth">',
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
            '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">',
            '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">',
            '##FORMAT=<ID=AD,Number=.,Type=Integer,Description="Allele depths">',
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + self.sample_name,
        ]

    def write_vcf(self, fileobj, calls: Optional[List[VariantCall]] = None) -> None:
        if calls is None:
            calls = self.call()
        for line in self.vcf_header():
            fileobj.write(line + "\n")
        for vc in calls:
            fileobj.write(vc.vcf_line() + "\n")
