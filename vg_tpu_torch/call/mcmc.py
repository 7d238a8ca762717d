"""MCMC phased genotyper (the `vg mcmc` role).

The reference's MCMCGenotyper (src/mcmc_genotyper.cpp, driven by
src/subcommand/mcmc_main.cpp) Gibbs-samples a diploid pair of haplotypes
over the snarl decomposition from read support: each iteration re-samples
one site's genotype conditioned on the rest, with reads that span
multiple sites coupling the phase; the maximum-a-posteriori state is
embedded into the graph as two paths.

TPU-native framing: the state is two integer vectors (allele index per
site per haplotype); per-read allele-consistency is precomputed once into
small index arrays, so a Gibbs sweep is pure numpy over those arrays —
no graph traversal inside the sampling loop.

Copied from vg_tpu/call/mcmc.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..graph.arraygraph import ArrayGraph, GraphBuilder
from ..graph.snarls import snarl_traversals, snarls_along_path
from ..io.gam import Alignment


@dataclass
class MCMCParams:
    n_iter: int = 500            # Gibbs sweeps (reference default 1000
    burn_in: int = 100           # single-site moves; ours are sweeps)
    seed: int = 42
    epsilon: float = 0.05        # per-site read/allele mismatch prob
    max_alleles: int = 6
    min_support: int = 1


@dataclass
class Site:
    snarl: object
    alleles: List[List[int]]          # traversal handle walks (with ends)
    interiors: List[frozenset]        # interior node-id sets per allele
    ref_allele: int = 0


class MCMCGenotyper:
    """Gibbs sampler over diploid snarl genotypes with read-backed
    phasing (reference src/mcmc_genotyper.cpp:run/alter_state)."""

    def __init__(self, graph: ArrayGraph, ref_path: Optional[str] = None,
                 params: Optional[MCMCParams] = None):
        self.graph = graph
        self.params = params or MCMCParams()
        names = [m.name for m in graph.path_meta
                 if not m.name.startswith("_alt_")]
        self.ref_path = ref_path or (names[0] if names else
                                     graph.path_meta[0].name)
        self.sites: List[Site] = []
        self._node_site: Dict[int, List[int]] = {}
        self._build_sites()

    def _build_sites(self) -> None:
        g = self.graph
        for sn in snarls_along_path(g, self.ref_path):
            walks = snarl_traversals(g, sn,
                                     max_traversals=self.params.max_alleles)
            if len(walks) < 2:
                continue
            interiors = [frozenset(int(g.node_id[int(h) >> 1])
                                   for h in w[1:-1]) for w in walks]
            site = Site(snarl=sn, alleles=[list(map(int, w))
                                           for w in walks],
                        interiors=interiors)
            si = len(self.sites)
            self.sites.append(site)
            for ints in interiors:
                for nid in ints:
                    self._node_site.setdefault(nid, []).append(si)
            for h in (sn.start, sn.end):
                nid = int(g.node_id[int(h) >> 1])
                self._node_site.setdefault(nid, []).append(si)

    # ------------------------------------------------- read consistency

    def _read_site_support(self, alns: Sequence[Alignment]):
        """For each read and overlapped site: the boolean allele-
        consistency row. Returns flat arrays (read_id, site, allele_mask)
        plus per-site spanning-read counts."""
        rows: List[Tuple[int, int, int]] = []   # (read, site, mask bits)
        for ri, a in enumerate(alns):
            if a.path is None or not a.path.mappings:
                continue
            nids = [mp.position.node_id for mp in a.path.mappings]
            nset = set(nids)
            touched: Dict[int, set] = {}
            for nid in nset:
                for si in self._node_site.get(nid, ()):
                    touched.setdefault(si, set()).add(nid)
            for si, nodes in touched.items():
                site = self.sites[si]
                g = self.graph
                s_id = int(g.node_id[int(site.snarl.start) >> 1])
                e_id = int(g.node_id[int(site.snarl.end) >> 1])
                inner = nodes - {s_id, e_id}
                mask = 0
                for ai, ints in enumerate(site.interiors):
                    spanning = s_id in nset and e_id in nset
                    if spanning:
                        ok = inner == ints or (not ints and not inner)
                    else:
                        ok = inner <= ints
                    if ok:
                        mask |= 1 << ai
                if mask and mask != (1 << len(site.alleles)) - 1:
                    # uninformative reads (consistent with everything)
                    # contribute nothing to the conditional
                    rows.append((ri, si, mask))
        return rows

    # ------------------------------------------------------------- run

    def run(self, alns: Sequence[Alignment]):
        """Gibbs-sample genotypes; returns (h1, h2, logp) allele-index
        vectors of the MAP state."""
        p = self.params
        S = len(self.sites)
        rng = np.random.default_rng(p.seed)
        h = np.zeros((2, S), np.int64)
        if S == 0:
            return h[0], h[1], 0.0
        rows = self._read_site_support(alns)
        by_site: List[List[Tuple[int, int]]] = [[] for _ in range(S)]
        for ri, si, mask in rows:
            by_site[si].append((ri, mask))
        # per read: list of (site, mask) for phase coupling
        by_read: Dict[int, List[Tuple[int, int]]] = {}
        for ri, si, mask in rows:
            by_read.setdefault(ri, []).append((si, mask))

        eps = p.epsilon
        log_eps = np.log(eps)
        log_ok = np.log(1 - eps)

        def read_loglik(ri: int, hh) -> float:
            """log P(read | state): mixture over the two haplotypes."""
            terms = []
            for hap in range(2):
                lp = 0.0
                for si, mask in by_read[ri]:
                    lp += log_ok if (mask >> hh[hap, si]) & 1 else log_eps
                terms.append(lp)
            m = max(terms)
            return m + np.log(0.5 * np.exp(terms[0] - m)
                              + 0.5 * np.exp(terms[1] - m))

        def state_loglik(hh) -> float:
            return float(sum(read_loglik(ri, hh) for ri in by_read))

        best = h.copy()
        best_lp = state_loglik(h)
        for sweep in range(p.n_iter):
            for si in range(S):
                na = len(self.sites[si].alleles)
                reads_here = {ri for ri, _ in by_site[si]}
                if not reads_here:
                    continue
                combos = [(a1, a2) for a1 in range(na) for a2 in range(na)]
                lps = np.empty(len(combos))
                old = (h[0, si], h[1, si])
                for ci, (a1, a2) in enumerate(combos):
                    h[0, si], h[1, si] = a1, a2
                    lps[ci] = sum(read_loglik(ri, h) for ri in reads_here)
                lps -= lps.max()
                w = np.exp(lps)
                w /= w.sum()
                pick = combos[int(rng.choice(len(combos), p=w))]
                h[0, si], h[1, si] = pick
            lp = state_loglik(h)
            if lp > best_lp and sweep >= p.burn_in // max(S, 1):
                best_lp = lp
                best = h.copy()
        return best[0], best[1], best_lp

    # ------------------------------------------------------- embedding

    def embed_haplotypes(self, h1: np.ndarray, h2: np.ndarray,
                         sample: str = "PHASED_SAMPLE"):
        """New graph with the two sampled haplotypes embedded as paths
        along the reference backbone (mcmc_main's output contract)."""
        g = self.graph
        pi = g.path_index(self.ref_path)
        ref = [int(x) for x in g.path_handles(pi)]
        # site start handle -> (site idx); walk ref, splice alleles
        start_at = {}
        for si, site in enumerate(self.sites):
            start_at[int(site.snarl.start)] = si
        walks = []
        for hap, hvec in enumerate((h1, h2)):
            walk: List[int] = []
            i = 0
            while i < len(ref):
                h = ref[i]
                si = start_at.get(h)
                if si is not None:
                    site = self.sites[si]
                    allele = site.alleles[int(hvec[si])]
                    walk.extend(allele[:-1])
                    # skip ref handles up to (not incl.) the snarl end
                    j = i + 1
                    while j < len(ref) and ref[j] != int(site.snarl.end):
                        j += 1
                    i = j
                    continue
                walk.append(h)
                i += 1
            walks.append(walk)
        from ..graph.arraygraph import SENSE_HAPLOTYPE

        b = GraphBuilder()
        for i in range(g.node_count):
            b.add_node(g.seq[g.seq_start[i] : g.seq_start[i + 1]],
                       node_id=int(g.node_id[i]))
        for f_id, f_rev, t_id, t_rev in g.iter_edges():
            b.add_edge(int(f_id), int(t_id), bool(f_rev), bool(t_rev))
        for pi, meta in enumerate(g.path_meta):
            steps = [(int(g.node_id[int(hh) >> 1]), bool(int(hh) & 1))
                     for hh in g.path_handles(pi)]
            b.paths.append((meta, steps))
        for i, w in enumerate(walks):
            b.add_path(f"{sample}_{i}",
                       [(int(g.node_id[hh >> 1]), bool(hh & 1))
                        for hh in w],
                       sense=SENSE_HAPLOTYPE, sample=sample, haplotype=i)
        return b.freeze()
