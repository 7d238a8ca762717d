"""Haplotype sampling: personalize the haplotype text to a read set.

Reference: vg haplotypes (Recombinator/Haplotypes, src/recombinator.cpp,
SURVEY.md §2.1) classifies kmers from the sample's reads and recombines
local haplotypes into a sampled GBZ. This implementation scores each
indexed haplotype by the fraction of its minimizers supported by the
read set's minimizers — per window and globally — and keeps the best
cover: the scaling answer when cohort texts outgrow HBM (ARCHITECTURE.md
"haplotype text" trade-off).

Copied from vg_tpu/index/sampling.py.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..io.fastq import Read
from ..utils import dna
from .haplotypes import HaplotypeSet
from .minimizer import extract_minimizers


def read_minimizer_set(reads: Sequence[Read], k: int = 29, w: int = 11
                       ) -> np.ndarray:
    keys = []
    for r in reads:
        codes = dna.encode(r.sequence)
        _, kk, _ = extract_minimizers(codes, k, w)
        keys.append(kk)
    if not keys:
        return np.zeros(0, np.uint64)
    return np.unique(np.concatenate(keys))


def score_haplotypes(haps: HaplotypeSet, read_keys: np.ndarray,
                     k: int = 29, w: int = 11) -> np.ndarray:
    """Per-haplotype fraction of its minimizers present in the read set."""
    scores = np.zeros(haps.count)
    for h in range(haps.count):
        t0, t1 = haps.hap_text_range(h)
        _, keys, _ = extract_minimizers(haps.text[t0:t1], k, w)
        if len(keys) == 0:
            continue
        idx = np.searchsorted(read_keys, keys)
        idx = np.minimum(idx, max(len(read_keys) - 1, 0))
        hit = (len(read_keys) > 0) & (read_keys[idx] == keys)
        scores[h] = hit.mean()
    return scores


def sample_haplotypes(haps: HaplotypeSet, reads: Sequence[Read],
                      num_haplotypes: int = 4, keep_ref: bool = True,
                      k: int = 29, w: int = 11) -> HaplotypeSet:
    """Keep the num_haplotypes best-supported haplotypes (+ references)."""
    read_keys = read_minimizer_set(reads, k, w)
    scores = score_haplotypes(haps, read_keys, k, w)
    order = np.argsort(-scores)
    chosen: List[int] = []
    for h in order:
        if len(chosen) >= num_haplotypes:
            break
        chosen.append(int(h))
    if keep_ref:
        for h in range(haps.count):
            if haps.metas[h].is_ref and h not in chosen:
                chosen.append(h)
    chosen.sort()
    metas = [haps.metas[h] for h in chosen]
    walks = [haps.steps[haps.steps_start[h] : haps.steps_start[h + 1]]
             for h in chosen]
    return HaplotypeSet(haps.graph, metas, walks)


def _fragment_score(haps: HaplotypeSet, g0: int, g1: int,
                    read_keys: np.ndarray, k: int, w: int) -> float:
    """Read support of the text spelled by global steps [g0, g1)."""
    t0 = int(haps.step_text_pos[g0])
    t1 = int(haps.step_text_pos[g1])
    if t1 - t0 < k:
        return 0.0
    _, keys, _ = extract_minimizers(haps.text[t0:t1], k, w)
    if len(keys) == 0 or len(read_keys) == 0:
        return 0.0
    idx = np.minimum(np.searchsorted(read_keys, keys), len(read_keys) - 1)
    return float((read_keys[idx] == keys).mean())


def recombine_haplotypes(haps: HaplotypeSet, reads: Sequence[Read],
                         num_haplotypes: int = 2,
                         subchain_len: int = 10_000,
                         k: int = 29, w: int = 11) -> HaplotypeSet:
    """Per-subchain recombination (reference: Recombinator,
    src/recombinator.cpp — kmer-classified per-subchain haplotype
    selection stitched into synthetic sampled haplotypes).

    Crossover anchors are handles every indexed haplotype of a contig
    visits exactly once (the subchain boundary nodes of the snarl chain);
    anchors are kept >= subchain_len bp apart. Within each subchain, every
    haplotype's fragment is scored by the fraction of its minimizers
    supported by the read set, and output j stitches the rank-j fragment
    of every subchain — so the top output is the locally best-supported
    mosaic. Junction edges exist by construction: each fragment ends on
    the step preceding a shared anchor."""
    read_keys = read_minimizer_set(reads, k, w)

    # group haplotypes by contig
    groups: dict = {}
    for h in range(haps.count):
        groups.setdefault(haps.metas[h].contig, []).append(h)

    out_metas: List = []
    out_walks: List[np.ndarray] = []
    from .haplotypes import HaplotypeMeta

    for contig, members in groups.items():
        walks = [haps.steps[haps.steps_start[h] : haps.steps_start[h + 1]]
                 for h in members]
        if len(members) == 1:
            out_metas.append(haps.metas[members[0]])
            out_walks.append(walks[0])
            continue
        # anchors: handles visited exactly once by every member haplotype
        once = None
        for wk in walks:
            u, c = np.unique(wk, return_counts=True)
            s = set(u[c == 1].tolist())
            once = s if once is None else (once & s)
        # order + occurrence index along each walk
        occ = [{int(h): i for i, h in enumerate(wk)} for wk in walks]
        w0 = walks[0]
        anchors = [i for i, h in enumerate(w0) if int(h) in once]
        # thin anchors to >= subchain_len bp apart (text pos of hap 0)
        base = int(haps.steps_start[members[0]])
        tp = haps.step_text_pos
        kept: List[int] = []
        last = -subchain_len
        for i in anchors:
            pos = int(tp[base + i])
            if pos - last >= subchain_len:
                kept.append(i)
                last = pos
        cut_handles = [int(w0[i]) for i in kept
                       if 0 < i < len(w0) - 1]

        # fragments per haplotype: [start..anchor1), [anchor1..anchor2)...
        n_sub = len(cut_handles) + 1
        frag_bounds = []          # per member: list of (g0, g1) global steps
        for mi, h in enumerate(members):
            gbase = int(haps.steps_start[h])
            cuts = [occ[mi][ch] for ch in cut_handles]
            if cuts != sorted(cuts):      # order disagreement: bail to copy
                frag_bounds = None
                break
            bounds = [0] + cuts + [len(walks[mi])]
            frag_bounds.append([(gbase + a, gbase + b)
                                for a, b in zip(bounds[:-1], bounds[1:])])
        if frag_bounds is None or n_sub == 1:
            order = np.argsort([-_fragment_score(
                haps, int(haps.steps_start[h]),
                int(haps.steps_start[h + 1]), read_keys, k, w)
                for h in members])
            for j in range(min(num_haplotypes, len(members))):
                h = members[int(order[j])]
                out_metas.append(haps.metas[h])
                out_walks.append(walks[int(order[j])])
            continue

        # score each (subchain, member) fragment, rank per subchain
        scores = np.array([[_fragment_score(haps, g0, g1, read_keys, k, w)
                            for (g0, g1) in fb] for fb in frag_bounds])
        rank = np.argsort(-scores, axis=0, kind="stable")   # (member, sub)
        for j in range(min(num_haplotypes, len(members))):
            pieces = []
            for s in range(n_sub):
                mi = int(rank[j, s])
                g0, g1 = frag_bounds[mi][s]
                pieces.append(haps.steps[g0:g1])
            out_walks.append(np.concatenate(pieces))
            out_metas.append(HaplotypeMeta(
                name=f"recomb#{j}#{contig}" if contig else f"recomb#{j}",
                sample="recomb", phase=j, contig=contig))
    return HaplotypeSet(haps.graph, out_metas, out_walks)


# ------------------------------------------------ kmer-count (KFF) scoring

def estimate_coverage(counts: np.ndarray) -> float:
    """Kmer coverage from sample counts: the count MODE when it is at
    least the median; otherwise look for a secondary (homozygous) peak
    at 1.7-2.3x the mode; otherwise fall back to the median (exact port
    of reference recombinator.cpp:1640-1700)."""
    counts = np.asarray(counts)
    if len(counts) == 0:
        return 0.0
    freq = np.bincount(counts.astype(np.int64))
    mode = int(np.argmax(freq[1:]) + 1) if len(freq) > 1 else 1
    median = float(np.median(counts))
    if mode >= median:
        return float(mode)
    lo, hi = int(1.7 * mode), int(2.3 * mode)
    peak = freq[mode]
    best, secondary = lo, freq[lo] if lo < len(freq) else 0
    for i in range(lo + 1, min(hi + 1, len(freq))):
        if freq[i] > secondary:
            best, secondary = i, freq[i]
    if best >= median and secondary >= peak / 2:
        return float(best)
    return median


ABSENT, HET, PRESENT, FREQUENT = 0, 1, 2, 3


def classify_kmer_counts(counts: np.ndarray, coverage: float,
                         absent_score: float = 0.8) -> Tuple[np.ndarray,
                                                             np.ndarray]:
    """(type, haploid score) per kmer given the sample counts (exact
    thresholds from reference recombinator.cpp:1822-1825 classify_kmers,
    diploid mode): absent < 0.1*cov (score -absent_score),
    heterozygous < cov/ln(4) (0), present < 2.5*cov (+1),
    frequent otherwise (0)."""
    counts = np.asarray(counts, float)
    typ = np.full(len(counts), FREQUENT, np.int8)
    typ[counts < 2.5 * coverage] = PRESENT
    typ[counts < coverage / np.log(4.0)] = HET
    typ[counts < 0.1 * coverage] = ABSENT
    score = np.where(typ == PRESENT, 1.0,
                     np.where(typ == ABSENT, -absent_score, 0.0))
    return typ, score


def _fragment_kmers(haps: HaplotypeSet, g0: int, g1: int,
                    k: int) -> np.ndarray:
    from .minimizer import _rolling_kmers

    t0 = int(haps.step_text_pos[g0])
    t1 = int(haps.step_text_pos[g1])
    if t1 - t0 < k:
        return np.zeros(0, np.uint64)
    fwd, rev, valid = _rolling_kmers(haps.text[t0:t1], k)
    return np.unique(np.where(rev < fwd, rev, fwd)[valid])


def recombine_haplotypes_diploid(haps: HaplotypeSet, kff_kmers: np.ndarray,
                                 kff_counts: np.ndarray,
                                 subchain_len: int = 10_000,
                                 k: int = 29,
                                 coverage: float = 0.0) -> HaplotypeSet:
    """Diploid haplotype sampling from KFF kmer counts (the reference's
    `vg haplotypes -k counts.kff --diploid-sampling`, Recombinator
    select_diploid recombinator.cpp:1860-1905): per subchain, classify
    the union of candidate-haplotype kmers against the sample counts and
    pick the PAIR maximizing the diploid score (absent: +1 for 0 copies,
    het: +1 for exactly 1, present: +1 for 2, -1 mirror), stitching the
    chosen fragments into two sampled haplotypes per contig."""
    from .haplotypes import HaplotypeMeta

    if coverage <= 0:
        coverage = estimate_coverage(kff_counts)

    def count_of(kmers: np.ndarray) -> np.ndarray:
        if len(kff_kmers) == 0 or len(kmers) == 0:
            return np.zeros(len(kmers), np.int64)
        idx = np.minimum(np.searchsorted(kff_kmers, kmers),
                         len(kff_kmers) - 1)
        hit = kff_kmers[idx] == kmers
        return np.where(hit, kff_counts[idx], 0)

    # group haplotypes by GRAPH COMPONENT, not contig name: HPRC cohort
    # haplotypes name their contigs per-sample (JAHB...), so the locus a
    # walk traverses is the weakly-connected component it lives in
    # (reference: Recombinator works per top-level chain)
    n = haps.graph.node_count
    comp = np.full(n, -1, np.int64)
    cur = 0
    g = haps.graph
    for start in range(n):
        if comp[start] >= 0:
            continue
        stack = [start]
        comp[start] = cur
        while stack:
            u = stack.pop()
            for side in (0, 1):
                for v in g.follow(u * 2 + side):
                    vi = int(v) >> 1
                    if comp[vi] < 0:
                        comp[vi] = cur
                        stack.append(vi)
        cur += 1
    groups: dict = {}
    for h in range(haps.count):
        first = int(haps.steps[haps.steps_start[h]]) >> 1
        groups.setdefault(int(comp[first]), []).append(h)

    out_metas: List = []
    out_walks: List[np.ndarray] = []
    for contig, members in groups.items():
        walks = [haps.steps[haps.steps_start[h] : haps.steps_start[h + 1]]
                 for h in members]
        contig = haps.metas[members[0]].contig
        if len(members) <= 2:
            for h, wk in zip(members, walks):
                out_metas.append(haps.metas[h])
                out_walks.append(wk)
            continue
        # shared single-visit anchors (same machinery as
        # recombine_haplotypes)
        once = None
        for wk in walks:
            u, c = np.unique(wk, return_counts=True)
            s = set(u[c == 1].tolist())
            once = s if once is None else (once & s)
        occ = [{int(hh): i for i, hh in enumerate(wk)} for wk in walks]
        w0 = walks[0]
        anchors = [i for i, hh in enumerate(w0) if int(hh) in once]
        base = int(haps.steps_start[members[0]])
        tp = haps.step_text_pos
        kept: List[int] = []
        last = -subchain_len
        for i in anchors:
            pos = int(tp[base + i])
            if pos - last >= subchain_len:
                kept.append(i)
                last = pos
        cut_handles = [int(w0[i]) for i in kept if 0 < i < len(w0) - 1]
        n_sub = len(cut_handles) + 1
        frag_bounds = []
        for mi, h in enumerate(members):
            gbase = int(haps.steps_start[h])
            cuts = [occ[mi].get(ch) for ch in cut_handles]
            if None in cuts or cuts != sorted(cuts):
                frag_bounds = None
                break
            bounds = [0] + cuts + [len(walks[mi])]
            frag_bounds.append([(gbase + a, gbase + b)
                                for a, b in zip(bounds[:-1], bounds[1:])])
        if frag_bounds is None or n_sub == 0:
            for h, wk in list(zip(members, walks))[:2]:
                out_metas.append(haps.metas[h])
                out_walks.append(wk)
            continue

        pieces1: List[np.ndarray] = []
        pieces2: List[np.ndarray] = []
        for s in range(n_sub):
            frag_sets = [_fragment_kmers(haps, *frag_bounds[mi][s], k)
                         for mi in range(len(members))]
            union = (np.unique(np.concatenate(
                [f for f in frag_sets if len(f)]))
                if any(len(f) for f in frag_sets)
                else np.zeros(0, np.uint64))
            typ, _sc = classify_kmer_counts(count_of(union), coverage)
            present = np.zeros((len(members), len(union)), bool)
            for mi, f in enumerate(frag_sets):
                if len(f):
                    idx = np.minimum(np.searchsorted(union, f),
                                     max(len(union) - 1, 0))
                    present[mi, idx[union[idx] == f]] = True
            best = (-1 << 60, 0, 0)
            for a in range(len(members)):
                for b in range(a, len(members)):
                    found = present[a].astype(int) + present[b].astype(int)
                    sc = int(np.sum(np.where(
                        typ == ABSENT, 1 - found,
                        np.where(typ == HET, (found == 1).astype(int),
                                 np.where(typ == PRESENT, found - 1, 0)))))
                    if sc > best[0]:
                        best = (sc, a, b)
            _, a, b = best
            pieces1.append(haps.steps[slice(*frag_bounds[a][s])])
            pieces2.append(haps.steps[slice(*frag_bounds[b][s])])
        out_walks.append(np.concatenate(pieces1))
        out_metas.append(HaplotypeMeta(
            name=f"sampled#1#{contig}" if contig else "sampled#1",
            sample="sampled", phase=1, contig=contig))
        out_walks.append(np.concatenate(pieces2))
        out_metas.append(HaplotypeMeta(
            name=f"sampled#2#{contig}" if contig else "sampled#2",
            sample="sampled", phase=2, contig=contig))
    return HaplotypeSet(haps.graph, out_metas, out_walks)
