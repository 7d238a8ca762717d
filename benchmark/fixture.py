"""Inputs made from the seed: a reference sequence, its variants, a
held-out sample, and reads from that sample with their truth.

The pangenome is bench.py's and chip_smoke.py's (make_pangenome: random
reference, SNPs and 1-5 bp indels at least 40 bp apart, two diploid
samples), the held-out sample theirs (make_sample_texts: novel SNPs and
1-5 bp indels the graph has never seen), the short reads their paired
simulator vectorised. Nothing here imports the program: the harness
hands the same sequence, variants and reads to the port and to the
plain reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from reference.graph import Haplotypes, Variant, decode, revcomp

BASES = "ACGT"


def make_variants(rng, ref_len: int, snp_rate: float, indel_rate: float,
                  samples: int, spacing: int):
    """(reference string, variants) as chip_smoke.make_pangenome draws
    them: variant sites at least `spacing` + 1 bp apart, each an SNP or a
    1-5 bp insertion or deletion anchored on its first base, each sample
    a phased random genotype."""
    ref_codes = rng.integers(0, 4, size=ref_len).astype(np.uint8)
    ref = decode(ref_codes)
    n_var = int(ref_len * (snp_rate + indel_rate))
    pos = np.sort(rng.choice(np.arange(100, ref_len - 100), size=n_var,
                             replace=False))
    pos = pos[np.concatenate([[True], np.diff(pos) > spacing])]
    out: List[Variant] = []
    for p in pos:
        p = int(p)
        r = ref[p]
        if rng.random() < snp_rate / (snp_rate + indel_rate):
            alt = BASES[(BASES.index(r) + 1 + int(rng.integers(0, 3))) % 4]
            ref_a, alt_a = r, alt
        else:
            n = int(rng.integers(1, 6))
            if rng.random() < 0.5:
                ins = "".join(BASES[int(b)] for b in rng.integers(0, 4, n))
                ref_a, alt_a = r, r + ins
            else:
                ref_a, alt_a = ref[p : p + 1 + n], r
        gts = [(int(rng.integers(0, 2)), int(rng.integers(0, 2)))
               for _ in range(samples)]
        out.append(Variant(p, ref_a, alt_a, gts))
    return ref, out


@dataclass
class Sample:
    """One held-out haplotype: its text, the indexed haplotype it was
    mutated from, and anchors from its coordinates to that haplotype's."""
    text: np.ndarray
    hap: int
    anc_s: np.ndarray
    anc_o: np.ndarray

    def to_hap(self, x) -> np.ndarray:
        x = np.asarray(x, np.int64)
        a = np.searchsorted(self.anc_s, x, side="right") - 1
        return x - self.anc_s[a] + self.anc_o[a]


def make_sample(rng, haps: Haplotypes, source_haps, novel_snp: float,
                novel_indel: float) -> List[Sample]:
    """The held-out diploid: each phase a copy of one indexed haplotype
    (`source_haps`) with novel SNPs and 1-5 bp indels."""
    out = []
    for h in source_haps:
        t = haps.texts[h].copy()
        n_snp = rng.binomial(len(t), novel_snp)
        ps = rng.integers(0, len(t), n_snp)
        t[ps] = (t[ps] + 1 + rng.integers(0, 3, n_snp)) % 4
        parts, anc_s, anc_o = [], [0], [0]
        cur = built = 0
        for p in np.sort(rng.integers(100, len(t) - 100,
                                      rng.binomial(len(t), novel_indel))):
            p = int(p)
            if p <= cur:
                continue
            parts.append(t[cur:p])
            built += p - cur
            if rng.random() < 0.5:
                ins = rng.integers(0, 4, int(rng.integers(1, 6)))
                parts.append(ins.astype(np.uint8))
                built += len(ins)
                cur = p
            else:
                cur = p + int(rng.integers(1, 6))
            anc_s.append(built)
            anc_o.append(cur)
        parts.append(t[cur:])
        out.append(Sample(np.concatenate(parts), h,
                          np.array(anc_s, np.int64),
                          np.array(anc_o, np.int64)))
    return out


def quality_bins(rng, n: int, length: int, q: dict) -> np.ndarray:
    """(n, length) phred values from the mix's bins, the share of each
    bin moving linearly from the read's 5' end to its 3' end."""
    bins = np.array(q["bins"], np.uint8)
    f = np.arange(length) / max(length - 1, 1)
    lo = np.array(q["share_5p"], np.float64)
    hi = np.array(q["share_3p"], np.float64)
    share = lo[None, :] + (hi - lo)[None, :] * f[:, None]     # (L, bins)
    cum = np.cumsum(share, axis=1)
    cum[:, -1] = 1.0
    u = rng.random((n, length))
    idx = (u[:, :, None] > cum[None, :, :]).sum(axis=2)
    return bins[idx]


def apply_quality_errors(rng, codes: np.ndarray, quals: np.ndarray):
    """Each base wrong (another base, uniformly) with the probability its
    phred value gives."""
    p = 10.0 ** (-quals.astype(np.float64) / 10.0)
    wrong = rng.random(codes.shape) < p
    shift = rng.integers(1, 4, codes.shape).astype(np.uint8)
    return np.where(wrong, (codes + shift) % 4, codes).astype(np.uint8)


@dataclass
class PairPool:
    names: List[str]            # per mate, pair-major: p/1, p/2, ...
    codes: np.ndarray           # (2N, L) as sequenced
    quals: np.ndarray           # (2N, L) phred, None without qualities
    truth: np.ndarray           # (2N,) leftmost reference coordinate
    batch: int                  # pairs a batch


def simulate_pairs(rng, samples: List[Sample], haps: Haplotypes,
                   n_pairs: int, t: dict, tag: str = "p") -> PairPool:
    """Pairs (mate 2 reverse-complemented) from the held-out sample, the
    fragment N(mean, sd) clipped to a read length + 10, qualities from
    the mix's bins and errors drawn from them; each mate's truth is the
    reference coordinate of its leftmost base."""
    L = int(t["read_length"])
    which = rng.integers(0, len(samples), n_pairs)
    frag = np.maximum(rng.normal(t["fragment_mean"], t["fragment_sd"],
                                 n_pairs).astype(np.int64), L + 10)
    codes = np.empty((2 * n_pairs, L), np.uint8)
    truth = np.empty(2 * n_pairs, np.int64)
    cols = np.arange(L)
    for si, s in enumerate(samples):
        sel = np.nonzero(which == si)[0]
        start = (rng.random(len(sel)) * (len(s.text) - frag[sel])).astype(
            np.int64)
        m1 = s.text[start[:, None] + cols]
        e2 = start + frag[sel] - L
        m2 = s.text[e2[:, None] + cols]
        codes[2 * sel] = m1
        codes[2 * sel + 1] = np.where(m2 < 4, 3 - m2, m2)[:, ::-1]
        truth[2 * sel] = haps.to_ref(s.hap, s.to_hap(start))
        truth[2 * sel + 1] = haps.to_ref(s.hap, s.to_hap(e2))
    if t.get("qualities"):
        quals = quality_bins(rng, 2 * n_pairs, L, t["qualities"])
        codes = apply_quality_errors(rng, codes, quals)
    else:                       # FASTA: no qualities, errors at one rate
        quals = None
        p = np.full(codes.shape, 10.0 * np.log10(1.0 / t["error_rate"]))
        codes = apply_quality_errors(rng, codes, p)
    names = [f"{tag}{i}/{m}" for i in range(n_pairs) for m in (1, 2)]
    return PairPool(names, codes, quals, truth, int(t["batch_pairs"]))


@dataclass
class LongPool:
    names: List[str]
    codes: List[np.ndarray]
    quals: List[np.ndarray]
    truth: np.ndarray           # leftmost reference coordinate
    batch: int


def clipped_normal_lengths(n: int, t: dict) -> np.ndarray:
    """n lengths at the n mid-quantiles of N(mean, sd) clipped to
    [min, max]: every seed draws the same lengths, in its own order."""
    from statistics import NormalDist

    d = NormalDist(t["length_mean"], t["length_sd"])
    q = [d.inv_cdf((i + 0.5) / n) for i in range(n)]
    return np.clip(np.array(q), t["length_min"], t["length_max"]).astype(
        np.int64)


def simulate_long(rng, samples: List[Sample], haps: Haplotypes, n: int,
                  t: dict, tag: str = "m") -> LongPool:
    """Long reads from the held-out sample: lengths as above, a random
    strand, substitutions and 1..indel_max bp insertions and deletions
    at the mix's rates; an erroneous base gets the mix's error quality,
    the others its base quality."""
    lengths = rng.permutation(clipped_normal_lengths(n, t))
    names, codes, quals = [], [], []
    truth = np.empty(n, np.int64)
    for i, ln in enumerate(lengths):
        si = int(rng.integers(0, len(samples)))
        s = samples[si]
        start = int(rng.integers(0, len(s.text) - ln))
        c = s.text[start : start + ln].copy()
        truth[i] = haps.to_ref(s.hap, s.to_hap(start))
        n_sub = rng.binomial(ln, t["sub_rate"])
        ps = rng.integers(0, ln, n_sub)
        c[ps] = (c[ps] + rng.integers(1, 4, n_sub)) % 4
        bad = np.zeros(ln, bool)
        bad[ps] = True
        n_ind = rng.binomial(ln, t["indel_rate"])
        at = np.sort(rng.integers(1, ln - t["indel_max"], n_ind))[::-1]
        for p in at:
            p = int(p)
            k = int(rng.integers(1, t["indel_max"] + 1))
            if rng.random() < 0.5:
                c = np.concatenate([c[:p], rng.integers(0, 4, k).astype(
                    np.uint8), c[p:]])
                bad = np.concatenate([bad[:p], np.ones(k, bool), bad[p:]])
            else:
                c = np.concatenate([c[:p], c[p + k:]])
                bad = np.concatenate([bad[:p], bad[p + k:]])
                bad[p - 1] = True
        q = np.where(bad, t["error_quality"], t["base_quality"]).astype(
            np.uint8)
        if rng.random() < 0.5:
            c = revcomp(c)
            q = q[::-1].copy()
        names.append(f"{tag}{i}")
        codes.append(c)
        quals.append(q)
    return LongPool(names, codes, quals, truth, int(t["batch_reads"]))
