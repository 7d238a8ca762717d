"""Read simulation with ground truth (vg sim equivalent).

Reference: Sampler/NGSSimulator (src/sampler.cpp, src/subcommand/
sim_main.cpp) sample read start positions from indexed paths/haplotypes,
apply an error model, and emit GAM with the true alignment embedded —
the truth source for gamcompare and mapeval. Here positions are sampled
uniformly from the haplotype text (= length-weighted over haplotypes),
errors are iid substitutions plus geometric-length indels, and the truth
path + refpos are projected through the same machinery the mapper uses.

Copied from vg_tpu/sim/simulator.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..index.haplotypes import HaplotypeSet
from ..io.gam import Alignment, Edit, Mapping, Path, Position
from ..map.project import PathPositionIndex
from ..utils import dna


class ReadSimulator:
    def __init__(self, haps: HaplotypeSet, seed: int = 0,
                 read_length: int = 100, error_rate: float = 0.0,
                 indel_rate: float = 0.0,
                 ref_path_names: Optional[List[str]] = None,
                 with_quality: bool = False):
        self.haps = haps
        self.rng = np.random.default_rng(seed)
        self.read_length = read_length
        self.error_rate = error_rate
        self.indel_rate = indel_rate
        # with_quality: synthesize per-base phred qualities (high-Q core,
        # occasional low-Q windows, 3' decay — the quality-less uniform
        # model can't exercise giraffe's explored-minimizer MAPQ cap,
        # which is infinite without qualities; reference NGSSimulator,
        # src/sampler.cpp:208) and draw substitution errors at
        # 10^(-q/10) per base instead of error_rate.
        self.with_quality = with_quality
        self.ppi = PathPositionIndex(
            haps.graph,
            ref_path_names or [m.name for m in haps.graph.path_meta])

    def _synth_quality(self, L: int) -> np.ndarray:
        rng = self.rng
        q = rng.normal(36.0, 2.5, L)
        # 3'-end decay, NovaSeq-style
        tail = min(30, L)
        q[L - tail:] -= np.linspace(0.0, 6.0, tail)
        if rng.random() < 0.25:          # low-quality patch
            wl = int(rng.integers(10, 40))
            ws = int(rng.integers(0, max(L - wl, 1)))
            q[ws : ws + wl] = rng.uniform(6.0, 16.0)
        return np.clip(np.round(q), 2, 40).astype(np.uint8)

    def _truth_path(self, start: int, length: int) -> Path:
        pieces = self.haps.walk_interval(start, start + length)
        g = self.haps.graph
        path = Path()
        for rank, (h, off, ln) in enumerate(pieces, 1):
            path.mappings.append(Mapping(
                position=Position(node_id=int(g.node_id[h >> 1]),
                                  offset=int(off),
                                  is_reverse=bool(h & 1)),
                edits=[Edit(from_length=int(ln), to_length=int(ln))],
                rank=rank))
        return path

    def simulate(self, n: int, annotate_truth: bool = True,
                 paired: bool = False, fragment_mean: float = 400.0,
                 fragment_stdev: float = 50.0) -> List[Alignment]:
        L = self.read_length
        T = self.haps.total_len
        rng = self.rng
        out: List[Alignment] = []
        tries = 0
        while len(out) < (2 * n if paired else n) and tries < 20 * n:
            tries += 1
            if paired:
                frag = int(rng.normal(fragment_mean, fragment_stdev))
                frag = max(frag, L + 10)
                s = int(rng.integers(0, max(T - frag, 1)))
                h0 = int(self.haps.hap_of_text_pos(s))
                if int(self.haps.hap_of_text_pos(s + frag - 1)) != h0:
                    continue
                spans = [(s, False), (s + frag - L, True)]
            else:
                s = int(rng.integers(0, max(T - L, 1)))
                h0 = int(self.haps.hap_of_text_pos(s))
                if int(self.haps.hap_of_text_pos(s + L - 1)) != h0:
                    continue
                spans = [(s, bool(rng.random() < 0.5))]
            group = []
            for start, rev in spans:
                codes = self.haps.text[start : start + L].copy()
                qual = None
                if self.with_quality:
                    qual = self._synth_quality(len(codes))
                    err = self.rng.random(len(codes)) < 10.0 ** (
                        -qual.astype(np.float64) / 10.0)
                    ne = int(err.sum())
                    if ne:
                        codes[err] = (codes[err] + 1 + self.rng.integers(
                            0, 3, ne).astype(np.uint8)) % 4
                    codes = self._mutate_indel_only(codes)
                else:
                    codes = self._mutate(codes)
                if rev:
                    codes = dna.revcomp_codes(codes)
                    if qual is not None:
                        qual = qual[::-1]
                name = f"sim{len(out) + len(group)}"
                aln = Alignment(name=name, sequence=dna.decode(codes))
                if qual is not None:
                    aln.quality = qual.tobytes()
                if annotate_truth:
                    path = self._truth_path(start, L)
                    if rev:
                        from ..map.project import reverse_complement_path
                        path = reverse_complement_path(self.haps.graph, path)
                        for rank, mp in enumerate(path.mappings, 1):
                            mp.rank = rank
                    aln.path = path
                    self.ppi.annotate_refpos(aln)
                group.append(aln)
            if paired:
                group[0].fragment_next = Alignment(name=group[1].name)
                group[1].fragment_prev = Alignment(name=group[0].name)
            out.extend(group)
        return out

    def _mutate_indel_only(self, codes: np.ndarray) -> np.ndarray:
        """Indel channel only (substitutions already drawn from the
        quality model)."""
        rng = self.rng
        if self.indel_rate > 0 and rng.random() < self.indel_rate * len(codes):
            p = int(rng.integers(1, len(codes) - 1))
            n = 1 + int(rng.geometric(0.7))
            if rng.random() < 0.5:
                ins = rng.integers(0, 4, n).astype(np.uint8)
                codes = np.concatenate([codes[:p], ins, codes[p:]])[: len(codes)]
            else:
                codes = np.concatenate([codes[:p], codes[p + n :]])
        return codes

    def _mutate(self, codes: np.ndarray) -> np.ndarray:
        rng = self.rng
        if self.error_rate > 0:
            nerr = rng.binomial(len(codes), self.error_rate)
            for _ in range(nerr):
                p = int(rng.integers(0, len(codes)))
                codes[p] = (codes[p] + 1 + rng.integers(0, 3)) % 4
        if self.indel_rate > 0 and rng.random() < self.indel_rate * len(codes):
            p = int(rng.integers(1, len(codes) - 1))
            n = 1 + int(rng.geometric(0.7))
            if rng.random() < 0.5:
                ins = rng.integers(0, 4, n).astype(np.uint8)
                codes = np.concatenate([codes[:p], ins, codes[p:]])[: len(codes)]
            else:
                codes = np.concatenate([codes[:p], codes[p + n :]])
        return codes


class NGSErrorModel:
    """FASTQ-trained error model (reference: NGSSimulator,
    src/sampler.cpp:208 — per-cycle error rates learned from real base
    qualities; simulated reads reuse sampled quality strings and draw
    substitutions per position from them)."""

    def __init__(self):
        self.quality_strings: List[bytes] = []
        self.per_cycle_err: Optional[np.ndarray] = None
        self.read_length: int = 0

    @classmethod
    def train(cls, fastq_path: str, max_reads: int = 10000) -> "NGSErrorModel":
        from ..io.fastq import iter_fastq

        self = cls()
        sums = None
        count = 0
        for r in iter_fastq(fastq_path):
            if r.quality is None:
                continue
            q = np.frombuffer(r.quality.encode(), np.uint8).astype(np.float64) - 33
            if sums is None:
                sums = np.zeros(len(q), np.float64)
                self.read_length = len(q)
            if len(q) != self.read_length:
                continue
            sums += 10.0 ** (-q / 10.0)
            self.quality_strings.append(r.quality.encode())
            count += 1
            if count >= max_reads:
                break
        if count:
            self.per_cycle_err = sums / count
        return self

    def mutate(self, codes: np.ndarray, rng: np.random.Generator
               ) -> Tuple[np.ndarray, bytes]:
        """Apply per-cycle substitution errors; returns (codes, quality)."""
        if self.per_cycle_err is None or not self.quality_strings:
            return codes, b""
        qual = self.quality_strings[int(rng.integers(0, len(self.quality_strings)))]
        L = min(len(codes), self.read_length)
        q = np.frombuffer(qual[:L], np.uint8).astype(np.float64) - 33
        p = 10.0 ** (-q / 10.0)
        hits = rng.random(L) < p
        idx = np.nonzero(hits)[0]
        codes = codes.copy()
        codes[idx] = (codes[idx] + 1 + rng.integers(0, 3, len(idx))) % 4
        return codes, qual[:L]
