"""mapeval: the accuracy oracle (simulate -> map -> score correctness).

The reference's entire quality story runs through this loop: vg sim
produces truth-annotated reads, a mapper maps them, gamcompare marks each
read correct iff it lands within range of the truth position, and vgci
gates on fraction-correct / ROC drift (reference vgci/vgci.py:1136,
:56-59; src/subcommand/gamcompare_main.cpp:26-31,245-253). This module is
that loop as a library + CLI: every number the tests gate on is produced
here, and bench.py reports the same stats alongside throughput.

ROC semantics follow map-eval convention: sort reads by MAPQ descending;
at each MAPQ threshold q report (cumulative wrong, cumulative total) over
reads with mapq >= q — the curve plot-roc.R draws from vgci output.

Copied from vg_tpu/eval/mapeval.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..index.haplotypes import HaplotypeSet
from ..io.fastq import Read
from ..io.gam import Alignment
from ..map.gamcompare import compare
from ..sim.simulator import ReadSimulator


@dataclass
class MapevalResult:
    total: int
    correct: int
    unmapped: int
    accuracy: float
    wrong_mapq60: int              # wrong at the top confidence tier
    roc: List[Tuple[int, int, int]]  # (mapq_threshold, wrong, total)
    mapq_buckets: Dict[str, Dict[str, int]]

    def accuracy_at_mapq(self, min_mapq: int) -> Tuple[float, int]:
        """(fraction correct, n) over reads with mapq >= min_mapq."""
        n = c = 0
        for q, b in self.mapq_buckets.items():
            if int(q) >= min_mapq:
                n += b["n"]
                c += b["correct"]
        return (c / n if n else 1.0), n

    def to_dict(self) -> Dict:
        return {
            "total": self.total, "correct": self.correct,
            "unmapped": self.unmapped, "accuracy": round(self.accuracy, 6),
            "wrong_mapq60": self.wrong_mapq60,
            "roc": self.roc,
        }


def _roc(alns: Sequence[Alignment]) -> List[Tuple[int, int, int]]:
    pts = []
    rows = [(int(a.mapping_quality),
             bool(a.annotation.get("correctly_mapped"))) for a in alns]
    for thr in sorted({q for q, _ in rows}, reverse=True):
        sel = [ok for q, ok in rows if q >= thr]
        pts.append((thr, sum(1 for ok in sel if not ok), len(sel)))
    return pts


def score_alignments(test: Sequence[Alignment], truth: Sequence[Alignment],
                     range_bp: int = 100) -> MapevalResult:
    stats = compare(test, truth, range_bp=range_bp)
    wrong60 = sum(1 for a in test
                  if a.mapping_quality >= 60
                  and not a.annotation.get("correctly_mapped"))
    return MapevalResult(
        total=stats["total"], correct=stats["correct"],
        unmapped=stats["unmapped"], accuracy=stats["accuracy"],
        wrong_mapq60=wrong60, roc=_roc(test),
        mapq_buckets=stats["mapq_buckets"])


def run_mapeval(mapper, n_reads: int = 1000, read_length: int = 150,
                error_rate: float = 0.01, indel_rate: float = 0.0,
                paired: bool = False, seed: int = 7,
                range_bp: int = 100,
                fragment_mean: float = 450.0,
                fragment_stdev: float = 50.0,
                with_quality: bool = False) -> MapevalResult:
    """Simulate truth-annotated reads from the mapper's own haplotype set,
    map them, and score gamcompare-style correctness. with_quality draws
    errors from synthetic per-base qualities and carries the quality
    string into mapping, so the explored-minimizer MAPQ cap engages
    (reference faster_cap, src/minimizer_mapper.cpp:2940)."""
    sim = ReadSimulator(mapper.haps, seed=seed, read_length=read_length,
                        error_rate=error_rate, indel_rate=indel_rate,
                        ref_path_names=mapper.path_pos.path_names,
                        with_quality=with_quality)
    truth = sim.simulate(n_reads, annotate_truth=True, paired=paired,
                         fragment_mean=fragment_mean,
                         fragment_stdev=fragment_stdev)

    def as_read(a: Alignment) -> Read:
        q = None
        if a.quality:
            q = "".join(chr(33 + b) for b in a.quality)
        return Read(a.name, a.sequence, q)

    if paired:
        from ..map.paired import PairedGiraffeMapper

        pm = PairedGiraffeMapper(mapper)
        pairs = []
        for i in range(0, len(truth), 2):
            pairs.append((as_read(truth[i]), as_read(truth[i + 1])))
        mapped_pairs = pm.map_pairs(pairs)
        mapped_pairs += pm.finish()
        mapped: List[Alignment] = []
        for a, b in mapped_pairs:
            mapped.append(a)
            mapped.append(b)
    else:
        reads = [as_read(a) for a in truth]
        bs = max(mapper.params.batch_reads, 64)
        mapped = []
        for i in range(0, len(reads), bs):
            mapped.extend(mapper.map_batch(reads[i : i + bs]))
    return score_alignments(mapped, truth, range_bp=range_bp)
