"""The harness's side of the port: its set-up from the benchmark's
inputs, the reads as the port takes them, a sink for the records, and
wrappers around the port's entry points (installed from outside; the
port is not edited) that time spans and keep what the judge needs."""
from __future__ import annotations

import functools
import threading
from typing import List

import numpy as np

from reference.graph import decode


def build_pangenome(ref: str, variants, cfg: dict):
    """The port's graph and haplotypes from the reference and the
    variants, as `vg construct` + `vg gbwt -v` (autoindex) build them."""
    from vg_tpu_torch.construct.constructor import (Constructor,
                                                    ConstructorParams)
    from vg_tpu_torch.index.haplotypes import thread_haplotypes
    from vg_tpu_torch.io.vcf import VcfFile, VcfRecord

    samples = [f"s{i + 1}" for i in range(cfg["samples"])]
    recs = [VcfRecord(chrom="ref", pos=v.pos0 + 1, id=".", ref=v.ref,
                      alts=[v.alt], qual=".", filter=".", info={},
                      genotypes=[(gt, True) for gt in v.genotypes])
            for v in variants]
    vcf = VcfFile(samples=samples, records=recs)
    g, results = Constructor(ConstructorParams(
        max_node_size=cfg["max_node_size"])).construct_graph({"ref": ref},
                                                             vcf)
    return thread_haplotypes(g, results, vcf)


def read_strings(codes, quals):
    """(sequences, FASTQ quality strings or None) of reads, through one
    decode."""
    if isinstance(codes, np.ndarray) and codes.ndim == 2:
        n, L = codes.shape
        seq = decode(codes.reshape(-1))
        if quals is None:
            return [seq[i * L : (i + 1) * L] for i in range(n)], [None] * n
        qs = (quals.reshape(-1) + 33).astype(np.uint8).tobytes().decode()
        return ([seq[i * L : (i + 1) * L] for i in range(n)],
                [qs[i * L : (i + 1) * L] for i in range(n)])
    return ([decode(c) for c in codes],
            [(q + 33).astype(np.uint8).tobytes().decode() for q in quals])


def pair_batches(pool) -> List[list]:
    from vg_tpu_torch.io.fastq import Read

    seqs, quals = read_strings(pool.codes, pool.quals)
    reads = [Read(n, s, q) for n, s, q in zip(pool.names, seqs, quals)]
    pairs = list(zip(reads[0::2], reads[1::2]))
    b = pool.batch
    return [pairs[i : i + b] for i in range(0, len(pairs), b)]


def long_batches(pool) -> List[list]:
    from vg_tpu_torch.io.fastq import Read

    seqs, quals = read_strings(pool.codes, pool.quals)
    reads = [Read(n, s, q) for n, s, q in zip(pool.names, seqs, quals)]
    b = pool.batch
    return [reads[i : i + b] for i in range(0, len(reads), b)]


class Sink:
    """Takes each batch's records: counts them and their bytes, and keeps
    a copy of those the judge samples (`per_batch` a batch, picked from
    the seed and the batch's index)."""

    def __init__(self, seed: int, per_batch: int):
        self.seed, self.per_batch = seed, per_batch
        self.records = 0
        self.bytes = 0
        self.kept: List[bytes] = []

    def take(self, k: int, recs) -> None:
        n = len(recs)
        self.records += n
        self.bytes += sum(len(r) for r in recs)
        if n:
            rng = np.random.default_rng([self.seed, k])
            for j in rng.choice(n, min(self.per_batch, n), replace=False):
                self.kept.append(bytes(recs[int(j)]))


class Capture:
    """What the wrappers keep for the judge: the inputs and outputs of a
    few calls in the window, picked from the seed; and, while a stretch
    is traced, what each traced call worked on."""

    def __init__(self):
        self.in_window = False
        self.calls = {}
        self.picks = {}
        self.kept = {}
        self.local = threading.local()
        self.lock = threading.Lock()

    def pick(self, name: str, indices) -> None:
        self.picks[name] = set(int(i) for i in indices)
        self.kept[name] = []

    def number(self, name: str) -> int:
        """This call's index among the window's calls of `name`, or -1."""
        if not self.in_window:
            return -1
        with self.lock:
            i = self.calls.get(name, 0)
            self.calls[name] = i + 1
        return i


class _Hooks:
    """The capture and the tracer that the installed wrappers report to
    (the latest install's: one process may set up several runs)."""
    cap = None
    tracer = None


HOOKS = _Hooks()


def wrap(owner, attr: str, make):
    """Replace owner.attr by make(original), once a process, keeping the
    original's attributes (a kernel wrapper's launch count lives on it)."""
    orig = getattr(owner, attr)
    if getattr(orig, "_bench_wrapper", False):
        return
    new = make(orig)
    functools.update_wrapper(new, orig)
    new._bench_wrapper = True
    setattr(owner, attr, new)


def install_short_read_hooks(capture: Capture, tracer_) -> None:
    """Wrappers on the short-read path: the packed DP entry and the MAPQ
    cap (copies of a few calls' inputs and outputs for the judge; the
    work of each traced call), the pipeline's stages and the cap's begin
    and apply (spans)."""
    from vg_tpu_torch.map.giraffe import GiraffeMapper
    from vg_tpu_torch.map.paired import PairedGiraffeMapper
    from vg_tpu_torch.ops import cuda_align, cuda_mapqcap

    HOOKS.cap, HOOKS.tracer = capture, tracer_

    def dp(orig):
        def call(text_packed, T, reads, reads_rc, rlen, cand_start, cand_lo,
                 cand_hi, cand_rev, cand_valid, **kw):
            cap, tracer = HOOKS.cap, HOOKS.tracer
            i = cap.number("dp")
            with tracer.span("dp", device=True) as span:
                out = orig(text_packed, T, reads, reads_rc, rlen,
                           cand_start, cand_lo, cand_hi, cand_rev,
                           cand_valid, **kw)
            if span.ranged:
                tracer.keep("dp", (reads.shape, rlen, cand_valid,
                                   kw.get("band_radius", 16)))
            if i in cap.picks.get("dp", ()):
                cap.kept["dp"].append(tuple(
                    x.clone() for x in (reads, rlen, cand_start, cand_rev,
                                        cand_valid, out)) + (kw,))
            return out
        return call

    def mapq_cap(orig):
        def call(codes2d, rlen, quals, qoff, keys, *, k, w):
            cap, tracer = HOOKS.cap, HOOKS.tracer
            i = cap.number("cap")
            with tracer.span("cap", device=True) as span:
                out = orig(codes2d, rlen, quals, qoff, keys, k=k, w=w)
            if span.ranged:
                tracer.keep("cap", (codes2d, rlen, quals, qoff, keys, k, w))
            if i in cap.picks.get("cap", ()):
                names = getattr(cap.local, "names", None)
                cap.kept["cap"].append((names, out.clone()))
            return out
        return call

    def begin(orig):
        def call(self, sb):
            HOOKS.cap.local.names = [r.name for r in sb.reads]
            try:
                with HOOKS.tracer.span("begin_mapq_caps"):
                    return orig(self, sb)
            finally:
                HOOKS.cap.local.names = None
        return call

    wrap(cuda_align, "banded_scores_packed", dp)
    wrap(cuda_mapqcap, "mapq_cap", mapq_cap)
    wrap(GiraffeMapper, "begin_mapq_caps", begin)
    wrap(GiraffeMapper, "apply_mapq_caps", timed("apply_mapq_caps"))
    for stage in ("stage_score", "stage_rescue", "stage_emit"):
        wrap(PairedGiraffeMapper, stage, timed(stage[6:]))


def time_launches() -> None:
    """Time each launch of the DP's and the cap's kernels by CUDA events
    while a stretch is profiled: the port's C entries wrapped, so that the
    device time is the kernel's, not the host's work around it."""
    from vg_tpu_torch.ops import cuda_align, cuda_mapqcap

    def launch(orig):
        def call(*a):
            with HOOKS.tracer.launch():
                return orig(*a)
        return call

    wrap(cuda_align.library(), "banded_dp_packed", launch)
    wrap(cuda_mapqcap.library(), "mapq_cap", launch)


def timed(name):
    """A wrapper maker: the method's calls as spans of `name`."""
    def make(orig):
        def call(self, *a, **kw):
            with HOOKS.tracer.span(name):
                return orig(self, *a, **kw)
        return call
    return make


def install_long_read_hooks(tracer_) -> None:
    """Spans on the long-read mapper's batch and its native passes."""
    from vg_tpu_torch.map.longread import LongReadMapper

    HOOKS.tracer = tracer_

    wrap(LongReadMapper, "map_batch_encoded", timed("map_batch"))
    wrap(LongReadMapper, "_native_batch", timed("passes"))
