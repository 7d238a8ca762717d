"""The port's stage clock (vg_tpu_torch/utils/stagetime.py) and the spans
the short-read pipeline records with it, on the CPU. JAX-free.

A tiny pangenome (chip_smoke's builders, the port's own construct and
index) and pairs whose reads carry qualities go through
map_pairs_encoded_mt: every span of the pipeline's threads, the stages
and the MAPQ cap fills its key of PairedGiraffeMapper.stage_seconds,
children sum to at most their parents and CPU seconds to at most wall
seconds; records are the same bytes with torch's profiler on and off;
under the profiler the spans are ranges that nest by thread and carry
their batch's sequence number; with it off no range is opened. Fake
mappers with a 50 ms stage show which queue wait grows. No assertion
rests on a time finer than 50 ms."""
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from vg_tpu_torch.index.haplotypes import thread_haplotypes
from vg_tpu_torch.index.minimizer import MinimizerIndex
from vg_tpu_torch.io.fastq import Read
from vg_tpu_torch.map import giraffe as tg
from vg_tpu_torch.map.paired import PairedGiraffeMapper
from vg_tpu_torch.parallel.pipeline import map_pairs_encoded_mt
from vg_tpu_torch.utils import stagetime
from vg_tpu_torch.utils.stagetime import StageClock

# The suite runs in several worker processes at once: torch's intra-op
# threads (spinning OpenMP) would oversubscribe the cores many times over.
torch.set_num_threads(1)

BS = 128
N_BATCHES = 3
STAGES = ("score", "rescue", "emit")
# every span of a paired stream whose batches carry qualities, once the
# fragment model is final; cap.upload is the card's alone
SPANS = ("score", "score.encode", "score.seed", "score.mem", "score.wire",
         "score.step", "rescue", "dev_wait", "rescue.begin", "cap.begin",
         "cap.inputs", "cap.apply", "cap.wait", "emit",
         "emit.rescue_finish", "emit.reselect", "emit.spans",
         "emit.native", "emit.slow", "emit.finalize", "wait.score_out",
         "wait.rescue_in", "wait.rescue_out", "wait.emit_in",
         "wait.emit_out")
CPU_SPANS = ("score", "rescue", "emit", "cap.begin", "cap.apply")
# parent: the spans whose sum lies inside it (per thread, so in sum)
CHILDREN = {
    "score": ("score.encode", "score.seed", "score.mem", "score.wire",
              "score.step"),
    "rescue": ("dev_wait", "rescue.begin", "cap.begin"),
    "cap.begin": ("cap.inputs",),
    "emit": ("emit.rescue_finish", "emit.reselect", "cap.apply",
             "emit.spans", "emit.finalize"),
    "emit.spans": ("emit.native", "emit.slow"),
}
TOL = 1e-3          # seconds: float sums of nested spans
# a thread's CPU clock may tick in 10 ms steps (seen on the card's host):
# a short span's CPU seconds may then read a tick above its wall seconds
CLOCK_TICK = 0.05


@pytest.fixture(scope="module")
def fx():
    rng = np.random.default_rng(18)
    g, results, vcf = chip_smoke.make_pangenome(rng, ref_len=40_000)
    haps = thread_haplotypes(g, results, vcf)
    idx = MinimizerIndex.build(haps)
    texts = chip_smoke.make_sample_texts(rng, haps)
    sim, _ = chip_smoke.simulate_pairs(rng, texts, (N_BATCHES + 1) * BS)

    def qual(n):
        return (rng.integers(2, 42, n) + 33).astype(np.uint8).tobytes(
            ).decode()

    pairs = [(Read(a.name, a.sequence, qual(len(a.sequence))),
              Read(b.name, b.sequence, qual(len(b.sequence))))
             for a, b in sim]
    pm = PairedGiraffeMapper(tg.GiraffeMapper(
        haps, idx, tg.GiraffeParams(batch_reads=BS), device="cpu"))
    batches = [pairs[i : i + BS] for i in range(0, len(pairs), BS)]
    # warm-up: the first batch finalizes the fragment model
    warm = [r for recs in map_pairs_encoded_mt(pm, iter(batches[:1]))
            for r in recs]
    assert pm.fragdist.finalized and len(warm) == 2 * BS
    return dict(pm=pm, batches=batches[1:])


def stream(pm, batches):
    """(records of each batch, the stage seconds the stream added)."""
    before = dict(pm.stage_seconds)
    recs = [[bytes(r) for r in out] for out in
            map_pairs_encoded_mt(pm, iter(batches), emitters=2)]
    after = dict(pm.stage_seconds)
    return recs, {k: v - before.get(k, 0.0) for k, v in after.items()}


def test_mapper_and_paired_share_one_dict(fx):
    pm = fx["pm"]
    assert pm.mapper.stage_clock is pm.stage_clock
    assert pm.stage_clock.counters is pm.stage_seconds
    bare = tg.GiraffeMapper(pm.mapper.haps, pm.mapper.index,
                            tg.GiraffeParams(batch_reads=BS), device="cpu")
    assert bare.stage_clock.counters == {}
    bare.score_reads([a for a, _ in fx["batches"][0]])
    assert {"score.encode", "score.seed"} <= set(bare.stage_clock.counters)
    assert bare.stage_clock.counters is not pm.stage_seconds


def test_stream_fills_every_span(fx):
    recs, delta = stream(fx["pm"], fx["batches"])
    assert [len(r) for r in recs] == [2 * len(b) for b in fx["batches"]]
    want = set(SPANS) | {s + ".cpu" for s in CPU_SPANS}
    assert want <= set(delta), sorted(want - set(delta))
    assert all(type(v) is float for v in fx["pm"].stage_seconds.values())
    for name in SPANS:
        assert delta[name] >= 0.0, name
    for stage in STAGES:
        assert delta[stage] > 0.0
    # the CPU run has no upload: the card's spans are its own
    assert "cap.upload" not in delta


def test_children_within_parents(fx):
    _, delta = stream(fx["pm"], fx["batches"])
    for parent, kids in CHILDREN.items():
        assert sum(delta[k] for k in kids) <= delta[parent] + TOL, parent
    # the caps' waits lie inside their begins and applies
    assert delta["cap.wait"] <= delta["cap.begin"] + delta["cap.apply"] \
        + TOL
    for name in CPU_SPANS:
        assert 0.0 <= delta[name + ".cpu"] <= delta[name] + CLOCK_TICK, name


def test_records_equal_with_profiler_on_and_off(fx):
    """Byte-equal records with the profiler off and on (CPU activity, all
    threads, shapes recorded so that the ranges keep their input); under
    it vg.score.seed nests inside vg.score on the seeder's thread, and
    each batch's stage ranges on the seeder, rescuer and emitter threads
    carry its sequence number."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    pm, batches = fx["pm"], fx["batches"]
    off, _ = stream(pm, batches)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True,
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        on, _ = stream(pm, batches)
    assert on == off
    ranges = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("vg."):
            seq = [x for x in e.concrete_inputs() if x is not None]
            ranges.append((e.name()[3:], e.start_ns(), e.end_ns(),
                           e.start_thread_id(), seq[0] if seq else None))
    names = {r[0] for r in ranges}
    assert {"score", "score.seed", "rescue", "emit", "cap.begin",
            "wait.score_out", "wait.emit_in"} <= names
    scores = [r for r in ranges if r[0] == "score"]
    seeds = [r for r in ranges if r[0] == "score.seed"]
    assert len(seeds) == 2 * len(batches)          # a mate each
    for _, s, e, tid, seq in seeds:
        assert any(ps <= s and e <= pe and ptid == tid and pseq == seq
                   for _, ps, pe, ptid, pseq in scores)
    for k in range(len(batches)):
        threads = {}
        for stage in STAGES:
            got = [r for r in ranges if r[0] == stage and r[4] == k]
            assert len(got) == 1, (stage, k)
            threads[stage] = got[0][3]
        assert threads["score"] != threads["rescue"] != threads["emit"]
        assert threads["score"] != threads["emit"]


def test_no_range_with_profiler_off(fx, monkeypatch):
    opened = []
    orig = stagetime._open_range
    monkeypatch.setattr(stagetime, "_open_range",
                        lambda *a: opened.append(a) or orig(*a))
    stream(fx["pm"], fx["batches"][:1])
    assert opened == []
    # and under the profiler a span is a range
    from torch.profiler import ProfilerActivity, profile

    clock = StageClock()
    clock.set_batch(3)
    with profile(activities=[ProfilerActivity.CPU]):
        with clock.span("x"):
            pass
    assert opened == [("vg.x", 3)]


def test_span_sums_wall_and_thread_cpu():
    """A sleep is wall time off the CPU, a spin is CPU time. Some hosts
    count a thread's CPU time in 10 ms ticks, so CPU and wall seconds are
    compared to within CLOCK_TICK."""
    clock = StageClock()
    with clock.span("sleep", cpu=True):
        time.sleep(0.3)
    c = time.thread_time()
    with clock.span("busy", cpu=True):
        while time.thread_time() - c < 0.3:
            pass
    d = clock.counters
    assert set(d) == {"sleep", "sleep.cpu", "busy", "busy.cpu"}
    assert d["sleep"] >= 0.3 and d["sleep.cpu"] <= CLOCK_TICK
    assert d["busy.cpu"] >= 0.3 - CLOCK_TICK
    assert d["busy.cpu"] <= d["busy"] + CLOCK_TICK
    before = dict(d)
    with clock.span("sleep"):
        pass
    assert d["sleep.cpu"] == before["sleep.cpu"]   # no cpu: no .cpu added
    assert d["sleep"] > before["sleep"]


def test_concurrent_spans_lose_no_update(monkeypatch):
    """More threads than cores adding to one key under a short switch
    interval: with a clock that advances by one on each read of its
    thread, every span adds exactly 1.0, and none is lost."""
    import sys
    import types

    def clock_of_each_thread():
        local = threading.local()

        def tick():
            local.t = getattr(local, "t", 0.0) + 1.0
            return local.t
        return tick

    monkeypatch.setattr(stagetime, "time", types.SimpleNamespace(
        perf_counter=clock_of_each_thread(),
        thread_time=clock_of_each_thread()))
    clock = StageClock()
    n, per = 32, 300

    def work():
        for _ in range(per):
            with clock.span("x", cpu=True):
                pass

    threads = [threading.Thread(target=work) for _ in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert clock.counters == {"x": float(n * per),
                              "x.cpu": float(n * per)}


class FakePaired:
    """Stages that sleep: `slow` names the one that takes 50 ms."""

    def __init__(self, slow):
        self.slow = slow
        self.stage_seconds = {}
        self.stage_clock = StageClock(self.stage_seconds)

    def _nap(self, stage):
        if stage == self.slow:
            time.sleep(0.05)

    def stage_score(self, batch):
        self._nap("score")
        return ("x", batch)

    def stage_rescue(self, item):
        self._nap("rescue")
        return item

    def stage_emit(self, item):
        self._nap("emit")
        return [b"r"] * len(item[1])

    def finish_encoded(self):
        return []


@pytest.mark.parametrize("slow", ["emit", "score"])
def test_queue_waits_follow_the_slow_stage(slow):
    """A 50 ms emitter fills the queues: the seeder waits on its put and
    the emitters never starve. A 50 ms seeder: the reverse."""
    pm = FakePaired(slow)
    n = 40 if slow == "emit" else 12
    out = list(map_pairs_encoded_mt(pm, ([(i, i)] for i in range(n)),
                                    emitters=2))
    assert len(out) == n
    w = pm.stage_seconds
    if slow == "emit":
        assert w["wait.score_out"] >= 0.3
        assert w["wait.emit_in"] < 0.1
    else:
        assert w["wait.emit_in"] >= 0.3
        assert w["wait.score_out"] < 0.1
    assert set(w) == {"wait.score_out", "wait.rescue_in", "wait.rescue_out",
                      "wait.emit_in", "wait.emit_out"}
