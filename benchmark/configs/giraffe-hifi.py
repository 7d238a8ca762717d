"""giraffe-hifi: `vg giraffe -b hifi` on the port.

Set-up: the inputs from the seed; the port's graph and haplotypes; the
long-read minimizer index as cmd_giraffe builds it for the preset (k 31,
w 50, weighted); LongReadMapper with LongReadParams.preset('hifi') and
the configuration's engine; warm-up on one batch. Window: batches of the
pool through map_batch_encoded, one after another, as the CLI's long-read
GAM branch sends them. Judge: a sample of the window's records, with the
longest read of each batch, against the plain reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

import fixture
import port
from window import rate
from reference.gam import decode as decode_record
from reference.graph import build_graph, build_haplotypes
from reference.judge import Scoring, judge as judge_record


@dataclass
class State:
    ref: str = ""
    variants: list = field(default_factory=list)
    haps_ref: object = None
    pool: object = None
    batches: list = None
    bases: list = None
    longest: list = None
    names: dict = None
    mapper: object = None


def setup(ctx) -> State:
    cfg, t = ctx.config, ctx.traffic
    st = State()
    rng = np.random.default_rng(ctx.seed)
    with ctx.part("inputs"):
        st.ref, st.variants = fixture.make_variants(
            rng, cfg["ref_length_bp"], cfg["snp_rate"], cfg["indel_rate"],
            cfg["samples"], cfg["variant_spacing_bp"])
        st.haps_ref = build_haplotypes(st.ref, st.variants, cfg["samples"])
        sample = fixture.make_sample(rng, st.haps_ref, t["sample_from"],
                                     t["novel_snp"], t["novel_indel"])
        n = t["batch_reads"] * t["pool_batches"]
        st.pool = fixture.simulate_long(rng, sample, st.haps_ref, n, t)
        st.batches = port.long_batches(st.pool)
        b = t["batch_reads"]
        lens = np.array([len(c) for c in st.pool.codes], np.int64)
        st.bases = [int(lens[i : i + b].sum()) for i in range(0, n, b)]
        st.longest = [int(np.argmax(lens[i : i + b])) for i in range(0, n, b)]
        st.names = {nm: i for i, nm in enumerate(st.pool.names)}
    ctx.log(f"pool: {len(st.batches)} batches of {t['batch_reads']} reads, "
            f"{sum(st.bases)} bases")
    port.install_long_read_hooks(ctx.tracer)
    from vg_tpu_torch.index.minimizer import MinimizerIndex
    from vg_tpu_torch.map.longread import LongReadMapper, LongReadParams

    with ctx.part("graph"):
        haps = port.build_pangenome(st.ref, st.variants, cfg)
    with ctx.part("index"):
        idx = MinimizerIndex.build(haps, k=cfg["minimizer_k"],
                                   w=cfg["minimizer_w"],
                                   weighted=cfg["minimizer_weighted"])
    with ctx.part("mapper"):
        params = LongReadParams.preset(cfg["preset"])
        params.engine = cfg["engine"]
        st.mapper = LongReadMapper(haps, idx, params, device=ctx.device)
    ctx.log(f"port: {haps.graph.node_count} nodes, {haps.count} haplotypes, "
            f"text {haps.total_len} bp, {idx.unique_count} minimizers")
    with ctx.part("warmup"):
        for i in range(cfg["warm_batches"]):
            st.mapper.map_batch_encoded(st.batches[i % len(st.batches)])
        ctx.sync()
    if ctx.trace and ctx.device == "cuda":
        with ctx.part("profiler"):
            ctx.tracer.warm()
    return st


def window(ctx, st: State) -> dict:
    t = ctx.traffic
    rng = np.random.default_rng([ctx.seed, 1])
    n = len(st.batches)
    first = int(rng.integers(0, n))
    sink = port.Sink(ctx.seed, t["judge_records_per_batch"])
    trace = ctx.tracer
    seconds = ctx.seconds
    pulls, bases = [], 0
    attempted = failed = 0
    trace.reset()
    setup_s = time.time() - ctx.t_start
    k = 0
    while True:
        now = time.perf_counter()
        if pulls and now - pulls[0] >= seconds:
            break
        if ctx.trace and ctx.device == "cuda" and pulls:
            trace.due(now, pulls[0], seconds)
        b = (first + k) % n
        pulls.append(now)
        recs = st.mapper.map_batch_encoded(st.batches[b])
        attempted += len(st.batches[b])
        got = [r for r in recs if r is not None] if recs else []
        failed += len(st.batches[b]) - len(got)
        if len(got) == len(st.batches[b]):
            bases += st.bases[b]
            sink.kept.append(bytes(recs[st.longest[b]]))
        sink.take(k, got)
        k += 1
    if trace.profiling:
        trace.stop()
    ctx.sync()
    t_end = time.perf_counter()
    mbps = rate(bases / 1e6, pulls[0], t_end)
    ctx.log(f"setup: {setup_s:.2f} s ({', '.join(f'{k} {v:.2f}' for k, v in ctx.parts.items())})")
    ctx.log(f"window: {len(pulls)} batches ({len(pulls) / n:.2f} cycles of "
            f"the {n}-batch pool), {sink.records} records, {bases} bases, "
            f"{sink.bytes} bytes, {t_end - pulls[0]:.3f} s")
    win = dict(setup_s=setup_s, attempted=attempted, failed=failed,
               records=sink.records, bases=bases, sink=sink,
               device_kind=ctx.notes.get("device_kind"),
               metrics={"lr_mbases_per_s": mbps})
    if ctx.trace and trace.events is not None:
        win["busy_s"] = trace.busy_seconds()
        win["trace_window_s"] = trace.wall
        win["breakdown"] = trace.breakdown()
    return win


def layer(ctx, st: State, win: dict) -> dict:
    return dict(bases=win["bases"], spans=dict(ctx.tracer.sums),
                busy_s=win.get("busy_s"),
                trace_window_s=win.get("trace_window_s"))


def release(st: State) -> None:
    st.mapper = None
    st.batches = None


def judge(ctx, st: State, win: dict, control: bool = False) -> list:
    """The numbers compared. With `control`, the reference's score summed
    in float16 stands in for the port's (the control of PERF.md §2)."""
    cfg, t = ctx.config, ctx.traffic
    g = build_graph(st.ref, st.variants, cfg["max_node_size"])
    score = Scoring(cfg["match"], cfg["mismatch"], cfg["gap_open"],
                    cfg["gap_extend"], cfg["full_length_bonus"])
    recs = win["sink"].kept
    bad_path = bad_score = placed = known = unknown = 0
    for b in recs:
        r = decode_record(b)
        i = st.names.get(r.name)
        if i is None:
            unknown += 1
            continue
        known += 1
        v = judge_record(r, st.pool.codes[i], g, score)
        if not v.path_ok:
            if not bad_path:
                ctx.log(f"first invalid path: {r.name}: {v.why}")
            bad_path += 1
            continue
        if control and v.mapped:
            r.score = judge_record(r, st.pool.codes[i], g, score,
                                   np.float16).score
        if v.mapped and v.score != r.score:
            bad_score += 1
        if v.mapped and abs(v.leftmost - st.pool.truth[i]) <= \
                t["placement_tolerance_bp"]:
            placed += 1
    ctx.log(f"judged: {len(recs)} records, {known - placed} of {known} "
            f"not placed within {t['placement_tolerance_bp']} bp of the "
            f"truth")
    return [("records_missing", win["failed"], 0),
            ("records_unknown", unknown, 0),
            ("path_invalid", bad_path, 0),
            ("score_differs", bad_score, 0),
            ("misplaced_share", 1.0 - placed / known if known else 1.0,
             MISPLACED_LIMIT)]


# As giraffe-sr's: every sampled record placed on every run at 4 Mbp
# (PERF.md, Open questions); a record emitted unmapped is not.
MISPLACED_LIMIT = 0.01
