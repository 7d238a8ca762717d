"""giraffe-sr: `vg giraffe` paired-end, default preset, on the port.

Set-up: the inputs from the seed; the port's graph, haplotypes,
minimizer index and MEM fallback index; GiraffeMapper with GiraffeParams
as cmd_giraffe sets them for the preset and the cell's batch, and
PairedGiraffeMapper over it (cli/main.py's paired GAM branch); warm-up
through map_pairs_encoded_mt. Window: map_pairs_encoded_mt with the
CLI's thread counts over a closed loop of batches cycled from the pool.
Judge: a sample of the window's records, two of its DP calls and one of
its MAPQ-cap calls, against the plain reference.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

import fixture
import port
from window import batch_latencies, percentile, rate
from reference import cap as ref_cap
from reference import dp as ref_dp
from reference.gam import decode as decode_record
from reference.graph import build_graph, build_haplotypes, revcomp
from reference.judge import Scoring, judge as judge_record


@dataclass
class State:
    ref: str = ""
    variants: list = field(default_factory=list)
    haps_ref: object = None
    pool: object = None
    batches: list = None
    names: dict = None
    pm: object = None
    capture: object = None
    stage0: dict = None


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
        n_pairs = t["batch_pairs"] * t["pool_batches"]
        st.pool = fixture.simulate_pairs(rng, sample, st.haps_ref, n_pairs, t)
        st.batches = port.pair_batches(st.pool)
        st.names = {n: i for i, n in enumerate(st.pool.names)}
    ctx.log(f"pool: {len(st.batches)} batches of {t['batch_pairs']} pairs "
            f"({2 * n_pairs} reads)")
    st.capture = port.Capture()
    port.install_short_read_hooks(st.capture, ctx.tracer)
    from vg_tpu_torch.index.minimizer import MinimizerIndex
    from vg_tpu_torch.map.giraffe import GiraffeMapper, GiraffeParams
    from vg_tpu_torch.map.memmapper import MEMIndex
    from vg_tpu_torch.map.paired import PairedGiraffeMapper
    from vg_tpu_torch.parallel.pipeline import map_pairs_encoded_mt

    with ctx.part("graph"):
        haps = port.build_pangenome(st.ref, st.variants, cfg)
    with ctx.part("index"):
        idx = MinimizerIndex.build(haps, k=cfg["minimizer_k"],
                                   w=cfg["minimizer_w"])
        # the MEM fallback's suffix array, as GiraffeMapper builds it on
        # its first read without candidates: here, outside the window
        mem = MEMIndex(haps, max_mem_hits=max(64, 4 * haps.count))
    with ctx.part("mapper"):
        params = GiraffeParams(max_candidates=cfg["max_candidates"],
                               batch_reads=t["batch_pairs"])
        mapper = GiraffeMapper(haps, idx, params, device=ctx.device)
        mapper._mem_fallback_index = mem
        st.pm = PairedGiraffeMapper(mapper)
    ctx.log(f"port: {haps.graph.node_count} nodes, {haps.count} haplotypes, "
            f"text {haps.total_len} bp, {idx.unique_count} minimizers")
    with ctx.part("warmup"):
        n = len(st.batches)
        for _ in map_pairs_encoded_mt(
                st.pm, (st.batches[i % n] for i in range(cfg["warm_batches"])),
                seeders=cfg["seeders"], emitters=cfg["emitters"]):
            pass
        ctx.sync()
    if ctx.trace and ctx.device == "cuda":
        with ctx.part("profiler"):
            port.time_launches()
            ctx.tracer.warm()
    return st


def window(ctx, st: State) -> dict:
    from vg_tpu_torch.parallel.pipeline import map_pairs_encoded_mt

    cfg, t = ctx.config, ctx.traffic
    rng = np.random.default_rng([ctx.seed, 1])
    # calls of the window's first batches (two DP calls and two cap calls
    # a batch, one a mate), after the first
    st.capture.calls.clear()
    st.capture.pick("dp", rng.choice(np.arange(2, 12), t["judge_dp_calls"],
                                     replace=False))
    st.capture.pick("cap", rng.choice(np.arange(2, 12),
                                      t["judge_cap_calls"], replace=False))
    sink = port.Sink(ctx.seed, t["judge_records_per_batch"])
    pulls, dones = [], []
    n = len(st.batches)
    first = int(rng.integers(0, n))
    seconds = ctx.seconds
    trace = ctx.tracer

    def source():
        i = 0
        while True:
            now = time.perf_counter()
            if pulls and now - pulls[0] >= seconds:
                return
            pulls.append(now)
            yield st.batches[(first + i) % n]
            i += 1

    st.stage0 = dict(st.pm.stage_seconds)
    trace.reset()
    st.capture.in_window = True
    setup_s = time.time() - ctx.t_start
    for k, recs in enumerate(map_pairs_encoded_mt(
            st.pm, source(), seeders=cfg["seeders"],
            emitters=cfg["emitters"])):
        now = time.perf_counter()
        if k < len(pulls):
            dones.append(now)
        else:                         # the pipeline's tail: the last batch's
            dones[-1] = now
        sink.take(k, recs)
        if ctx.trace and ctx.device == "cuda":
            trace.due(now, pulls[0], seconds)
    if trace.profiling:
        trace.stop()
    ctx.sync()
    t_end = time.perf_counter()
    st.capture.in_window = False
    stage1 = dict(st.pm.stage_seconds)
    ctx.log(f"calls in the window: {st.capture.calls}")
    lat = batch_latencies(pulls, dones)
    attempted = 2 * sum(len(st.batches[(first + i) % n])
                        for i in range(len(pulls)))
    reads_per_s = rate(sink.records, pulls[0], t_end)
    p95 = percentile(lat, 95) * 1e3
    # the tail of the batches that neither the traced stretch nor the
    # profiler's start and stop touched
    lo, hi = trace.span_window()
    clear = [x for p, d, x in zip(pulls, dones, lat) if d < lo or p > hi]
    score_ms = (stage1["score"] - st.stage0.get("score", 0)) / len(pulls) \
        * 1e3
    ctx.log(f"setup: {setup_s:.2f} s ({', '.join(f'{k} {v:.2f}' for k, v in ctx.parts.items())})")
    ctx.log(f"window: {len(pulls)} batches pulled ({len(pulls) / n:.2f} "
            f"cycles of the {n}-batch pool), {sink.records} records, "
            f"{sink.bytes} bytes, {t_end - pulls[0]:.3f} s; batch latency "
            f"p50 {percentile(lat, 50) * 1e3:.1f} ms p95 {p95:.1f} ms over "
            f"{len(lat)} batches ({len(clear)} outside a traced stretch); "
            f"stage seconds "
            + ", ".join(f"{k} {stage1[k] - st.stage0.get(k, 0):.3f}"
                        for k in stage1)
            + f"; score {score_ms:.1f} ms a batch")
    win = dict(setup_s=setup_s, attempted=attempted,
               failed=attempted - sink.records, records=sink.records,
               sink=sink, stage_delta={k: stage1[k] - st.stage0.get(k, 0)
                            for k in stage1},
               device_kind=ctx.notes.get("device_kind"),
               batch_p95_ms=percentile(clear, 95) * 1e3 if clear else None,
               batches_clear=len(clear),
               metrics={"sr_reads_per_s": reads_per_s})
    if ctx.trace and trace.events is not None:
        win["busy_s"] = trace.busy_seconds()
        win["trace_window_s"] = trace.wall
        win["breakdown"] = trace.breakdown()
    return win


def layer(ctx, st: State, win: dict) -> dict:
    """What the per-layer readers of this configuration read."""
    import roofline

    tr = ctx.tracer
    out = dict(reads=win["records"], stage_delta=win["stage_delta"],
               batch_p95_ms=win["batch_p95_ms"],
               batches_clear=win["batches_clear"],
               spans=dict(tr.sums), busy_s=win.get("busy_s"),
               trace_window_s=win.get("trace_window_s"))
    if tr.events is not None:
        dp_s = tr.span_device_seconds("dp")
        cap_s = tr.span_device_seconds("cap")
        dp_least = sum(roofline.dp_least_seconds(*p)
                       for p in tr.payloads.get("dp", ()))
        cap_least = sum(roofline.cap_least_seconds(*p)
                        for p in tr.payloads.get("cap", ()))
        out.update(dp_device_s=dp_s, dp_least_s=dp_least,
                   cap_device_s=cap_s, cap_least_s=cap_least)
    return out


def release(st: State) -> None:
    st.pm = None
    st.batches = None


def judge(ctx, st: State, win: dict, control: bool = False) -> list:
    """The numbers compared. With `control`, the reference in float32
    stands in for the port's MAPQ caps (the control of PERF.md §2)."""
    cfg, t = ctx.config, ctx.traffic
    g = build_graph(st.ref, st.variants, cfg["max_node_size"])
    score = Scoring(cfg["match"], cfg["mismatch"], cfg["gap_open"],
                    cfg["gap_extend"], cfg["full_length_bonus"])
    pool = st.pool
    recs = win["sink"].kept
    bad_path = bad_score = placed = known = 0
    unknown = 0
    mapq_of = {}
    for b in recs:
        r = decode_record(b)
        i = st.names.get(r.name)
        if i is None:
            unknown += 1
            continue
        known += 1
        v = judge_record(r, pool.codes[i], g, score)
        if not v.path_ok:
            if not bad_path:
                ctx.log(f"first invalid path: {r.name}: {v.why}")
            bad_path += 1
            continue
        if v.mapped and v.score != r.score:
            bad_score += 1
        if v.mapped and abs(v.leftmost - pool.truth[i]) <= \
                t["placement_tolerance_bp"]:
            placed += 1
        mapq_of[i] = r.mapq
    # sampled records of the pool's reads that are not mapped with a valid
    # path within the tolerance of their truth
    misplaced = 1.0 - placed / known if known else 1.0
    checks = [("records_missing", win["failed"], 0),
              ("records_unknown", unknown, 0),
              ("path_invalid", bad_path, 0),
              ("score_differs", bad_score, 0),
              ("misplaced_share", misplaced, MISPLACED_LIMIT),
              ("dp_slots_differ", dp_bad_of(st, cfg), 0)]
    ctx.log(f"judged: {len(recs)} records, {known - placed} of {known} "
            f"not placed within {t['placement_tolerance_bp']} bp of the "
            f"truth")
    if pool.quals is None:      # no qualities: the cap is not on the path
        return checks
    keys = ref_cap.haplotype_keys(st.haps_ref, cfg["minimizer_k"],
                                  cfg["minimizer_w"])
    k, w = cfg["minimizer_k"], cfg["minimizer_w"]
    # the emitted MAPQs against the reference's cap, rounded as the port
    # rounds it
    over_cap = 0
    rng = np.random.default_rng([ctx.seed, 2])
    idx = sorted(mapq_of)
    if len(idx) > t["judge_cap_reads"]:
        idx = sorted(rng.choice(idx, t["judge_cap_reads"], replace=False))
    for i in idx:
        c = ref_cap.explored_cap(pool.codes[i], pool.quals[i], keys, k, w)
        if np.isfinite(c) and mapq_of[i] > ref_cap.round_half_even(c):
            over_cap += 1
    cap_gap = cap_gap_of(st, keys, k, w, rng, t["judge_cap_reads"],
                         control)
    ctx.log(f"judged: {len(idx)} MAPQs against the cap")
    return checks + [("mapq_over_cap", over_cap, 0),
                     ("cap_gap_phred", cap_gap, CAP_GAP_LIMIT)]


# Set from its two readings on an NVIDIA H100 at the cell's size (PERF.md
# §2): sound runs place every sampled record; records emitted unmapped,
# or under their mate's name, place none.
MISPLACED_LIMIT = 0.01

# Set from its two readings on an NVIDIA H100 at the cell's size: the
# port's caps lie 2.8e-14 to 7.1e-14 phred from the reference's on every
# seed (CUDA's pow and log10 against the C library's); the float32 control
# lies 5.0e-5 to 5.5e-4 from it.
CAP_GAP_LIMIT = 1e-8


def cap_gap_of(st: State, keys, k, w, rng, n_reads, control=False):
    """Widest gap, in phred, between the port's caps (before rounding)
    and the reference's on a sample of the picked call's reads; inf where
    a call was not captured or a read is unknown, or where one side is
    finite and the other not. With `control`, the reference's cap in
    float32 takes the port's place."""
    kept = st.capture.kept.get("cap") or []
    if not kept:
        return float("inf")
    gap = 0.0
    for names, caps in kept:
        caps = caps.cpu().numpy()
        if names is None or len(names) != len(caps):
            return float("inf")
        pick = rng.choice(len(names), min(n_reads, len(names)),
                          replace=False)
        for j in pick:
            i = st.names.get(names[int(j)])
            if i is None:
                return float("inf")
            c = ref_cap.explored_cap(st.pool.codes[i], st.pool.quals[i],
                                     keys, k, w)
            p = float(caps[int(j)]) if not control else ref_cap.explored_cap(
                st.pool.codes[i], st.pool.quals[i], keys, k, w, np.float32)
            if np.isnan(c) or np.isnan(p):
                if not (np.isnan(c) and np.isnan(p)):
                    return float("inf")
            elif np.isinf(c) or np.isinf(p):
                if c != p:
                    return float("inf")
            else:
                gap = max(gap, abs(c - p))
    return gap


def dp_bad_of(st: State, cfg: dict, max_slots: int = 4096) -> int:
    """Slots of the picked DP calls whose score differs from the plain
    DP's on the reference's own text: the read must be one of the pool's,
    and the window is cut to the haplotype the candidate starts in."""
    kept = st.capture.kept.get("dp") or []
    if len(kept) < 1:
        return 1 << 30
    text = st.haps_ref.text
    starts = st.haps_ref.starts
    known = {st.pool.codes[i].tobytes() for i in range(len(st.pool.codes))}
    bad = 0
    rng = np.random.default_rng(0)
    for reads, rlen, cstart, crev, cvalid, out, kw in kept:
        reads, rlen = reads.cpu().numpy(), rlen.cpu().numpy()
        cstart, crev = cstart.cpu().numpy(), crev.cpu().numpy()
        cvalid, out = cvalid.cpu().numpy(), out.cpu().numpy()
        B = kw.get("band_radius", cfg["band_radius"])
        R, RL = reads.shape
        rr, cc = np.nonzero(cvalid[:R])
        if len(rr) > max_slots:
            sel = rng.choice(len(rr), max_slots, replace=False)
            rr, cc = rr[sel], cc[sel]
        rows = np.zeros((len(rr), RL), np.uint8)
        for s, (r, c) in enumerate(zip(rr, cc)):
            codes = reads[r, : rlen[r]]
            if codes.tobytes() not in known:
                bad += 1
            o = revcomp(codes) if crev[r, c] else codes
            rows[s, : len(o)] = o
            rows[s, len(o):] = 5
        st0 = cstart[rr, cc].astype(np.int64)
        h = np.searchsorted(starts, st0 + B, side="right") - 1
        lo, hi = starts[np.clip(h, 0, len(starts) - 2)], \
            starts[np.clip(h + 1, 1, len(starts) - 1)]
        pos = st0[:, None] + np.arange(RL + 2 * B)
        ok = (pos >= lo[:, None]) & (pos < hi[:, None])
        win = np.where(ok, text[np.clip(pos, 0, len(text) - 1)], 6)
        ref = ref_dp.banded_best(win, rows, rlen[rr], B, cfg["match"],
                                 cfg["mismatch"], cfg["gap_open"],
                                 cfg["gap_extend"], cfg["full_length_bonus"])
        bad += int((ref != out[rr, cc]).sum())
    return bad
