"""The benchmark's pieces on the CPU: its generators, window arithmetic,
idle share, work counts, and its plain reference against hand cases and
against the port's own plain versions."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import tiny  # noqa: F401  (puts benchmark/ and the repo on the path)
import fixture
import roofline
import window
from reference import cap as ref_cap
from reference import dp as ref_dp
from reference.gam import decode as decode_record
from reference.graph import build_graph, build_haplotypes, encode
from reference.judge import judge
from spans import merged, union_length

torch.set_num_threads(1)
PAIRS = {"read_length": 150, "fragment_mean": 450, "fragment_sd": 50,
         "batch_pairs": 16, "qualities": {"bins": [2, 12, 23, 37],
                                          "share_5p": [.002, .02, .06, .918],
                                          "share_3p": [.014, .1, .16, .726]}}
LONG = {"length_mean": 3000, "length_sd": 500, "length_min": 2000,
        "length_max": 4000, "sub_rate": .001, "indel_rate": .001,
        "indel_max": 2, "base_quality": 40, "error_quality": 15,
        "batch_reads": 4}


def inputs(seed, n_pairs=32, n_long=6):
    rng = np.random.default_rng(seed)
    ref, vs = fixture.make_variants(rng, 60_000, .001, .0005, 2, 40)
    haps = build_haplotypes(ref, vs, 2)
    sample = fixture.make_sample(rng, haps, [1, 3], .0005, .00005)
    pairs = fixture.simulate_pairs(rng, sample, haps, n_pairs, PAIRS)
    longs = fixture.simulate_long(rng, sample, haps, n_long, LONG)
    return ref, vs, haps, sample, pairs, longs


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_generators_deterministic(seed):
    a, b, c = inputs(seed), inputs(seed), inputs(seed + 1)
    assert a[0] == b[0] and a[0] != c[0]
    assert [v.__dict__ for v in a[1]] == [v.__dict__ for v in b[1]]
    for x, y in zip(a[3], b[3]):
        assert np.array_equal(x.text, y.text)
    assert np.array_equal(a[4].codes, b[4].codes)
    assert np.array_equal(a[4].quals, b[4].quals)
    assert np.array_equal(a[4].truth, b[4].truth)
    assert all(np.array_equal(x, y) for x, y in zip(a[5].codes, b[5].codes))
    assert not np.array_equal(a[4].codes, c[4].codes)


def test_long_lengths_same_for_every_seed():
    la = sorted(len(c) for c in inputs(3)[5].codes)
    lb = sorted(len(c) for c in inputs(4)[5].codes)
    want = sorted(fixture.clipped_normal_lengths(6, LONG))
    # indels move a read's length by a few bases at most
    assert all(abs(x - w) < 40 and abs(y - w) < 40
               for x, y, w in zip(la, lb, want))


def test_pair_truth_is_the_reads_place():
    ref, vs, haps, sample, pairs, _ = inputs(6)
    ref_codes = encode(ref)
    # mates without novel indels nearby match the reference at their truth
    # in most bases
    ok = 0
    for i in range(0, len(pairs.codes), 2):
        c, t = pairs.codes[i], pairs.truth[i]
        ok += np.mean(ref_codes[t : t + 150] == c) > 0.9
    assert ok >= 0.8 * len(pairs.codes) // 2


def test_quality_bins_share():
    rng = np.random.default_rng(0)
    q = fixture.quality_bins(rng, 4000, 150, PAIRS["qualities"])
    assert set(np.unique(q)) <= {2, 12, 23, 37}
    p = 10.0 ** (-q.astype(np.float64) / 10.0)
    assert 0.005 < p.mean() < 0.015           # about 1% over a read
    assert (q[:, :10] == 37).mean() > (q[:, -10:] == 37).mean()


def test_window_arithmetic():
    assert window.rate(300, 10.0, 13.0) == 100.0
    with pytest.raises(ValueError):
        window.rate(1, 2.0, 2.0)
    vals = list(range(1, 201))                 # 200 batches
    assert window.percentile(vals, 95) == 190  # ten beyond it
    assert window.percentile([5.0], 95) == 5.0
    lat = window.batch_latencies([0.0, 1.0, 2.0], [0.5, 2.0, 2.25])
    assert lat == [0.5, 1.0, 0.25]
    with pytest.raises(ValueError):
        window.batch_latencies([0.0, 1.0], [0.5])


def test_union_of_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (29, 31), (40, 40), (2, 3)]
    assert union_length(iv) == 15 + 11
    assert merged(iv)[:2] == [(0, 15), (20, 31)]
    assert union_length([]) == 0
    # the idle share a reader makes of it
    import harness

    mod = harness.load_module(tiny.BENCH / "metrics" /
                              "sr.device_idle_pct.py", "idle_reader")
    assert mod.read({"busy_s": 0.25, "trace_window_s": 1.0}) == 75.0
    assert mod.read({"busy_s": None, "trace_window_s": 1.0}) is None


def test_dp_work_counts_the_recurrence():
    R, RL, C, B = 3, 150, 4, 16
    rlen = torch.tensor([150, 100, 0], dtype=torch.int32)
    valid = torch.zeros((R, C), dtype=torch.bool)
    valid[0, :2] = True
    valid[1, 3] = True
    nbytes, ops = roofline.dp_work((R, RL), rlen, valid, B)
    assert ops == (2 * 150 + 100) * 33 * roofline.DP_OPS_PER_CELL
    assert nbytes == (2 * R * RL + 4 * R + R * C * 14 + 4 * R * C
                      + 3 * (RL + 2 * B) / 2)
    t = roofline.dp_least_seconds((R, RL), rlen, valid, B)
    assert t == max(nbytes / roofline.HBM_BYTES_PER_S,
                    ops / (6 * roofline.LANE_OPS_PER_S))


def cap_batch(seed, R=24, L=150):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    quals = rng.integers(2, 41, (R, L)).astype(np.uint8)
    keys = ref_cap.index_keys([codes[: R // 2].reshape(-1)], 29, 11)
    return codes, quals, keys


def test_cap_work_is_the_ports():
    from vg_tpu_torch.ops import cuda_mapqcap

    codes, quals, keys = cap_batch(1)
    R, L = codes.shape
    t = torch.from_numpy
    rlen = torch.full((R,), L, dtype=torch.int32)
    qb = t((quals.reshape(-1) + 33).astype(np.uint8))
    qoff = torch.arange(0, R * L + 1, L, dtype=torch.int64)
    kt = t(keys.view(np.int64))
    a = roofline.cap_work(t(codes), rlen, qb, qoff, kt, k=29, w=11)
    b = cuda_mapqcap.cap_work(t(codes), rlen, qb, qoff, kt, k=29, w=11)
    assert a[1:] == b[1:] and a[1] > 0 and a[2] > 0
    # the bytes: a key read a kept minimizer, where the port's count reads
    # them all
    lookups = int(roofline._minimizers(t(codes), rlen, kt, 29, 11)["n"].sum())
    assert 0 < lookups < len(keys)
    assert a[0] == b[0] - 8 * len(keys) + 8 * lookups


def test_reference_dp_hand_cases():
    B = 2
    text = encode("ACGTACGTAC")
    read = encode("ACGTAC")
    win = text[None, : 6 + 2 * B].copy()
    # the read sits at window column B: 6 matches and both bonuses
    win2 = np.concatenate([[6, 6], text[:6], [6, 6]])[None]
    assert ref_dp.banded_best(win2, read[None], np.array([6]), B)[0] == 16
    # one mismatch in the middle: 5 - 4 + 10
    r2 = read.copy()
    r2[3] = (r2[3] + 1) % 4
    assert ref_dp.banded_best(win2, r2[None], np.array([6]), B)[0] == 11
    # a read of nothing scores 0
    assert ref_dp.banded_best(win, read[None], np.array([0]), B)[0] == 0
    # a one-base deletion from the text costs open 6: 6 matches - 6 + 10
    t3 = np.concatenate([[6, 6], encode("ACGGTAC"), [6]])[None]
    assert ref_dp.banded_best(t3, read[None], np.array([6]), B)[0] == 10


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_dp_is_the_ports_plain_dp(seed):
    from vg_tpu_torch.ops.align import banded_dp

    rng = np.random.default_rng(seed)
    N, RL, B = 64, 40, 8
    win = rng.integers(0, 4, (N, RL + 2 * B)).astype(np.uint8)
    reads = win[:, B : B + RL].copy()
    mut = rng.random(reads.shape) < 0.1
    reads[mut] = rng.integers(0, 4, mut.sum())
    for i in range(0, N, 4):               # indels: shift a stretch
        a = int(rng.integers(5, RL - 10))
        reads[i, a:] = np.roll(reads[i, a:], 1 + i % 3)
    win[rng.random(win.shape) < 0.02] = 6
    rlen = rng.integers(0, RL + 1, N).astype(np.int32)
    got = ref_dp.banded_best(win, reads, rlen, B)
    t = torch.from_numpy
    want = banded_dp(t(win), t(reads), t(rlen), band_radius=B, match=1,
                     mismatch=4, gap_open=6, gap_extend=1, bonus=5)
    assert np.array_equal(got, want.numpy())


def test_reference_cap_hand_and_port():
    from vg_tpu_torch.map.mapqcap import explored_cap

    codes, quals, keys = cap_batch(2)
    ks = set(keys.tolist())
    count = lambda kk: np.array([1 if int(x) in ks else 0 for x in kk])
    for i in range(len(codes)):
        a = ref_cap.explored_cap(codes[i], quals[i], keys, 29, 11)
        b = explored_cap(codes[i], quals[i], 29, 11, count)
        assert (a == b) or (math.isinf(a) and math.isinf(b)) or \
            abs(a - b) < 1e-9
    # no quality: no cap; a read none of whose minimizers is kept: no cap
    assert math.isinf(ref_cap.explored_cap(codes[0], np.zeros(0, np.uint8),
                                           keys, 29, 11))
    assert math.isinf(ref_cap.explored_cap(codes[0], quals[0],
                                           np.zeros(1, np.uint64), 29, 11))
    # the float32 control departs from float64 somewhere on the batch
    gaps = [abs(ref_cap.explored_cap(codes[i], quals[i], keys, 29, 11)
                - ref_cap.explored_cap(codes[i], quals[i], keys, 29, 11,
                                       np.float32))
            for i in range(len(codes) // 2)]
    finite = [g for g in gaps if g == g and not math.isinf(g)]
    assert finite and max(finite) > 1e-6
    assert ref_cap.round_half_even(2.5) == 2 and \
        ref_cap.round_half_even(-3.2) == 0


def test_index_keys_are_the_ports():
    from vg_tpu_torch.index.minimizer import MinimizerIndex

    from port import build_pangenome

    ref, vs, haps, *_ = inputs(9)
    cfg = {"samples": 2, "max_node_size": 32}
    ph = build_pangenome(ref, vs, cfg)
    idx = MinimizerIndex.build(ph, k=29, w=11)
    want = np.unique(np.asarray(idx.keys, np.uint64)[
        np.diff(idx.offsets) > 0])
    assert np.array_equal(ref_cap.index_keys(haps.texts, 29, 11), want)
    assert np.array_equal(ref_cap.haplotype_keys(haps, 29, 11), want)


@pytest.mark.parametrize("k,w", [(29, 11), (31, 50), (15, 5), (5, 3)])
def test_haplotype_keys_are_every_texts(k, w):
    """The key set from the reference and the variants' neighbourhoods is
    the key set of every haplotype text, whatever the variants' spacing."""
    for seed, spacing in ((7, 40), (8, 3)):
        rng = np.random.default_rng(seed)
        ref, vs = fixture.make_variants(rng, 60_000, 0.01, 0.002, 3,
                                        spacing)
        haps = build_haplotypes(ref, vs, 3)
        assert np.array_equal(ref_cap.haplotype_keys(haps, k, w),
                              ref_cap.index_keys(haps.texts, k, w))


@pytest.mark.parametrize("k", [1, 2, 3, 7, 16, 29, 31, 32])
def test_doubling_kmers_are_rolling_kmers(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 5000).astype(np.uint8)
    codes[rng.random(5000) < 0.02] = 4
    for a, b in zip(ref_cap.rolling_kmers(codes, k),
                    ref_cap.doubling_kmers(codes, k)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_reference_graph_is_the_ports(seed):
    from port import build_pangenome

    ref, vs, haps, *_ = inputs(seed)
    g = build_graph(ref, vs, 32)
    ph = build_pangenome(ref, vs, {"samples": 2, "max_node_size": 32})
    pg = ph.graph
    ids = [int(x) for x in pg.node_id]
    assert sorted(ids) == sorted(g.seq)
    for i, nid in enumerate(ids):
        assert np.array_equal(pg.seq[pg.seq_start[i] : pg.seq_start[i + 1]],
                              g.seq[nid])
    edges = {(a, b) for a, ar, b, br in pg.iter_edges()}
    assert edges == g.edges
    assert np.array_equal(ph.text, haps.text)
    assert np.array_equal(ph.text_start, haps.starts)


def test_judge_hand_record():
    from vg_tpu_torch.io.gam import Alignment, Edit, Mapping, Path, Position

    ref = "ACGTTGCA" * 8
    g = build_graph(ref, [], 32)     # nodes 1, 2: 32 bases each
    read = encode(ref[20:44])
    rd = read.copy()
    rd[5] = (rd[5] + 1) % 4
    seqs = "ACGT"
    m1 = Mapping(Position(1, 20), [Edit(5, 5), Edit(1, 1, seqs[rd[5]]),
                                   Edit(6, 6)])
    m2 = Mapping(Position(2, 0), [Edit(12, 12)])
    aln = Alignment(sequence="", path=Path("", [m1, m2]), name="x",
                    score=23 - 4 + 10)
    r = decode_record(aln.encode())
    v = judge(r, rd, g)
    assert v.path_ok and v.score == 29 and v.leftmost == 20
    # the same with a soft clip at the start: no bonus there
    m1c = Mapping(Position(1, 21), [Edit(0, 1, seqs[rd[0]]), Edit(4, 4),
                                    Edit(1, 1, seqs[rd[5]]), Edit(6, 6)])
    v = judge(decode_record(Alignment(path=Path("", [m1c, m2]),
                                      name="x").encode()), rd, g)
    assert v.path_ok and v.score == 22 - 4 + 5
    # a step that is no edge, a base that does not match
    bad = Mapping(Position(1, 0), [Edit(12, 12)])
    v = judge(decode_record(Alignment(path=Path("", [m1, bad]),
                                      name="x").encode()), rd, g)
    assert not v.path_ok
    v = judge(decode_record(aln.encode()), read, g)
    assert not v.path_ok
    # float16 sums lose integers past 2048: the control's scores
    assert int(np.float16(2049)) != 2049
