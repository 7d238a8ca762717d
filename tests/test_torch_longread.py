"""The port's long-read mapping (vg_tpu_torch.map.longread, ops/global_align,
map/chain, ops/device_links, ops/device_chain) against the JAX package's,
on the CPU, on tests/test_longread.py's long_setup graph (200 kb
reference) built with vg_tpu and carried across with
vg_tpu_torch.convert.state_from_arrays.

Exact everywhere (integer DP, byte-identical GAM records), except the
float32 chain-DP twin at parameters that float32 cannot represent
exactly: there f agrees within rtol 1e-5 / atol 1e-3 and parents agree
where vg_tpu's test_device_chain_dp_parity requires them to."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vg_tpu.construct.constructor import Constructor, ConstructorParams
from vg_tpu.index.haplotypes import thread_haplotypes
from vg_tpu.index.minimizer import MinimizerIndex
from vg_tpu.io import native as jax_native
from vg_tpu.io.fastq import Read
from vg_tpu.io.vcf import VcfFile, VcfRecord
from vg_tpu.map import chain as j_chain
from vg_tpu.map.longread import LongReadMapper as JaxLongRead
from vg_tpu.map.longread import LongReadParams as JaxParams
from vg_tpu.ops import device_chain as j_dchain
from vg_tpu.ops import device_links as j_links
from vg_tpu.ops import global_align as j_global
from vg_tpu.ops.pallas_align import pack_text as jax_pack_text
from vg_tpu.utils import dna
from vg_tpu_torch.convert import state_from_arrays
from vg_tpu_torch.io.fastq import Read as TorchRead
from vg_tpu_torch.map import chain as t_chain
from vg_tpu_torch.map import longread as t_longread
from vg_tpu_torch.map.longread import LongReadMapper as TorchLongRead
from vg_tpu_torch.map.longread import LongReadParams as TorchParams
from vg_tpu_torch.ops import cuda_align
from vg_tpu_torch.ops import cuda_links
from vg_tpu_torch.ops import device_chain as t_dchain
from vg_tpu_torch.ops import device_links as t_links
from vg_tpu_torch.ops import global_align as t_global
from vg_tpu_torch.ops import link_cases
from vg_tpu_torch.ops import pass_cases
from vg_tpu_torch.ops.align import DEFAULT_SCORING
from vg_tpu_torch.ops.link_cases import synthetic_links

# The suite runs in several worker processes at once: torch's intra-op
# threads (spinning OpenMP) would oversubscribe the cores many times over.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def long_setup(tmp_path_factory):
    """tests/test_longread.py's long_setup, and its port twin."""
    rng = np.random.default_rng(1)
    ref_codes = rng.integers(0, 4, 200000).astype(np.uint8)
    ref_seq = dna.decode(ref_codes)
    pos = np.sort(rng.choice(np.arange(100, 199900), 300, replace=False))
    pos = pos[np.concatenate([[True], np.diff(pos) > 50])]
    recs = []
    for p in pos:
        p = int(p)
        r = ref_seq[p]
        alt = "ACGT"[("ACGT".index(r) + 1) % 4]
        recs.append(VcfRecord("r", p + 1, ".", r, [alt], ".", ".", {},
                              [((int(rng.integers(0, 2)),
                                 int(rng.integers(0, 2))), True)]))
    vcf = VcfFile(samples=["s"], records=recs)
    g, results = Constructor(ConstructorParams(
        max_node_size=32)).construct_graph({"r": ref_seq}, vcf)
    haps = thread_haplotypes(g, results, vcf)
    idx = MinimizerIndex.build(haps)
    d = tmp_path_factory.mktemp("index")
    jax_native.save_graph(str(d / "g.npz"), g)
    jax_native.save_haplotypes(str(d / "h.npz"), haps)
    jax_native.save_minimizer(str(d / "m.npz"), idx)
    _, t_haps, t_idx = state_from_arrays(
        *(dict(np.load(d / f)) for f in ("g.npz", "h.npz", "m.npz")))
    return haps, idx, t_haps, t_idx


def link_reads(haps):
    """test_longread.py::test_device_link_engine_parity's 24 reads (6 kb,
    1% substitutions, five indels of 1-14 bp, every other one reverse)."""
    rng = np.random.default_rng(17)
    T = len(haps.text)
    reads = []
    for i in range(24):
        s = int(rng.integers(0, T - 6200))
        c = haps.text[s : s + 6000].copy()
        err = rng.random(len(c)) < 0.01
        c[err] = (c[err] + rng.integers(1, 4, int(err.sum()))) % 4
        for _ in range(5):
            q = int(rng.integers(100, len(c) - 100))
            n = int(rng.integers(1, 15))
            if rng.random() < 0.5:
                c = np.concatenate(
                    [c[:q], rng.integers(0, 4, n).astype(np.uint8), c[q:]])
            else:
                c = np.concatenate([c[:q], c[q + n :]])
        if i % 2:
            c = dna.revcomp_codes(c)
        reads.append(dna.decode(c))
    return reads


def as_reads(seqs, cls):
    return [cls(f"dl{i}", s, "") for i, s in enumerate(seqs)]


@pytest.fixture(scope="module")
def device_tasks(long_setup):
    """The port's device engine on the 24 reads (device="cpu"): its
    records, the slow-link tasks handed to align_runs_blob as vg_tpu's
    device engine hands them to align_runs_arrays (oriented_rows) and each
    bucket's padded engine inputs."""
    _, _, t_haps, t_idx = long_setup
    m = TorchLongRead(t_haps, t_idx, TorchParams(engine="device"),
                      device="cpu")
    dla = m._device_aligner()
    seen = {"runs": [], "engine": {}}
    runs_fn, engine_fn = dla.align_runs_blob, dla._engine

    def runs(*a):
        seen["runs"].append(a)
        return runs_fn(*a)

    def engine(*a, **kw):
        seen["engine"][a[5]] = (a[0].numpy().view(np.uint32),) + tuple(
            x.numpy() for x in a[1:5]) + (a[5],)
        return engine_fn(*a, **kw)

    dla.align_runs_blob, dla._engine = runs, engine
    recs = m.map_batch_encoded(as_reads(link_reads(t_haps), TorchRead))
    assert len(seen["runs"]) == 1 and set(seen["engine"]) == {256, 768}
    return recs, oriented_rows(*seen["runs"][0], max(dla.buckets)), \
        seen["engine"]


def oriented_rows(blob, read_off, task_read, task_rev, ra, la, ta, lb,
                  cap):
    """(a_rows, la, ta, lb) as vg_tpu's LongReadMapper._device_batch
    builds them for align_runs_arrays (ops/pass_cases.oriented_rows)."""
    return pass_cases.oriented_rows(blob.numpy(), read_off, task_read,
                                    task_rev, ra, la, cap), la, ta, lb


def edits_key(res):
    """(score, edits) with the edits' base arrays as lists."""
    if res is None:
        return None
    score, edits = res
    return score, [tuple(x.tolist() if isinstance(x, np.ndarray) else x
                         for x in e) for e in edits]


def test_global_align_equals_jax():
    rng = np.random.default_rng(4)
    cases = [(np.zeros(0, np.uint8), np.zeros(0, np.uint8)),
             (np.zeros(0, np.uint8), rng.integers(0, 4, 7).astype(np.uint8)),
             (rng.integers(0, 4, 5).astype(np.uint8), np.zeros(0, np.uint8))]
    for _ in range(40):
        a = rng.integers(0, 5, int(rng.integers(1, 300))).astype(np.uint8)
        b = list(a)
        for _ in range(int(rng.integers(0, 6))):
            p = int(rng.integers(0, max(1, len(b))))
            kind = rng.integers(0, 3)
            if kind == 0 and b:
                b[p] = int(rng.integers(0, 4))
            elif kind == 1:
                b[p:p] = list(rng.integers(0, 4, int(rng.integers(1, 40))))
            elif kind == 2 and b:
                del b[p : p + int(rng.integers(1, 40))]
        cases.append((a, np.array(b or [0], np.uint8)))
    for a, b in cases:
        want = j_global.global_align(a, b)
        got = t_global.global_align(a, b)
        assert edits_key(got) == edits_key(want), (len(a), len(b))
    # over the cell cap both refuse
    big = np.zeros(3000, np.uint8)
    assert t_global.global_align(big, big, max_cells=1000) is None


def random_anchors(rng, n, tmax, rmax):
    tpos = np.sort(rng.integers(0, tmax, n)).astype(np.int64)
    roff = rng.integers(0, rmax, n).astype(np.int64)
    order = np.lexsort((roff, tpos))
    return roff[order], tpos[order], rng.integers(1, 30, n).astype(float)


def test_chain_dp_equals_jax():
    rng = np.random.default_rng(6)
    for params in (dict(), dict(gap_scale=0.125, lookback_cands=16)):
        jp, tp = j_chain.ChainParams(**params), t_chain.ChainParams(**params)
        for n in (1, 2, 57, 300):
            roff, tpos, score = random_anchors(rng, n, 30000, 9500)
            fj, pj = j_chain.chain_anchors(roff, tpos, score, jp)
            ft, pt = t_chain.chain_anchors(roff, tpos, score, tp)
            np.testing.assert_array_equal(ft, fj)
            np.testing.assert_array_equal(pt, pj)
            for rev in (False, True):
                cj = j_chain.find_chains(roff, tpos, score, rev, jp)
                ct = t_chain.find_chains(roff, tpos, score, rev, tp)
                assert len(ct) == len(cj)
                for a, b in zip(ct, cj):
                    assert (a.score, a.read_start, a.read_end, a.text_start,
                            a.text_end, a.is_rev) == (
                        b.score, b.read_start, b.read_end, b.text_start,
                        b.text_end, b.is_rev)
                    np.testing.assert_array_equal(a.anchors, b.anchors)


def scoring_kw(scoring=None):
    """DEFAULT_SCORING, or a (match, mismatch, gap_open, gap_extend)
    tuple, as the engines' keywords."""
    if scoring is None:
        sc = DEFAULT_SCORING
        scoring = (sc.match, sc.mismatch, sc.gap_open, sc.gap_extend)
    return dict(zip(("match", "mismatch", "gap_open", "gap_extend"),
                    scoring))


def jax_engine(arrs, RMAX, text_packed, T, B=16, scoring=None):
    a4, la, ta, ba, lb = arrs
    out = j_links.link_engine()(
        jnp.asarray(a4.view(np.int32)), jnp.asarray(la), jnp.asarray(ta),
        jnp.asarray(ba), jnp.asarray(lb), jnp.asarray(text_packed),
        RMAX=RMAX, WB=4 * B + 1, T=T, **scoring_kw(scoring))
    return [np.asarray(x) for x in out]


def torch_engine(arrs, RMAX, text_packed, T, B=16):
    a4, la, ta, ba, lb = arrs
    sc = DEFAULT_SCORING
    put = torch.from_numpy
    out = t_links.link_engine(
        put(a4.view(np.int32)), put(la), put(ta), put(ba), put(lb),
        put(text_packed), RMAX=RMAX, WB=4 * B + 1, T=T, match=sc.match,
        mismatch=sc.mismatch, gap_open=sc.gap_open,
        gap_extend=sc.gap_extend)
    return [x.numpy() for x in out]


def assert_plain_equal_jax(arrs, RMAX, text_packed, T, B=16,
                           scoring=None):
    """The plain fill (its scores) and the plain walk (on the fill's bits)
    each equal vg_tpu's link_engine, and so does link_engine (the two
    composed) on the CPU."""
    want = jax_engine(arrs, RMAX, text_packed, T, B, scoring)
    a4, la, ta, ba, lb = (torch.from_numpy(x) for x in arrs)
    kw = dict(RMAX=RMAX, WB=4 * B + 1, T=T, **scoring_kw(scoring))
    tp = torch.from_numpy(text_packed)
    score, bits = cuda_links.link_fill_ref(a4.view(torch.int32), la, ta, ba,
                                           lb, tp, **kw)
    assert bits.shape == (len(la), RMAX + 1, 4 * B + 1)
    np.testing.assert_array_equal(score.numpy(), want[0], err_msg="fill")
    walk = cuda_links.link_walk_ref(bits, la, ba, lb)
    assert_engine_equal([score.numpy()] + [x.numpy() for x in walk], want)
    got = t_links.link_engine(a4.view(torch.int32), la, ta, ba, lb, tp,
                              **kw)
    assert_engine_equal([x.numpy() for x in got], want)
    return want


def assert_engine_equal(got, want):
    for name, g, w in zip(("score", "packed ops", "n_steps", "complete"),
                          got, want):
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("RMAX", [256, 768])
def test_link_engine_equals_jax(long_setup, device_tasks, RMAX):
    """The port's link_engine against vg_tpu's on the same padded arrays
    (the slow links of the 24 reads, one size bucket each)."""
    haps = long_setup[0]
    arrs = device_tasks[2][RMAX][:5]
    tp = cuda_align.pack_text(haps.text)
    want = jax_engine(arrs, RMAX, tp, len(haps.text))
    got = torch_engine(arrs, RMAX, tp, len(haps.text))
    assert_engine_equal(got, want)
    assert want[3][: int((arrs[1] > 0).sum())].any()


def test_link_engine_equals_jax_on_synthetic_links():
    text, arrs = synthetic_links(8)
    tp = cuda_align.pack_text(text)
    want = jax_engine(arrs, 256, tp, len(text))
    got = torch_engine(arrs, 256, tp, len(text))
    assert_engine_equal(got, want)
    # the set holds tasks that certify and tasks that do not
    a4, la, ta, ba, lb = arrs
    d = np.abs(lb.astype(np.int64) - la)
    ub = np.minimum(la, lb) - 2 * 6 - (d + 32)
    cert = (want[3] & (want[0] >= ub))[: len(la) - 64]
    assert cert.any() and not cert.all()


@pytest.mark.parametrize("RMAX", [256, 768])
def test_plain_fill_and_walk_equal_jax(long_setup, device_tasks, RMAX):
    """cuda_links.link_fill_ref and link_walk_ref, separately and composed,
    against vg_tpu's link_engine on the 24 reads' bucket."""
    haps = long_setup[0]
    tp = cuda_align.pack_text(haps.text)
    want = assert_plain_equal_jax(device_tasks[2][RMAX][:5], RMAX, tp,
                                  len(haps.text))
    assert want[3].any()


@pytest.mark.parametrize("RMAX", [256, 768])
@pytest.mark.parametrize("name", link_cases.CASES)
def test_plain_fill_and_walk_equal_jax_on_cases(name, RMAX):
    """The same on every ops/link_cases.py case (the kernels' traps)."""
    c = link_cases.link_case(name, RMAX=RMAX)
    text = c["text"]
    assert_plain_equal_jax(c["arrays"], RMAX, cuda_align.pack_text(text),
                           len(text), B=c["B"], scoring=c["scoring"])


def test_align_runs_arrays_equal(long_setup, device_tasks):
    """DeviceLinkAligner.align_runs_arrays on the 24 reads' tasks: the
    resolved mask, scores, runs and counts equal vg_tpu's."""
    haps = long_setup[0]
    a_rows, la, ta, lb = device_tasks[1]
    jd = j_links.DeviceLinkAligner(
        jnp.asarray(jax_pack_text(haps.text)), len(haps.text),
        DEFAULT_SCORING)
    td = t_links.DeviceLinkAligner(
        torch.from_numpy(cuda_align.pack_text(haps.text)), len(haps.text),
        DEFAULT_SCORING)
    want = jd.align_runs_arrays(a_rows, la, ta, lb)
    td.stats = {}
    got = td.align_runs_arrays(a_rows, la, ta, lb)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert td.stats["tasks"] == len(la)
    b = td.stats["buckets"]
    assert sum(v["tasks"] for v in b.values()) == int(
        ((la > 0) & (lb > 0) & (np.abs(lb - la) <= 32)).sum())
    assert sum(v["certified"] for v in b.values()) == int(want[0].sum())
    assert {"fill", "walk", "fetch"} <= set(td.stats)


def test_align_problems_equal(long_setup, device_tasks):
    """DeviceLinkAligner.align (the per-problem form) equals vg_tpu's."""
    haps = long_setup[0]
    a_rows, la, ta, lb = device_tasks[1]
    problems = [(a_rows[k, : int(la[k])].copy(), int(ta[k]), int(lb[k]))
                for k in range(0, len(la), 7)][:64]
    jd = j_links.DeviceLinkAligner(
        jnp.asarray(jax_pack_text(haps.text)), len(haps.text),
        DEFAULT_SCORING)
    td = t_links.DeviceLinkAligner(
        torch.from_numpy(cuda_align.pack_text(haps.text)), len(haps.text),
        DEFAULT_SCORING)
    want = jd.align(problems)
    got = td.align(problems)
    assert got == want
    assert any(w is not None for w in want)


def test_device_engine_records_equal_jax(long_setup, device_tasks):
    """LongReadMapper.map_batch_encoded, engine="device", port on the CPU:
    records byte-identical to vg_tpu's (and to the native engine's)."""
    haps, idx = long_setup[:2]
    want = JaxLongRead(haps, idx, JaxParams(engine="device")
                       ).map_batch_encoded(as_reads(link_reads(haps), Read))
    got = device_tasks[0]
    assert want is not None and got is not None
    assert [bytes(r) for r in got] == [bytes(r) for r in want]


def test_native_engine_records_equal_jax(long_setup, device_tasks):
    haps, idx, t_haps, t_idx = long_setup
    seqs = link_reads(haps)
    want = JaxLongRead(haps, idx, JaxParams(engine="native")
                       ).map_batch_encoded(as_reads(seqs, Read))
    got = TorchLongRead(t_haps, t_idx, TorchParams(engine="native"),
                        device="cpu").map_batch_encoded(
        as_reads(seqs, TorchRead))
    assert [bytes(r) for r in got] == [bytes(r) for r in want]
    assert [bytes(r) for r in got] == [bytes(r) for r in device_tasks[0]]


def test_python_stitcher_equals_jax(long_setup):
    """map_read (the Python stitcher) and map_batch (native stitch, Python
    objects) give the same alignments as vg_tpu's."""
    haps, idx, t_haps, t_idx = long_setup
    seqs = link_reads(haps)[:4]
    jm = JaxLongRead(haps, idx)
    tm = TorchLongRead(t_haps, t_idx, device="cpu")
    for s in seqs[:2]:
        want = jm.map_read(Read("r", s, ""))
        got = tm.map_read(TorchRead("r", s, ""))
        assert got.encode() == want.encode()
    want = jm.map_batch(as_reads(seqs, Read))
    got = tm.map_batch(as_reads(seqs, TorchRead))
    assert [a.encode() for a in got] == [a.encode() for a in want]


def test_mapper_keeps_its_packed_text(long_setup):
    """The device aligner's packed text lives on the mapper, on its
    device, and is not left on the shared HaplotypeSet."""
    _, _, t_haps, t_idx = long_setup
    m = TorchLongRead(t_haps, t_idx, TorchParams(engine="device"),
                      device="cpu")
    tp = m._device_aligner().text_packed
    assert tp.device.type == "cpu"
    np.testing.assert_array_equal(tp.numpy(),
                                  cuda_align.pack_text(t_haps.text))
    assert not hasattr(t_haps, "_text_packed_dev")


@pytest.mark.parametrize("engine", ["device", "native"])
def test_reverse_complements_only_where_read(long_setup, monkeypatch,
                                             engine):
    """map_batch_encoded makes a read's reverse complement only for a
    reverse link task that falls back to the host DP (none on the native
    engine), of that task's read."""
    _, _, t_haps, t_idx = long_setup
    m = TorchLongRead(t_haps, t_idx, TorchParams(engine=engine),
                      device="cpu")
    made = []
    revcomp = t_longread.dna.revcomp_codes

    def counted(c):
        made.append(c)
        return revcomp(c)

    monkeypatch.setattr(t_longread.dna, "revcomp_codes", counted)
    fallback = []
    if engine == "device":
        dla = m._device_aligner()
        runs_fn = dla.align_runs_blob

        def runs(*a):
            out = runs_fn(*a)
            fallback.append(int((a[3] & ~out[0]).sum()))
            return out

        dla.align_runs_blob = runs
    reads = as_reads(link_reads(t_haps), TorchRead)
    assert m.map_batch_encoded(reads) is not None
    assert len(made) == sum(fallback)
    codes = [dna.encode(r.sequence) for r in reads]
    for c in made:
        assert any(np.array_equal(c, f) for f in codes)


def test_device_chain_equals_jax():
    """ops/device_chain against vg_tpu's twin and the host DP, as
    test_longread.py::test_device_chain_dp_parity holds vg_tpu's: exact at
    exactly representable parameters (gap costs in powers of two), f
    within rtol 1e-5 / atol 1e-3 of vg_tpu's otherwise, where XLA may
    contract the float32 cost into a fused multiply-add."""
    rng = np.random.default_rng(9)
    p_exact = t_chain.ChainParams(gap_scale=0.125, gap_open=1.0,
                                  lookback_cands=16, min_chain_score=10.0)
    jp_exact = j_chain.ChainParams(gap_scale=0.125, gap_open=1.0,
                                   lookback_cands=16, min_chain_score=10.0)
    for n in (2, 31, 180):
        roff, tpos, score = random_anchors(rng, n, 30000, 9500)
        f_j, par_j = j_dchain.chain_anchors_device(roff, tpos, score,
                                                   jp_exact)
        f_t, par_t = t_dchain.chain_anchors_device(roff, tpos, score,
                                                   p_exact, device="cpu")
        f_h, par_h = t_chain.chain_anchors(roff, tpos, score, p_exact)
        np.testing.assert_array_equal(f_t, f_j)
        np.testing.assert_array_equal(par_t, par_j)
        np.testing.assert_array_equal(f_t, f_h)
        np.testing.assert_array_equal(par_t, par_h)
    p = t_chain.ChainParams(gap_scale=0.105, gap_open=1.0, lookback_cands=64)
    jp = j_chain.ChainParams(gap_scale=0.105, gap_open=1.0,
                             lookback_cands=64)
    roff, tpos, score = random_anchors(rng, 300, 100000, 9500)
    f_j, par_j = j_dchain.chain_anchors_device(roff, tpos, score, jp)
    f_t, par_t = t_dchain.chain_anchors_device(roff, tpos, score, p,
                                               device="cpu")
    np.testing.assert_allclose(f_t, f_j, rtol=1e-5, atol=1e-3)
    assert (par_t == par_j).mean() > 0.99
    # the batched form: two rows of different anchor counts, padded
    rows = [random_anchors(rng, nn, 5000, 900) for nn in (40, 23)]
    N = 40
    arr = [np.zeros((2, N), np.int64), np.zeros((2, N), np.int64),
           np.zeros((2, N), np.float64), np.zeros((2, N), bool)]
    for r, (ro, tp, sc) in enumerate(rows):
        arr[0][r, : len(ro)], arr[1][r, : len(ro)] = ro, tp
        arr[2][r, : len(ro)], arr[3][r, : len(ro)] = sc, True
    f_j, par_j = j_dchain.chain_anchors_device_batch(*arr, jp_exact)
    f_t, par_t = t_dchain.chain_anchors_device_batch(*arr, p_exact,
                                                     device="cpu")
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(par_t, par_j)
