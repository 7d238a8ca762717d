"""The link engine's two device passes (vg_tpu_torch/ops/cuda_links.py
link_pack and link_runs, csrc/link_engine.cu) against the numpy host
passes of the JAX package that they replace, on the CPU: link_pack_ref
against the a4 words vg_tpu's DeviceLinkAligner.align_runs_arrays packs
from the oriented slices that vg_tpu's LongReadMapper._device_batch
gathers; link_runs_ref against align_runs_arrays' run decoding (its
link_engine replaced by one that returns the cases' step codes); and the
port's align_runs_blob (pack, the plain fill and walk, runs, splice)
against vg_tpu's align_runs_arrays with its XLA engine, on
ops/pass_cases.py's batches. Every comparison is exact.

The kernels against these plain versions, on the card, are in the
JAX-free tests/test_torch_device_links.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vg_tpu.ops import device_links as j_links
from vg_tpu.ops.pallas_align import pack_text as jax_pack_text
from vg_tpu_torch.ops import cuda_align
from vg_tpu_torch.ops import cuda_links
from vg_tpu_torch.ops import device_links as t_links
from vg_tpu_torch.ops import pass_cases
from vg_tpu_torch.ops.align import DEFAULT_SCORING

# The suite runs in several worker processes at once: torch's intra-op
# threads (spinning OpenMP) would oversubscribe the cores many times over.
torch.set_num_threads(1)

NEG = -(1 << 28)


def aligners(text):
    """vg_tpu's DeviceLinkAligner and the port's (on the CPU) on text."""
    jd = j_links.DeviceLinkAligner(jnp.asarray(jax_pack_text(text)),
                                   len(text), DEFAULT_SCORING)
    td = t_links.DeviceLinkAligner(
        torch.from_numpy(cuda_align.pack_text(text)), len(text),
        DEFAULT_SCORING)
    return jd, td


def a_rows_of(b):
    return pass_cases.oriented_rows(b["blob"], b["read_off"],
                                    b["task_read"], b["task_rev"], b["ra"],
                                    b["la"])


def blob_args(b):
    """align_runs_blob's arguments for a pass_cases batch (CPU)."""
    return (torch.from_numpy(b["blob"]), b["read_off"], b["task_read"],
            b["task_rev"], b["ra"], b["la"], b["ta"], b["lb"])


def bucket_sel(la, lb, B=16, buckets=(256, 768)):
    """Each bucket's task ids, as both aligners route them."""
    ok = (la > 0) & (lb > 0) & (np.abs(lb - la) <= 2 * B)
    out, lo = {}, 0
    for RMAX in buckets:
        out[RMAX] = np.nonzero(ok & (la > lo) & (la <= RMAX))[0]
        lo = RMAX
    return out


@pytest.fixture
def jax_engine(monkeypatch):
    """vg_tpu's link_engine replaced by `engine["fn"]` (by default one
    that certifies nothing); each bucket's padded inputs in
    engine["seen"]."""
    engine = {"seen": {}}

    def none_certified(a4, la, ta, ba, lb, text_packed, *, RMAX, **kw):
        N = a4.shape[0]
        return (np.full(N, NEG, np.int32), np.zeros((N, 8), np.int32),
                np.zeros(N, np.int32), np.zeros(N, bool))

    engine["fn"] = none_certified

    def call(*a, RMAX, **kw):
        engine["seen"][RMAX] = [np.asarray(x) for x in a[:5]]
        return engine["fn"](*a, RMAX=RMAX, **kw)

    monkeypatch.setattr(j_links, "link_engine", lambda: call)
    return engine


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", ["mixed", "no_certified_bucket"])
def test_pack_ref_equals_vg_tpu_a4(jax_engine, name, seed):
    """link_pack_ref on the forward blob and the task table gives each
    bucket's a4 words exactly as vg_tpu packs them from the oriented
    slices: la at 1, 7, 8, 16, 255-257 and 768, reverse and forward tasks
    at a read's first and last base, N bases."""
    b = pass_cases.read_batch(name, seed)
    la, lb = b["la"], b["lb"]
    jd, _ = aligners(b["text"])
    jd.align_runs_arrays(a_rows_of(b), la, b["ta"], lb)
    seen = jax_engine["seen"]
    assert set(seen) == {256, 768}
    tab = np.stack([b["task_read"], b["task_rev"], b["ra"], la],
                   axis=1).astype(np.int32)
    blob = torch.from_numpy(b["blob"])
    offs = torch.from_numpy(b["read_off"])
    L = np.diff(b["read_off"])[b["task_read"]]
    for RMAX, sel in bucket_sel(la, lb).items():
        want = seen[RMAX][0].view(np.uint32)
        got = cuda_links.link_pack_ref(blob, offs, torch.from_numpy(tab[sel]),
                                       N=len(want), RMAX=RMAX)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        # the traps are in the bucket
        s_la, s_ra, s_rev = la[sel], b["ra"][sel], b["task_rev"][sel]
        for edge in pass_cases.EDGE_LA:
            if edge <= RMAX and edge > RMAX // 3:
                assert (s_la == edge).any(), (RMAX, edge)
        for rev in (False, True):
            assert ((s_ra == 0) & (s_rev == rev)).any()
            assert ((s_ra + s_la == L[sel]) & (s_rev == rev)).any()
    assert {1, 7, 8, 256, 768} <= set(la[bucket_sel(la, lb)[256]].tolist()
                                      + la[bucket_sel(la, lb)[768]].tolist())
    assert (b["blob"] == 4).any()


def step_engine(packed, n_steps, cert, N_pad):
    """An engine's four outputs padded to N_pad tasks: the case's step
    codes, complete where certified, and a score that clears the escape
    bound exactly there."""
    n, SW = packed.shape
    score = np.full(N_pad, NEG, np.int32)
    score[:n] = np.where(cert, 1 << 20, NEG)
    pk = np.zeros((N_pad, SW), np.int32)
    pk[:n] = packed
    ns = np.ones(N_pad, np.int32)
    ns[:n] = n_steps
    comp = np.zeros(N_pad, bool)
    comp[:n] = cert
    return score, pk, ns, comp


@pytest.mark.parametrize("name", [c for c in pass_cases.STEP_CASES
                                  if c != "big"])
def test_runs_ref_equals_vg_tpu_decoding(jax_engine, name):
    """link_runs_ref, alone and inside the port's align_runs_arrays, gives
    vg_tpu's runs and counts on the same step codes: runs never merge
    across tasks, uncertified and empty walks give none, a case with no
    certified task gives none."""
    packed, n_steps, cert = pass_cases.step_case(name)
    n = len(n_steps)
    la = lb = np.full(n, 100, np.int64)         # bucket 256, in the band
    ta = np.zeros(n, np.int64)
    a_rows = np.zeros((n, 100), np.uint8)
    jax_engine["fn"] = lambda a4, *a, **kw: step_engine(
        packed, n_steps, cert, a4.shape[0])
    jd, td = aligners(np.zeros(1000, np.uint8))
    want = jd.align_runs_arrays(a_rows, la, ta, lb)

    runs, counts = cuda_links.link_runs_ref(
        torch.from_numpy(packed), torch.from_numpy(n_steps),
        torch.from_numpy(cert))
    assert runs.dtype == torch.int32 and counts.dtype == torch.int64
    np.testing.assert_array_equal(runs.numpy(), want[2])
    np.testing.assert_array_equal(counts.numpy(), want[3])

    def engine(a4, *a, **kw):
        out = step_engine(packed, n_steps, cert, a4.shape[0])
        return tuple(torch.from_numpy(x) for x in out)

    td._engine = engine
    got = td.align_runs_arrays(a_rows, la, ta, lb)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    c = counts.numpy()
    assert ((c > 0) == (cert & (n_steps > 0))).all()
    if name == "equal_ops_across_tasks":
        # the same op on both sides of the task boundaries, still split
        end = np.cumsum(c)
        both = np.nonzero((c[1:] > 0) & (c[:-1] > 0))[0]
        r = runs.numpy()
        assert len(both) > 900
        assert (r[end[both] - 1, 0] == r[end[both], 0]).all()
    if name == "no_certified":
        assert len(runs) == 0 and not got[0].any()


@pytest.mark.parametrize("name", pass_cases.BATCHES)
def test_align_runs_blob_equals_vg_tpu(name):
    """The port's align_runs_blob (link_pack, the plain fill and walk,
    link_runs) with splice_runs, and its align_runs_arrays on vg_tpu's
    oriented slices, equal vg_tpu's align_runs_arrays with its XLA engine:
    resolved mask, scores, runs and counts, in dtype and value; on a
    mixed batch, one with a bucket that certifies nothing, one that all
    falls back, and an empty one."""
    b = pass_cases.read_batch(name)
    jd, td = aligners(b["text"])
    a_rows = a_rows_of(b)
    want = jd.align_runs_arrays(a_rows, b["la"], b["ta"], b["lb"])
    td.stats = {}
    resolved, scores, counts, pieces = td.align_runs_blob(*blob_args(b))
    runs_off, runs = t_links.splice_runs(counts, pieces)
    for g, w in zip((resolved, scores, runs, counts), want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.diff(runs_off), counts)
    for g, w in zip(td.align_runs_arrays(a_rows, b["la"], b["ta"], b["lb"]),
                    want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    n = len(b["la"])
    assert td.stats["tasks"] == 2 * n
    assert {"pack", "fill", "walk", "runs", "fetch"} <= set(td.stats) or \
        not resolved.any()
    certified = {R: v["certified"] for R, v in
                 td.stats.get("buckets", {}).items()}
    if name == "mixed":
        assert 0 < resolved.sum() < n and certified[256] and certified[768]
    elif name == "no_certified_bucket":
        # one piece: bucket 768 certified nothing and made no runs
        assert certified[768] == 0 and certified[256] > 0
        assert len(pieces) == 1 and (b["la"][pieces[0][0]] <= 256).all()
    else:
        assert not resolved.any() and len(runs) == 0 and not pieces
        assert (n == 0) == (name == "empty")


def vg_tpu_splice(counts, dev_ids, druns, fb_ids, fruns):
    """vg_tpu's LongReadMapper._device_batch run splice (device runs, then
    the fallback's), copied from vg_tpu/map/longread.py:707-726."""
    runs_off = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=runs_off[1:])
    all_runs = np.zeros((int(runs_off[-1]), 3), np.int32)

    def _scatter(task_ids, src):
        seg = counts[task_ids]
        tot = int(seg.sum())
        if tot == 0:
            return
        within = (np.arange(tot)
                  - np.repeat(np.concatenate([[0], np.cumsum(seg)])[:-1],
                              seg))
        dest = np.repeat(runs_off[task_ids], seg) + within
        all_runs[dest] = src[:tot]

    _scatter(dev_ids, druns)
    _scatter(fb_ids, fruns)
    return runs_off, all_runs


def test_splice_runs_equals_vg_tpu_splice():
    """splice_runs' one scatter of the pieces (two buckets' runs, the
    fallback's) equals vg_tpu's splice of device and fallback runs."""
    rng = np.random.default_rng(5)
    n = 500
    counts = rng.integers(0, 9, n).astype(np.int64)
    where = rng.integers(0, 3, n)           # bucket 256, 768, fallback
    ids = [np.nonzero(where == k)[0] for k in range(3)]
    runs = [rng.integers(0, 100, (int(counts[i].sum()), 3)).astype(np.int32)
            for i in ids]
    got = t_links.splice_runs(counts, list(zip(ids, runs)))
    dev = np.sort(np.concatenate(ids[:2]))
    # vg_tpu's device runs come in task order across buckets
    druns = np.concatenate([runs[int(where[t])][
        int(counts[ids[int(where[t])]][ids[int(where[t])] < t].sum()):][
        : int(counts[t])] for t in dev])
    want = vg_tpu_splice(counts, dev, druns, ids[2], runs[2])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

