"""The explored-minimizer MAPQ cap of the port (vg_tpu_torch/ops/
cuda_mapqcap.py: mapq_cap_ref, the kernel's plain version, and
GiraffeMapper.apply_mapq_caps, which calls mapq_cap once a batch) against
the JAX package's per-read Python cap (vg_tpu/map/mapqcap.explored_cap,
GiraffeMapper.apply_mapq_caps), on the CPU.

The inputs are ops/cap_cases.py's cases and seeded batches of 2,000 reads,
made with numpy and handed to both packages. The port's verbatim copy of
the module (vg_tpu_torch/map/mapqcap.py) judges too. pow and log10 are
the libraries' on both sides, so caps are held to 1e-9 phred and the
capped MAPQ exactly, at every MAPQ from 0 to 60; where explored_cap
raises IndexError (a quality shorter than its read) the cap is NaN.

The kernel against mapq_cap_ref on the card is in the JAX-free
tests/test_torch_mapq_cap_kernel.py."""
import dataclasses

import numpy as np
import pytest
import torch

import bench
from vg_tpu.index.haplotypes import thread_haplotypes
from vg_tpu.index.minimizer import MinimizerIndex
from vg_tpu.io import native as jax_native
from vg_tpu.io.fastq import Read as JaxRead
from vg_tpu.map import mapqcap as j_mapqcap
from vg_tpu.map.giraffe import GiraffeMapper as JaxMapper
from vg_tpu.map.giraffe import GiraffeParams as JaxParams
from vg_tpu_torch.convert import state_from_arrays
from vg_tpu_torch.io.fastq import Read
from vg_tpu_torch.map import giraffe as tg
from vg_tpu_torch.map import mapqcap as t_mapqcap
from vg_tpu_torch.ops import cap_cases
from vg_tpu_torch.ops import cuda_mapqcap

# The suite runs in several worker processes at once: torch's intra-op
# threads (spinning OpenMP) would oversubscribe the cores many times over.
torch.set_num_threads(1)

TOL = 1e-9
MAPQS = np.arange(61)


def judge(module, c) -> np.ndarray:
    """explored_cap of each read of case c (NaN where it raises)."""
    count = cap_cases.count_fn(c["keys"])
    out = []
    for codes, q in c["reads"]:
        quals = np.zeros(0, np.uint8) if q is None else q
        try:
            out.append(module.explored_cap(codes, quals, c["k"], c["w"],
                                           count_fn=count))
        except IndexError:
            out.append(np.nan)
    return np.array(out, np.float64)


def plain(c) -> np.ndarray:
    p = {x: torch.from_numpy(v) for x, v in cap_cases.padded(c).items()}
    return cuda_mapqcap.mapq_cap_ref(
        p["codes2d"], p["rlen"], p["quals2d"], p["qlen"], p["keys"],
        k=c["k"], w=c["w"]).numpy()


def capped(caps: np.ndarray) -> np.ndarray:
    """(R, 61): apply_mapq_caps' rule at every MAPQ 0..60 (vg_tpu's
    `max(int(round(cap)), 0)` below a finite cap)."""
    out = np.empty((len(caps), len(MAPQS)), np.int64)
    for i, cap in enumerate(caps):
        for m in MAPQS:
            out[i, m] = (max(int(round(cap)), 0)
                         if np.isfinite(cap) and cap < m else m)
    return out


def hold(got: np.ndarray, want: np.ndarray) -> int:
    """Caps within TOL (inf and NaN where the judge has them) and the
    capped MAPQs equal; returns how many caps are not bit-identical."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    fin = np.isfinite(want)
    assert np.isfinite(got[fin]).all()
    diff = np.abs(got[fin] - want[fin])
    assert diff.max(initial=0.0) <= TOL, diff.max()
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(capped(got[ok]), capped(want[ok]))
    return int((got[fin] != want[fin]).sum())


CASES = [(name, None) for name in cap_cases.CASES] + [
    ("random", 0), ("random", 1)]


@pytest.mark.parametrize("name,seed", CASES,
                         ids=[n if s is None else f"{n}{s}" for n, s in CASES])
def test_plain_version_equals_explored_cap(name, seed):
    c = (cap_cases.random_case(seed, 2000) if name == "random"
         else cap_cases.case(name))
    want = judge(j_mapqcap, c)
    got = plain(c)
    n_bits = hold(got, want)
    # the port's verbatim copy gives vg_tpu's caps bit for bit
    copy = judge(t_mapqcap, c)
    np.testing.assert_array_equal(copy, want)
    fin = np.isfinite(want)
    print(f"{name}: {len(want)} reads, {int(fin.sum())} finite caps, "
          f"{n_bits} not bit-identical, {int(np.isnan(want).sum())} NaN")
    if name == "random":
        assert len(want) >= 2000 and fin.sum() >= 1000


def test_cases_reach_their_paths():
    """The cases hold finite and infinite caps, a NaN (quality shorter
    than its read) and reads whose minimizers are all absent."""
    caps = {n: judge(j_mapqcap, cap_cases.case(n)) for n in cap_cases.CASES}
    assert np.isnan(caps["mixed_quality"]).sum() == 1
    assert np.isposinf(caps["absent"][:16]).all()
    assert np.isfinite(caps["absent"][16:]).any()
    for n in ("phred60", "phred93", "ties", "lengths"):
        assert np.isfinite(caps[n]).all(), n
    short = caps["short_and_n"]
    assert np.isposinf(short[:3]).all()       # lengths 0, 1 and 28
    assert np.isposinf(short[-1])             # the all-N read


# ------------------------------------------------- the mapper, both packages

@pytest.fixture(scope="module")
def mappers(tmp_path_factory):
    rng = np.random.default_rng(15)
    g, results, vcf = bench.make_pangenome(rng, ref_len=30_000)
    haps = thread_haplotypes(g, results, vcf)
    idx = MinimizerIndex.build(haps)
    d = tmp_path_factory.mktemp("index")
    jax_native.save_graph(str(d / "g.npz"), g)
    jax_native.save_haplotypes(str(d / "h.npz"), haps)
    jax_native.save_minimizer(str(d / "m.npz"), idx)
    _, t_haps, t_idx = state_from_arrays(
        *(dict(np.load(d / f)) for f in ("g.npz", "h.npz", "m.npz")))
    jm = JaxMapper(haps, idx, JaxParams(batch_reads=256))
    tm = tg.GiraffeMapper(t_haps, t_idx, tg.GiraffeParams(batch_reads=256),
                          device="cpu")
    sim = bench.simulate_reads(rng, haps, 240, read_len=150)
    return dict(jm=jm, tm=tm, sim=sim, rng=rng)


def quality(rng, n, kind):
    hi = (41, 60, 93)[kind % 3]
    return (rng.integers(0, hi + 1, n) + 33).astype(np.uint8).tobytes(
        ).decode()


def read_sets(fx):
    """(vg_tpu reads, port reads) with qualities of several profiles, a
    few without one or with an empty one, lengths 150, 100 and 151."""
    rng = np.random.default_rng(3)
    j, t = [], []
    for i, r in enumerate(fx["sim"]):
        seq = r.sequence[:100] if i % 7 == 3 else r.sequence
        if i % 11 == 5:
            seq = seq + "A"
        q = (None if i % 13 == 0 else "" if i % 17 == 1
             else quality(rng, len(seq), i))
        j.append(JaxRead(r.name, seq, q))
        t.append(Read(r.name, seq, q))
    return j, t


@pytest.mark.parametrize("path", ["score_reads", "score_reads_packed",
                                  "without_codes2d"])
def test_apply_mapq_caps_equals_vg_tpu(mappers, path, monkeypatch):
    """Both packages' apply_mapq_caps on the same scored reads; the port's
    from the batch's padded codes or, where a batch has none (the paired
    device step's batches), from its per-read codes."""
    jreads, treads = read_sets(mappers)
    jsb = mappers["jm"].score_reads(jreads)
    if path == "without_codes2d":
        tsb = dataclasses.replace(mappers["tm"].score_reads(treads),
                                  codes2d=None)
    else:
        tsb = getattr(mappers["tm"], path)(treads)
    rng = np.random.default_rng(7)
    calls = []
    orig = cuda_mapqcap.mapq_cap
    monkeypatch.setattr(cuda_mapqcap, "mapq_cap",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    monkeypatch.setattr(t_mapqcap, "explored_cap", None)   # never called
    n = len(jreads)
    lowered = 0
    for mq in (np.full(n, 60), rng.integers(0, 61, n)):
        want = mappers["jm"].apply_mapq_caps(jsb, mq.copy())
        # the packed path pads a short batch with copies of its last read
        pad = np.full(len(tsb.reads) - n, mq[-1])
        got = mappers["tm"].apply_mapq_caps(tsb, np.concatenate([mq, pad]))
        np.testing.assert_array_equal(got[:n], want)
        lowered += int((want < mq).sum())
    assert len(calls) == 2
    assert lowered > 0


def test_batch_without_qualities_launches_nothing(mappers, monkeypatch):
    reads = [Read(r.name, r.sequence, q) for r, q in
             zip(mappers["sim"][:64], [None, ""] * 32)]
    sb = mappers["tm"].score_reads(reads)
    monkeypatch.setattr(cuda_mapqcap, "mapq_cap", None)    # never called
    mq = np.random.default_rng(1).integers(0, 61, len(reads))
    got = mappers["tm"].apply_mapq_caps(sb, mq.copy())
    np.testing.assert_array_equal(got, mq)


def test_short_quality_raises_as_vg_tpu(mappers):
    """A quality shorter than the minimizers it covers: vg_tpu's
    explored_cap raises IndexError, and so does the port's batch."""
    r = mappers["sim"][0]
    q = "I" * 40
    jsb = mappers["jm"].score_reads([JaxRead(r.name, r.sequence, q)])
    tsb = mappers["tm"].score_reads([Read(r.name, r.sequence, q)])
    with pytest.raises(IndexError):
        mappers["jm"].apply_mapq_caps(jsb, np.array([60]))
    with pytest.raises(IndexError):
        mappers["tm"].apply_mapq_caps(tsb, np.array([60]))


def test_cap_keys_built_once_by_concurrent_emitters(mappers):
    """Two emitter threads call apply_mapq_caps at once: the index keys
    are built once and every thread gets the same tensor (16 threads,
    a short switch interval)."""
    import sys
    import threading

    tm = mappers["tm"]
    tm._cap_state = None
    got, errors = [], []

    def call():
        try:
            got.append(tm._cap_keys())
        except Exception as e:             # reported by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=call) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(got) == 16 and all(g is got[0] for g in got)
    want = np.unique(np.asarray(tm.index.keys, np.uint64)[
        np.diff(tm.index.offsets) > 0])
    np.testing.assert_array_equal(got[0][0].numpy().view(np.uint64), want)
    assert got[0][1] is None                   # no stream on the CPU
