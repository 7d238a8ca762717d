"""The port's quality-adjusted DP and `vg map` (MEMMapper) against the JAX
package's, on the CPU. The DP: vg_tpu_torch.ops.align.banded_scores_qual
(byte text) and ops.cuda_align.banded_scores_qual_packed (the plain
version the wrapper runs for CPU tensors) against the XLA scan
vg_tpu.ops.align.banded_scores_qual on ops/dp_cases.qual_case (both
strands, rlen 0 on valid slots, N bases, phred 0-2 and 61-93, quality
strings shorter than the read, windows cut by lo / hi, invalid slots),
with qualadj's tables and with tables of either sign. The mappers:
GiraffeMapper and MEMMapper with qual_adjusted=True on bench.make_pangenome
(60 kbp), records byte-identical to vg_tpu's, low-quality reads among
them. All exact. The CUDA entry is held against its plain version in
tests/test_torch_qual_kernel.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from vg_tpu.index.haplotypes import thread_haplotypes
from vg_tpu.index.minimizer import MinimizerIndex
from vg_tpu.io import native as jax_native
from vg_tpu.io.fastq import Read as JaxRead
from vg_tpu.map.giraffe import GiraffeMapper as JaxMapper
from vg_tpu.map.giraffe import GiraffeParams as JaxParams
from vg_tpu.map.memmapper import MEMIndex as JaxMEMIndex
from vg_tpu.map.memmapper import MEMMapper as JaxMEMMapper
from vg_tpu.ops import align as jax_align
from vg_tpu.sim.simulator import ReadSimulator as JaxSimulator
from vg_tpu_torch.convert import state_from_arrays
from vg_tpu_torch.io.fastq import Read
from vg_tpu_torch.map import giraffe as tg
from vg_tpu_torch.map.memmapper import MEMIndex, MEMMapper
from vg_tpu_torch.ops import align as t_align
from vg_tpu_torch.ops import cuda_align, dp_cases, qualadj

# The suite runs in several worker processes at once: torch's intra-op
# threads (spinning OpenMP) would oversubscribe the cores many times over.
torch.set_num_threads(1)

BS = 64


def tables(kind):
    if kind == "qualadj":
        return qualadj.qual_tables(1, 4, 5)
    return dp_cases.signed_tables(np.random.default_rng(8))


def jax_qual(args, tabs, B):
    text, reads, reads_rc, quals, rlen, start, lo, hi, rev, valid = args
    return np.asarray(jax_align.banded_scores_qual(
        jnp.asarray(text), reads, reads_rc, quals, rlen, start, lo, hi, rev,
        valid, *(jnp.asarray(t) for t in tabs), band_radius=B))


def port_qual(args, tabs, B):
    """(byte-text plain DP, packed wrapper on CPU tensors) scores."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    tt = [torch.from_numpy(np.asarray(x, np.int32)) for x in tabs]
    text = args[0]
    got = t_align.banded_scores_qual(*t, *tt, band_radius=B).numpy()
    packed = torch.from_numpy(cuda_align.pack_text(text))
    before = cuda_align.banded_scores_qual_packed.launches
    got_p = cuda_align.banded_scores_qual_packed(
        packed, len(text), *t[1:], *tt, band_radius=B).numpy()
    assert cuda_align.banded_scores_qual_packed.launches == before
    return got, got_p


@pytest.mark.parametrize("kind", ["qualadj", "signed"])
@pytest.mark.parametrize("B", [8, 12, 16])
def test_qual_dp_equals_jax(B, kind):
    """Every listed case at each band radius, exact; both port versions."""
    rng = np.random.default_rng(30 + B)
    args = dp_cases.qual_case(rng, R=96, C=8, RL=160, B=B, T=30_000)
    tabs = tables(kind)
    want = jax_qual(args, tabs, B)
    got, got_p = port_qual(args, tabs, B)
    assert got.dtype == got_p.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_p, want)
    quals, rlen, valid = args[3], args[4], args[-1]
    assert (want[~valid] == -1).all()
    # the case holds what it promises
    assert (quals <= 2).any() and (quals > 60).any()
    assert (valid & (rlen[:, None] == 0)).any() and (args[1] == 4).any()
    assert (valid & args[-2]).any() and (valid & ~args[-2]).any()


def test_qual_dp_short_reads_and_haplotype_windows():
    """Reads shorter than RL ending near a haplotype boundary: lo / hi at
    the window's middle on every candidate, and reads of 1-3 bases."""
    rng = np.random.default_rng(41)
    B = 16
    args = list(dp_cases.qual_case(rng, R=64, C=4, RL=64, B=B, T=5_000,
                                   L=60))
    start = args[5]
    args[6] = (start + rng.integers(0, 48, start.shape)).astype(np.int32)
    args[7] = (start + 48 + rng.integers(0, 48, start.shape)).astype(
        np.int32)
    rlen = args[4]
    rlen[:8] = rng.integers(1, 4, 8)
    args[4] = rlen
    tabs = tables("qualadj")
    want = jax_qual(args, tabs, B)
    got, got_p = port_qual(args, tabs, B)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_p, want)


def test_all_q60_equals_unadjusted_dp():
    """At q60 everywhere the tables give 1 / -4 / 5, so the quality DP
    equals the unadjusted one (the shared banded_dp body both ways)."""
    rng = np.random.default_rng(43)
    args = dp_cases.qual_case(rng, R=48, C=8, RL=160, B=12, T=20_000)
    args = list(args)
    args[3] = np.full_like(args[3], 60)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    tt = [torch.from_numpy(x) for x in qualadj.qual_tables(1, 4, 5)]
    q = t_align.banded_scores_qual(*t, *tt, band_radius=12)
    plain = t_align.banded_scores(*(t[:3] + t[4:]), band_radius=12)
    assert torch.equal(q, plain)


@pytest.mark.parametrize("B", [12, 16])
def test_unadjusted_dp_unchanged(B):
    """banded_dp without row scores still equals the XLA scan, through the
    byte-text and packed plain versions."""
    rng = np.random.default_rng(50 + B)
    args = dp_cases.block_case(rng, R=64, C=8, RL=160, B=B, T=20_000)
    want = np.asarray(jax_align.banded_scores(
        *(jnp.asarray(a) for a in args), band_radius=B))
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    np.testing.assert_array_equal(
        t_align.banded_scores(*t, band_radius=B).numpy(), want)
    packed = torch.from_numpy(cuda_align.pack_text(args[0]))
    np.testing.assert_array_equal(cuda_align.banded_scores_packed_ref(
        packed, len(args[0]), *t[1:], band_radius=B).numpy(), want)


def test_dp_work_counts_the_quality_route():
    """The quality entry: 7.5 instructions a cell (int32 route) and 8 a
    valid slot's row; the qualities and the three tables as bytes."""
    reads = torch.zeros((2, 10), dtype=torch.uint8)
    rlen = torch.tensor([10, 4], dtype=torch.int32)
    valid = torch.tensor([[True, False, True], [True, True, False]])
    nbytes, ops = cuda_align.dp_work(reads, rlen, valid, 100, 8,
                                     source="qual", tab_entries=61)
    rows = 10 * 2 + 4 * 2
    assert ops == round(7.5 * 17 * rows + 8 * rows)
    assert nbytes == 400 + 2 * 20 + 8 + 6 * 14 + 6 * 4 + 20 + 12 * 61


# ---------------------------------------------------------------- mappers

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(11)
    g, results, vcf = bench.make_pangenome(rng, ref_len=60_000)
    haps = thread_haplotypes(g, results, vcf)
    idx = MinimizerIndex.build(haps)
    d = tmp_path_factory.mktemp("index")
    jax_native.save_graph(str(d / "g.npz"), g)
    jax_native.save_haplotypes(str(d / "h.npz"), haps)
    jax_native.save_minimizer(str(d / "m.npz"), idx)
    _, t_haps, t_idx = state_from_arrays(
        *(dict(np.load(d / f)) for f in ("g.npz", "h.npz", "m.npz")))
    sim = JaxSimulator(haps, seed=12, read_length=150, with_quality=True)
    quals = [(a.sequence, "".join(chr(33 + b) for b in a.quality))
             for a in sim.simulate(BS - 8, annotate_truth=False)]
    # low-quality reads (the MAPQ cap binds) and phred past the tables'
    # end (the mappers' MAPQ cap, in both packages, needs a quality for
    # every base: the DP cases above hold the shorter strings)
    T = len(haps.text)
    for qc in ["&", "&", "#", "~", "~", "I", "+", "5"]:
        s = int(rng.integers(0, T - 150))
        seq = "".join("ACGT"[c] for c in haps.text[s : s + 150])
        quals.append((seq, qc * 150))
    reads = [(f"q{i}", s, q) for i, (s, q) in enumerate(quals)]
    return dict(haps=haps, idx=idx, t_haps=t_haps, t_idx=t_idx, reads=reads)


def both_records(jm, tm, reads, monkeypatch):
    """GAM bytes of map_batch from each mapper; the port's must have taken
    the quality DP."""
    calls = []
    inner = tg.GiraffeMapper._device_scores_qual

    def spy(self, prep, rs):
        calls.append(len(rs))
        return inner(self, prep, rs)

    monkeypatch.setattr(tg.GiraffeMapper, "_device_scores_qual", spy)
    want = [a.encode() for a in jm.map_batch(
        [JaxRead(n, s, q) for n, s, q in reads])]
    got = [a.encode() for a in tm.map_batch(
        [Read(n, s, q) for n, s, q in reads])]
    assert calls == [len(reads)]
    return want, got


def test_giraffe_qual_records_equal(setup, monkeypatch):
    params = dict(qual_adjusted=True, batch_reads=BS)
    jm = JaxMapper(setup["haps"], setup["idx"], JaxParams(**params))
    tm = tg.GiraffeMapper(setup["t_haps"], setup["t_idx"],
                          tg.GiraffeParams(**params), device="cpu")
    want, got = both_records(jm, tm, setup["reads"], monkeypatch)
    assert len(got) == len(want) == BS
    assert got == want
    from vg_tpu_torch.io.gam import Alignment

    mq = [Alignment.decode(r).mapping_quality for r in got]
    assert min(mq[BS - 8 : BS - 6]) < 30 and max(mq) == 60


def test_mem_mapper_builds_on_cpu(setup):
    """MEMMapper takes the mapper's device (it used to build only on the
    card) and keeps its packed text there."""
    m = MEMMapper(setup["t_haps"], MEMIndex(setup["t_haps"]),
                  tg.GiraffeParams(batch_reads=BS), device="cpu")
    assert m.device == torch.device("cpu")
    assert m.text_packed_dev.device.type == "cpu"


def test_mem_mapper_qual_records_equal(setup, monkeypatch):
    """`vg map` with -A: MEM seeding and the quality DP, byte-identical."""
    params = dict(qual_adjusted=True, batch_reads=BS)
    jm = JaxMEMMapper(setup["haps"], JaxMEMIndex(setup["haps"]),
                      JaxParams(**params))
    tm = MEMMapper(setup["t_haps"], MEMIndex(setup["t_haps"]),
                   tg.GiraffeParams(**params), device="cpu")
    want, got = both_records(jm, tm, setup["reads"][:32], monkeypatch)
    assert len(got) == len(want) == 32
    assert got == want
