"""The banded-DP kernel's quality entry (csrc/banded_dp.cu,
banded_dp_qual_packed, through ops/cuda_align.banded_scores_qual_packed)
against its plain version, and `vg map` (MEMMapper with qual_adjusted) on
the card against its CPU twin. Imports no JAX, so the `gpu` tests also run
on a machine that has only the card's stack:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_qual_kernel.py

Here, without a card, the `gpu` tests skip and the CPU tests run. The DP
is integer arithmetic: every comparison is exact."""
import numpy as np
import pytest
import torch

from vg_tpu_torch.ops import cuda_align, dp_cases, qualadj

# The suite runs in several worker processes at once: torch's intra-op
# threads (spinning OpenMP) would oversubscribe the cores many times over.
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The card, for the `gpu` tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def tables(kind, dev):
    tabs = (qualadj.qual_tables(1, 4, 5) if kind == "qualadj"
            else dp_cases.signed_tables(np.random.default_rng(9)))
    return [torch.as_tensor(np.asarray(t, np.int32), device=dev)
            for t in tabs]


def case_tensors(seed, B, dev, **kw):
    args = dp_cases.qual_case(np.random.default_rng(seed), B=B, **kw)
    text = args[0]
    packed = torch.as_tensor(cuda_align.pack_text(text), device=dev)
    return packed, len(text), [torch.as_tensor(np.ascontiguousarray(a),
                                               device=dev) for a in args[1:]]


def test_qual_case_holds_its_edges():
    """qual_case: phred 0-2 and 61-93, quality strings shorter than their
    reads (zeros past them), rlen 0 on valid slots, both strands, N bases
    and invalid slots."""
    (text, reads, reads_rc, quals, rlen, start, lo, hi, rev,
     valid) = dp_cases.qual_case(np.random.default_rng(1), R=256)
    assert quals.dtype == np.uint8 and quals.shape == reads.shape
    assert (quals <= 2).any() and (quals > 60).any() and quals.max() <= 93
    col = np.arange(reads.shape[1])[None, :]
    inside = col < rlen[:, None]
    assert ((quals == 0) & inside).sum() > (quals[inside] <= 2).sum() * 0.5
    assert (valid & (rlen[:, None] == 0)).any() and (reads == 4).any()
    assert (valid & rev).any() and (valid & ~rev).any() and (~valid).any()
    mt, mm, bt = dp_cases.signed_tables(np.random.default_rng(2))
    assert (mm < 0).any() and (mm > 0).any() and len(mt) == len(bt) == 61


def test_cpu_tensors_run_the_plain_version():
    packed, T, t = case_tensors(3, 12, "cpu", R=32)
    before = cuda_align.banded_scores_qual_packed.launches
    got = cuda_align.banded_scores_qual_packed(
        packed, T, *t, *tables("qualadj", "cpu"), band_radius=12)
    assert cuda_align.banded_scores_qual_packed.launches == before
    want = cuda_align.banded_scores_qual_packed_ref(
        packed, T, *t, *tables("qualadj", "cpu"), band_radius=12)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["qualadj", "signed"])
@pytest.mark.parametrize("B", [8, 12, 16])
def test_qual_entry_equals_plain_version_on_card(cuda_device, B, kind):
    """Every case of dp_cases.qual_case, at each band radius, with
    qualadj's tables and with tables of either sign. The int32 route: the
    library's 16/32 route counters do not move."""
    packed, T, t = case_tensors(70 + B, B, cuda_device, R=1024,
                                T=200_000)
    tabs = tables(kind, cuda_device)
    before = cuda_align.banded_scores_qual_packed.launches
    routes = cuda_align.launches_by_route()
    got = cuda_align.banded_scores_qual_packed(packed, T, *t, *tabs,
                                               band_radius=B)
    torch.cuda.synchronize()
    assert cuda_align.banded_scores_qual_packed.launches == before + 1
    assert cuda_align.launches_by_route() == routes
    want = cuda_align.banded_scores_qual_packed_ref(packed, T, *t, *tabs,
                                                    band_radius=B)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_qual_entry_rejects_what_it_does_not_take(cuda_device):
    packed, T, t = case_tensors(4, 16, cuda_device, R=64)
    tabs = tables("qualadj", cuda_device)
    with pytest.raises(ValueError, match="band radii"):
        cuda_align.banded_scores_qual_packed(packed, T, *t, *tabs,
                                             band_radius=10)
    bad = list(t)
    bad[2] = t[2].to(torch.int32)                   # quals
    with pytest.raises(ValueError, match="quals"):
        cuda_align.banded_scores_qual_packed(packed, T, *bad, *tabs,
                                             band_radius=16)
    long = [torch.zeros(200, dtype=torch.int32, device=cuda_device)] * 3
    with pytest.raises(ValueError, match="quality tables"):
        cuda_align.banded_scores_qual_packed(packed, T, *t, *long,
                                             band_radius=16)


@pytest.mark.gpu
def test_mem_mapper_qual_on_card_equals_cpu(cuda_device):
    """`vg map -A`: MEMMapper(qual_adjusted=True) maps one batch of reads
    with qualities on the card (the quality entry launched) with the same
    records as its CPU twin."""
    from vg_tpu_torch.construct.constructor import (Constructor,
                                                    ConstructorParams)
    from vg_tpu_torch.index.haplotypes import thread_haplotypes
    from vg_tpu_torch.io.fastq import Read
    from vg_tpu_torch.io.vcf import VcfFile
    from vg_tpu_torch.map.giraffe import GiraffeParams
    from vg_tpu_torch.map.memmapper import MEMIndex, MEMMapper
    from vg_tpu_torch.utils import dna

    rng = np.random.default_rng(6)
    ref = dna.decode(rng.integers(0, 4, 60_000).astype(np.uint8))
    empty = VcfFile(samples=[], records=[])
    g, results = Constructor(ConstructorParams(max_node_size=32)
                             ).construct_graph({"r": ref}, empty)
    haps = thread_haplotypes(g, results, empty)
    mem = MEMIndex(haps)
    reads = []
    for i in range(128):
        s = int(rng.integers(0, len(ref) - 150))
        c = dna.encode(ref[s : s + 150])
        q = np.clip(rng.normal(34, 6, 150), 2, 41).astype(np.uint8)
        err = rng.random(150) < 10.0 ** (-q / 10.0)
        c[err] = (c[err] + 1) % 4
        if i % 2:
            c, q = dna.revcomp_codes(c), q[::-1]
        reads.append(Read(f"r{i}", dna.decode(c),
                          "".join(chr(33 + int(x)) for x in q)))
    params = GiraffeParams(qual_adjusted=True, batch_reads=128)
    recs = []
    for dev in (cuda_device, "cpu"):
        m = MEMMapper(haps, mem, params, device=dev)
        before = cuda_align.banded_scores_qual_packed.launches
        recs.append([a.encode() for a in m.map_batch(reads)])
        n = cuda_align.banded_scores_qual_packed.launches - before
        assert n == (1 if dev == cuda_device else 0), (dev, n)
    assert len(recs[0]) == 128
    assert recs[0] == recs[1]
