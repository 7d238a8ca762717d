"""The port's surject, pack, call, sim and mapeval modules (workloads 3 and
5 and the accuracy tools, copies of vg_tpu's host modules) against the JAX
package's on the CPU. The port maps once (GiraffeMapper, device="cpu", on
bench.make_pangenome at 40 kbp, reads from sample s1's two haplotypes at
10x diploid depth); each package decodes the same GAM bytes with its own
io.gam and runs its own Surjector (SAM lines, BAM bytes), Packer
(coverage arrays) and SnarlCaller (VCF text). ReadSimulator's reads and
run_mapeval's results are compared with each package's own mapper. All
exact."""
import io

import numpy as np
import pytest
import torch

import bench
from vg_tpu.call.caller import SnarlCaller as JaxCaller
from vg_tpu.call.pack import Packer as JaxPacker
from vg_tpu.eval.mapeval import run_mapeval as jax_mapeval
from vg_tpu.index.haplotypes import thread_haplotypes
from vg_tpu.index.minimizer import MinimizerIndex
from vg_tpu.io import bam as jax_bam
from vg_tpu.io import native as jax_native
from vg_tpu.io.gam import Alignment as JaxAlignment
from vg_tpu.map.giraffe import GiraffeMapper as JaxMapper
from vg_tpu.map.giraffe import GiraffeParams as JaxParams
from vg_tpu.sim.simulator import ReadSimulator as JaxSimulator
from vg_tpu.surject.surjector import Surjector as JaxSurjector
from vg_tpu_torch.call.caller import SnarlCaller
from vg_tpu_torch.call.pack import Packer
from vg_tpu_torch.convert import state_from_arrays
from vg_tpu_torch.eval.mapeval import run_mapeval
from vg_tpu_torch.io import bam
from vg_tpu_torch.io.fastq import Read
from vg_tpu_torch.io.gam import Alignment
from vg_tpu_torch.map import giraffe as tg
from vg_tpu_torch.sim.simulator import ReadSimulator
from vg_tpu_torch.surject.surjector import Surjector
from vg_tpu_torch.utils import dna

# The suite runs in several worker processes at once: torch's intra-op
# threads (spinning OpenMP) would oversubscribe the cores many times over.
torch.set_num_threads(1)

REF_LEN, DEPTH, L, BS = 40_000, 10, 150, 512


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(21)
    g, results, vcf = bench.make_pangenome(rng, ref_len=REF_LEN)
    haps = thread_haplotypes(g, results, vcf)
    idx = MinimizerIndex.build(haps)
    d = tmp_path_factory.mktemp("index")
    jax_native.save_graph(str(d / "g.npz"), g)
    jax_native.save_haplotypes(str(d / "h.npz"), haps)
    jax_native.save_minimizer(str(d / "m.npz"), idx)
    t_g, t_haps, t_idx = state_from_arrays(
        *(dict(np.load(d / f)) for f in ("g.npz", "h.npz", "m.npz")))
    ranges = [t_haps.hap_text_range(i) for i, m in enumerate(t_haps.metas)
              if m.sample == "s1"]
    reads = []
    for t0, t1 in ranges:
        for i in range(DEPTH * REF_LEN // L // len(ranges)):
            s = int(rng.integers(t0, t1 - L))
            c = t_haps.text[s : s + L].copy()
            ne = rng.binomial(L, 0.002)
            ps = rng.integers(0, L, ne)
            c[ps] = (c[ps] + 1 + rng.integers(0, 3, ne)) % 4
            if rng.random() < 0.5:
                c = dna.revcomp_codes(c)
            reads.append(Read(f"d{t0}_{i}", dna.decode(c), ""))
    tm = tg.GiraffeMapper(t_haps, t_idx, tg.GiraffeParams(batch_reads=BS),
                          device="cpu")
    recs = [bytes(r) for out in tm.map_stream_encoded(
        iter([reads[i : i + BS] for i in range(0, len(reads), BS)]))
        for r in out]
    assert len(recs) == len(reads)
    return dict(g=g, haps=haps, idx=idx, t_g=t_g, t_haps=t_haps,
                t_idx=t_idx, recs=recs,
                jax_alns=[JaxAlignment.decode(r) for r in recs],
                alns=[Alignment.decode(r) for r in recs])


@pytest.fixture(scope="module")
def surjected(setup):
    out = []
    for S, g, alns in ((JaxSurjector, setup["g"], setup["jax_alns"]),
                       (Surjector, setup["t_g"], setup["alns"])):
        sj = S(g)
        out.append((sj, sj.surject_batch(alns)))
    return out


def test_surject_sam_lines_equal(surjected):
    (jsj, want), (sj, got) = surjected
    assert sj.header() == jsj.header()
    assert [r.line() for r in got] == [r.line() for r in want]
    assert sum(1 for r in got if not r.flag & 0x4) >= 0.9 * len(got)


def test_write_bam_bytes_equal(surjected):
    bufs = []
    for (sj, recs), mod in zip(surjected, (jax_bam, bam)):
        b = io.BytesIO()
        mod.write_bam(b, sj.header(), sj.ref_lengths(), recs)
        bufs.append(b.getvalue())
    assert bufs[1] == bufs[0]
    header, refs, back = bam.read_bam(io.BytesIO(bufs[1]))
    assert [r.line() for r in back] == [r.line() for r in surjected[1][1]]


@pytest.fixture(scope="module")
def packed(setup):
    jp = JaxPacker(setup["g"])
    jp.add_batch(setup["jax_alns"])
    pk = Packer(setup["t_g"])
    pk.add_batch(setup["alns"])
    return jp, pk


def test_pack_coverage_equal(packed):
    jp, pk = packed
    assert pk.n_alignments == jp.n_alignments > 0
    np.testing.assert_array_equal(pk.base_coverage, jp.base_coverage)
    np.testing.assert_array_equal(pk.edge_coverage, jp.edge_coverage)
    assert pk.mean_coverage("ref") == jp.mean_coverage("ref")


def test_call_vcf_text_equal(setup, packed):
    jp, pk = packed
    texts = []
    for C, g, p in ((JaxCaller, setup["g"], jp),
                    (SnarlCaller, setup["t_g"], pk)):
        buf = io.StringIO()
        C(g, p, "ref", sample_name="s1").write_vcf(buf)
        texts.append(buf.getvalue())
    assert texts[1] == texts[0]
    assert sum(1 for ln in texts[1].splitlines()
               if not ln.startswith("#")) >= 10


@pytest.mark.parametrize("paired", [False, True])
def test_simulated_reads_equal(setup, paired):
    kw = dict(seed=5, read_length=L, with_quality=True)
    want = JaxSimulator(setup["haps"], **kw).simulate(40, paired=paired)
    got = ReadSimulator(setup["t_haps"], **kw).simulate(40, paired=paired)
    assert [a.encode() for a in got] == [a.encode() for a in want]
    assert all(a.quality for a in got)


def test_mapeval_results_equal(setup):
    """run_mapeval with quality-carrying reads (the quality DP on both
    sides), each package with its own mapper."""
    params = dict(batch_reads=64, qual_adjusted=True)
    jm = JaxMapper(setup["haps"], setup["idx"], JaxParams(**params))
    tm = tg.GiraffeMapper(setup["t_haps"], setup["t_idx"],
                          tg.GiraffeParams(**params), device="cpu")
    want = jax_mapeval(jm, n_reads=64, with_quality=True, seed=17)
    got = run_mapeval(tm, n_reads=64, with_quality=True, seed=17)
    assert got.to_dict() == want.to_dict()
    assert got.mapq_buckets == want.mapq_buckets
    assert got.total == 64 and got.correct >= 56
