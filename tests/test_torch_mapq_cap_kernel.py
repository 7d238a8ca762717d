"""The explored-minimizer MAPQ cap kernel (vg_tpu_torch/ops/cuda_mapqcap.py
mapq_cap, csrc/mapq_cap.cu) against its plain version, and the cases of
ops/cap_cases.py against what they are built to reach. Imports no JAX, so
the `gpu` tests also run on a machine that has only the card's stack:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mapq_cap_kernel.py

Here, without a card, the `gpu` tests skip and the cases' checks and the
wrapper's CPU path run. pow and log10 are CUDA's on the card and the C
library's (or SLEEF's) on the CPU, so caps are held to 1e-9 phred and the
capped MAPQ exactly, at every MAPQ from 0 to 60. The parity of the plain
version with vg_tpu's explored_cap is in tests/test_torch_mapq_cap.py."""
import numpy as np
import pytest
import torch

from vg_tpu_torch.map.mapqcap import minimizer_agglomerations
from vg_tpu_torch.ops import cap_cases
from vg_tpu_torch.ops import cuda_mapqcap

# The suite runs in several worker processes at once: torch's intra-op
# threads (spinning OpenMP) would oversubscribe the cores many times over.
torch.set_num_threads(1)

TOL = 1e-9
CASES = list(cap_cases.CASES) + ["random"]


@pytest.fixture
def cuda_device():
    """The card, for the `gpu` tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the MAPQ cap kernel")
    return torch.device("cuda")


def get_case(name):
    return (cap_cases.random_case(0, 2000) if name == "random"
            else cap_cases.case(name))


def tensors(c, dev):
    return {x: torch.from_numpy(v).to(dev)
            for x, v in cap_cases.padded(c).items()}


def run(fn, t, c):
    return fn(t["codes2d"], t["rlen"], t["quals2d"], t["qlen"], t["keys"],
              k=c["k"], w=c["w"]).cpu().numpy()


def capped(caps: np.ndarray) -> np.ndarray:
    """(R, 61): the capped MAPQ (half to even, at least 0, below a finite
    cap) at every MAPQ 0..60."""
    m = np.arange(61)[None, :]
    c = caps[:, None]
    low = np.isfinite(c) & (c < m)
    return np.where(low, np.maximum(np.rint(np.where(low, c, 0)), 0), m)


def compare(got, want) -> dict:
    """Differing MAPQs, the largest cap difference, caps not bit-equal."""
    nan = np.isnan(want)
    fin = np.isfinite(want)
    assert (np.isnan(got) == nan).all()
    assert (np.isposinf(got) == np.isposinf(want)).all()
    diff = np.abs(got[fin] - want[fin])
    return dict(mapqs=int((capped(got[~nan]) != capped(want[~nan])).sum()),
                max_diff=float(diff.max(initial=0.0)),
                not_bitwise=int((got[fin] != want[fin]).sum()))


# ------------------------------------------------------------ the cases

def agglomerations(c, i):
    codes, _ = c["reads"][i]
    offs, hashes, a_start, a_len, keys = minimizer_agglomerations(
        codes, c["k"], c["w"])
    keep = cap_cases.count_fn(c["keys"])(keys) > 0 if len(keys) else []
    return offs[keep], a_start[keep], a_len[keep]


def test_index_keys_sorted_unsigned_with_top_bit():
    for name in CASES:
        keys = get_case(name)["keys"]
        assert keys.dtype == np.uint64
        assert (keys[1:] > keys[:-1]).all(), name
        assert (keys >= np.uint64(1 << 63)).sum() >= 200, name
        # the int64 view a signed comparison would sort differently
        signed = keys.view(np.int64)
        assert not (signed[1:] > signed[:-1]).all()


def test_case_lengths_and_qualities():
    short = cap_cases.case("short_and_n")["reads"]
    assert [len(s) for s, _ in short[:9]] == [0, 1, 28, 29, 30, 38, 39, 40,
                                              150]
    long = cap_cases.case("long")["reads"]
    assert {EDGE, EDGE + 1, 10_000} <= {len(s) for s, _ in long}
    assert sum(q is None for _, q in long) == 1
    assert (short[-1][0] == 4).all()
    assert sum(int((s == 4).any()) for s, _ in short) >= 5
    lengths = cap_cases.case("lengths")["reads"]
    assert {len(s) for s, _ in lengths} == {100, 150, 151, 250}
    assert all(len(q) == len(s) for s, q in lengths)
    mixed = cap_cases.case("mixed_quality")["reads"]
    qlens = [None if q is None else len(q) - len(s) for s, q in mixed]
    assert None in qlens and -150 in qlens      # no quality, empty
    assert 20 in qlens and -149 in qlens        # longer, one base
    for name in ("phred60", "phred93"):
        q = np.concatenate([q for _, q in cap_cases.case(name)["reads"]])
        hi = 60 if name == "phred60" else 93
        assert q.min() == 0 and q.max() == hi, name
    rnd = cap_cases.random_case(0, 2000)["reads"]
    assert len(rnd) == 2000
    assert {100, 150, 151, 250} <= {len(s) for s, _ in rnd}


def test_absent_case_has_all_and_some_minimizers_absent():
    c = cap_cases.case("absent")
    count = cap_cases.count_fn(c["keys"])
    kinds = set()
    for codes, _ in c["reads"]:
        keys = minimizer_agglomerations(codes, c["k"], c["w"])[4]
        hit = count(keys) > 0
        kinds.add("none" if not hit.any() else "all" if hit.all()
                  else "some")
    assert {"none", "some"} <= kinds


def test_ties_case_ties_in_agglomeration_end():
    """Kept minimizers that tie in (agg_end, agg_start), and others that
    tie in agg_end alone: the sort's stable order decides."""
    c = cap_cases.case("ties")
    both = end_only = 0
    for i in range(len(c["reads"])):
        offs, a_start, a_len = agglomerations(c, i)
        end = a_start + a_len
        pairs = list(zip(end.tolist(), a_start.tolist()))
        both += len(pairs) - len(set(pairs))
        end_only += len(end) - len(set(end.tolist()))
    assert both > 0 and end_only > both


def test_padded_layout():
    c = cap_cases.case("mixed_quality")
    p = cap_cases.padded(c)
    for i, (s, q) in enumerate(c["reads"]):
        assert p["rlen"][i] == len(s)
        np.testing.assert_array_equal(p["codes2d"][i, : len(s)], s)
        assert (p["codes2d"][i, len(s):] == 5).all()
        assert p["qlen"][i] == (0 if q is None else len(q))
        if q is not None:
            np.testing.assert_array_equal(p["quals2d"][i, : len(q)], q)
    np.testing.assert_array_equal(p["keys"].view(np.uint64), c["keys"])


# ------------------------------------------------ the wrapper on the CPU

def test_wrapper_runs_the_plain_version_on_the_cpu():
    c = cap_cases.case("phred60")
    t = tensors(c, "cpu")
    n0 = cuda_mapqcap.mapq_cap.launches
    got = run(cuda_mapqcap.mapq_cap, t, c)
    want = run(cuda_mapqcap.mapq_cap_ref, t, c)
    np.testing.assert_array_equal(got, want)
    assert cuda_mapqcap.mapq_cap.launches == n0


def test_plain_version_rejects_bad_inputs():
    c = cap_cases.case("phred60")
    t = tensors(c, "cpu")
    bad = dict(t, rlen=t["rlen"].long())
    with pytest.raises(ValueError, match="rlen"):
        run(cuda_mapqcap.mapq_cap, bad, c)
    with pytest.raises(ValueError, match="k must"):
        cuda_mapqcap.mapq_cap_ref(t["codes2d"], t["rlen"], t["quals2d"],
                                  t["qlen"], t["keys"], k=32, w=11)


def test_cap_work_counts_the_sweep():
    """cap_work counts the bytes once and the operations of the sweep the
    inputs take: more reads, more work; no quality, no float64 work."""
    c = cap_cases.case("phred60")
    t = tensors(c, "cpu")
    kw = dict(k=c["k"], w=c["w"])
    nbytes, int_ops, f64 = cuda_mapqcap.cap_work(
        t["codes2d"], t["rlen"], t["quals2d"], t["qlen"], t["keys"], **kw)
    R = len(c["reads"])
    assert nbytes == 2 * 150 * R + 16 * R + 8 * len(c["keys"])
    assert int_ops > 0 and f64 > 0
    noq = torch.zeros_like(t["qlen"])
    nb0, _, f0 = cuda_mapqcap.cap_work(t["codes2d"], t["rlen"],
                                       t["quals2d"], noq, t["keys"], **kw)
    assert f0 == 0 and nb0 == 16 * R + 8 * len(c["keys"])


def test_scratch_plan():
    """Rows that all fit shared memory need no buffer; otherwise each read
    past SMEM_POSITIONS kmer positions with a quality gets its own
    8-aligned bytes, and the shared rows are sized by the widest that
    fits, within the 48 KiB a block has without opting in."""
    S, k = cuda_mapqcap.SMEM_POSITIONS, cap_cases.K
    B = cuda_mapqcap.SCRATCH_BYTES
    assert B * S + 8 <= 48 * 1024
    rlen = torch.tensor([150, EDGE], dtype=torch.int32)
    qlen = torch.tensor([150, EDGE], dtype=torch.int32)
    assert cuda_mapqcap.scratch_plan(rlen, qlen, EDGE, k) == (S, None, 0)
    rlen = torch.tensor([150, EDGE + 1, 10_000, 20_000, 300, 5],
                        dtype=torch.int32)
    qlen = torch.tensor([150, EDGE + 1, 10_000, 0, 300, 5],
                        dtype=torch.int32)
    pos, off, total = cuda_mapqcap.scratch_plan(rlen, qlen, 20_000, k)
    assert pos == 300 - k + 1
    m = [S + 1, 10_000 - k + 1]
    assert off[1:3].tolist() == [0, B * m[0] + 8]
    assert total == B * sum(m) + 16 and total % 8 == 0
    assert (off % 8 == 0).all()


# ------------------------------------------------------------- the card

@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_kernel_equals_plain_version(cuda_device, name):
    c = get_case(name)
    n0 = cuda_mapqcap.mapq_cap.launches
    got = run(cuda_mapqcap.mapq_cap, tensors(c, cuda_device), c)
    assert cuda_mapqcap.mapq_cap.launches == n0 + 1
    want = run(cuda_mapqcap.mapq_cap_ref, tensors(c, "cpu"), c)
    d = compare(got, want)
    print(f"{name}: {d}")
    assert d["mapqs"] == 0 and d["max_diff"] <= TOL, d


# kmer positions of the widest read in shared memory, in bases at k = 29
EDGE = cuda_mapqcap.SMEM_POSITIONS + cap_cases.K - 1


@pytest.mark.gpu
@pytest.mark.parametrize("lengths", [(EDGE, 150), (EDGE + 1, 150),
                                     (150, EDGE + 1, 4097, EDGE),
                                     (10_000, 6000)],
                         ids=["edge", "past_edge", "mixed", "all_wide"])
def test_kernel_takes_reads_of_any_length(cuda_device, lengths):
    """Reads whose scratch fits shared memory and reads past it (global
    scratch), alone and in one batch, equal the plain version."""
    c = cap_cases.of_lengths(lengths)
    n0 = cuda_mapqcap.mapq_cap.launches
    got = run(cuda_mapqcap.mapq_cap, tensors(c, cuda_device), c)
    assert cuda_mapqcap.mapq_cap.launches == n0 + 1
    want = run(cuda_mapqcap.mapq_cap_ref, tensors(c, "cpu"), c)
    d = compare(got, want)
    assert np.isfinite(want).sum() >= len(lengths) - 1
    assert d["mapqs"] == 0 and d["max_diff"] <= TOL, d


@pytest.mark.gpu
def test_kernel_on_a_batch_without_index_keys(cuda_device):
    """An empty key set keeps no minimizer: every cap is +inf."""
    c = dict(cap_cases.case("phred60"), keys=np.zeros(0, np.uint64))
    got = run(cuda_mapqcap.mapq_cap, tensors(c, cuda_device), c)
    assert np.isposinf(got).all()


@pytest.mark.gpu
def test_launch_count_exact_under_threads(cuda_device):
    """The two emitter threads launch at once: 8 threads x 20 calls
    (a short switch interval) add exactly 160 launches."""
    import sys
    import threading

    c = cap_cases.case("phred60")
    t = tensors(c, cuda_device)
    n0 = cuda_mapqcap.mapq_cap.launches
    errors = []

    def calls():
        try:
            for _ in range(20):
                run(cuda_mapqcap.mapq_cap, t, c)
        except Exception as e:             # reported by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=calls) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    assert cuda_mapqcap.mapq_cap.launches == n0 + 160


@pytest.mark.gpu
def test_kernel_rejects_bad_inputs(cuda_device):
    c = cap_cases.case("phred60")
    t = tensors(c, cuda_device)
    with pytest.raises(ValueError, match="quals2d"):
        run(cuda_mapqcap.mapq_cap, dict(t, quals2d=t["quals2d"].int()), c)
    with pytest.raises(ValueError, match="keys"):
        run(cuda_mapqcap.mapq_cap, dict(t, keys=t["keys"].cpu()), c)
