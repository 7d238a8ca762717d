"""The seeding kernels (vg_tpu_torch/csrc/seed_kernels.cu) against their
plain PyTorch versions, and the wrappers' routing, checks and work counts.
Imports no JAX, so the `gpu` tests also run on a machine that has only the
card's stack:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_seed_kernel.py

Here, without a card, the `gpu` tests skip and the CPU tests run. Inputs
come from vg_tpu_torch.ops.seed_cases: every comparison is exact."""
import numpy as np
import pytest
import torch

from vg_tpu_torch.ops import cuda_seed, seed_cases

# The suite runs in several worker processes at once: torch's intra-op
# threads (spinning OpenMP) would oversubscribe the cores many times over.
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The card, for the `gpu` tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def tensors(arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def test_cpu_tensors_launch_nothing():
    rng = np.random.default_rng(0)
    counters = dict(cuda_seed._block_rows)
    before = (cuda_seed.softcap_compact.launches,
              cuda_seed.cluster_topc.launches, cuda_seed.argsort_i32.launches)
    out = cuda_seed.softcap_compact(
        *tensors(seed_cases.softcap_case(rng, 16)), score_fraction=0.9)
    assert [tuple(o.shape) for o in out] == [(16, 256)] * 6
    cd, cr, cv = cuda_seed.cluster_topc(
        *tensors(seed_cases.cluster_case(rng, 8, 256)), band_radius=16,
        max_candidates=8)
    assert cd.dtype == cr.dtype == torch.int32 and cv.dtype == torch.bool
    perm = cuda_seed.argsort_i32(torch.from_numpy(
        seed_cases.argsort_case(rng, 300)))
    assert perm.dtype == torch.int32
    assert (cuda_seed.softcap_compact.launches,
            cuda_seed.cluster_topc.launches,
            cuda_seed.argsort_i32.launches) == before
    assert cuda_seed._block_rows == counters   # no card counter was made


@pytest.mark.parametrize("S", [256, 1024, 4096])
def test_count_case_holds_the_counts_up_to_s(S):
    args = seed_cases.cluster_count_case(np.random.default_rng(S), S,
                                         copies=3)
    want = [k for k in seed_cases.CLUSTER_COUNTS if k <= S]
    np.testing.assert_array_equal((args[0] < 2).sum(1), np.repeat(want, 3))
    assert (args[1][args[0] == 2] == cuda_seed.I32MAX).all()


def test_float_case_crosses_the_warp_limit():
    """Every fourth row of the non-quantized case holds more than T valid
    seeds where S allows, the others fewer; its scores are not multiples
    of 1/256."""
    strandk, _, _, score = seed_cases.cluster_float_case(
        np.random.default_rng(9), 16, 1024)
    n = (strandk < 2).sum(1)
    over = n > cuda_seed.CLUSTER_WARP_T
    np.testing.assert_array_equal(over, np.arange(16) % 4 == 3)
    assert (score * 256 != np.round(score * 256)).any()


def test_plain_softcap_takes_taken_first_in_column_order():
    """The compaction contract: taken columns first, ascending, then the
    untaken ones ascending; the padding columns carry zeros."""
    args = seed_cases.softcap_case(np.random.default_rng(1), 28)
    pos, hs, cnt, cr, ms, take = (o.numpy() for o in cuda_seed.
                                  softcap_compact(*tensors(args),
                                                  score_fraction=0.9))
    m = args[0].shape[1]
    for r in range(28):
        n = int(take[r].sum())
        assert (take[r, :n] == 1).all() and (take[r, n:] == 0).all()
        assert (np.diff(pos[r, :n]) > 0).all()
        assert (np.diff(pos[r, n:]) > 0).all()
        real = pos[r] < m
        np.testing.assert_array_equal(hs[r][real], args[3][r, pos[r][real]])
        assert (hs[r][~real] == 0).all() and (ms[r][~real] == 0).all()
    assert int(take[0::7].sum()) == 0                 # nothing kept


def test_kept_case_holds_the_counts():
    args = seed_cases.softcap_kept_case(np.random.default_rng(4))
    np.testing.assert_array_equal(args[1].sum(1),
                                  np.repeat(seed_cases.SOFTCAP_KEPT, 2))
    assert (args[0][args[1]] >= 1).all() and (args[0][~args[1]] == 0).all()


def test_sign_case_has_signed_zeros_and_negative_scores():
    ms, keep = seed_cases.softcap_sign_case(np.random.default_rng(5), 24)[:2]
    zero = ms == 0
    assert (zero & np.signbit(ms)).any() and (zero & ~np.signbit(ms)).any()
    assert (keep & (ms < 0)).any() and (keep & zero).any()
    assert not (ms[2::3] > 0).any()


def test_budget_case_meets_the_budget_exactly():
    """At score_fraction 0.5 the first X / 4 column's exclusive sum equals
    the budget, so the plain version takes exactly the X columns; a <=
    would take one more in every nonempty row."""
    args = seed_cases.softcap_budget_case(np.random.default_rng(6), 24)
    ms, keep = args[0], args[1]
    out = cuda_seed.softcap_compact(*tensors(args), score_fraction=0.5)
    take = out[5].numpy()
    big = (ms >= 2.25).sum(1)
    assert (big > 0).all()
    np.testing.assert_array_equal(take.sum(1), big)
    half = np.float32(0.5) * ms.sum(1, dtype=np.float32)
    np.testing.assert_array_equal(half, np.where(ms >= 2.25, ms, 0).sum(1))
    assert (keep.sum(1) == 5 * big).all()


def test_cluster_work_counts_valid_seeds():
    strandk = torch.tensor([[0, 2, 1, 2], [2, 2, 2, 2]], dtype=torch.int32)
    nbytes, ops = cuda_seed.cluster_work(strandk, 8)
    assert nbytes == 4 * 8 + 12 * 2 + 2 * 8 * 9
    assert ops == 2 * 2 * 1 + (12 + 8) * 2


SOFTCAP_CASES = {
    "kept": (lambda rng: seed_cases.softcap_kept_case(rng), 0.9),
    "sign": (lambda rng: seed_cases.softcap_sign_case(rng, 96), 0.9),
    "sign m=600": (lambda rng: seed_cases.softcap_sign_case(rng, 40, 600),
                   0.7),
    "budget": (lambda rng: seed_cases.softcap_budget_case(rng, 96), 0.5),
}


def assert_softcap_exact(args, sf):
    before = cuda_seed.softcap_compact.launches
    got = cuda_seed.softcap_compact(*args, score_fraction=sf)
    torch.cuda.synchronize()
    assert cuda_seed.softcap_compact.launches == before + 1
    want = cuda_seed.softcap_compact_ref(*args, score_fraction=sf)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("m", seed_cases.SOFTCAP_WIDTHS)
def test_softcap_kernel_exact_at_each_width(cuda_device, m):
    """Every mpad (128 to 1024: 4 to 32 columns a lane) and both sides of
    each power of two; the entry takes the instantiation of mpad / 32."""
    items = cuda_seed.pow2_ge(max(m, 128)) // 32
    args = tensors(seed_cases.softcap_case(np.random.default_rng(m), 150, m),
                   cuda_device)
    n0 = cuda_seed.softcap_launches_by_items()
    assert_softcap_exact(args, 0.9)
    n1 = cuda_seed.softcap_launches_by_items()
    assert {e: n1[e] - n0[e] for e in n1} == {
        e: int(e == items) for e in n1}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", list(SOFTCAP_CASES))
def test_softcap_kernel_exact_on_edge_rows(cuda_device, kind):
    """Rows of 31-33 and 63-65 kept columns, zeros of either sign,
    negative scores, and the exclusive sum equal to the budget."""
    make, sf = SOFTCAP_CASES[kind]
    assert_softcap_exact(tensors(make(np.random.default_rng(8)),
                                 cuda_device), sf)


@pytest.mark.gpu
def test_softcap_kernel_equals_plain_version_on_card(cuda_device):
    args = tensors(seed_cases.softcap_case(np.random.default_rng(2), 700),
                   cuda_device)
    before = cuda_seed.softcap_compact.launches
    got = cuda_seed.softcap_compact(*args, score_fraction=0.9)
    torch.cuda.synchronize()
    assert cuda_seed.softcap_compact.launches == before + 1
    want = cuda_seed.softcap_compact_ref(*args, score_fraction=0.9)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


CLUSTER_CASES = {
    "adversarial": lambda rng, S: seed_cases.cluster_case(rng, 96, S),
    "seed counts": lambda rng, S: seed_cases.cluster_count_case(rng, S),
    "non-quantized": lambda rng, S: seed_cases.cluster_float_case(rng, 64,
                                                                  S),
}


@pytest.mark.gpu
@pytest.mark.parametrize("S", [256, 1024, 4096])
@pytest.mark.parametrize("kind", list(CLUSTER_CASES))
def test_cluster_kernel_equals_plain_version_on_card(cuda_device, kind, S):
    """Exact on every row, and the block path takes exactly the rows of
    more than T valid seeds."""
    args = tensors(CLUSTER_CASES[kind](np.random.default_rng(S), S),
                   cuda_device)
    before = cuda_seed.cluster_topc.launches
    rows0 = cuda_seed.block_rows_read()
    got = cuda_seed.cluster_topc(*args, band_radius=16, max_candidates=8)
    torch.cuda.synchronize()
    assert cuda_seed.cluster_topc.launches == before + 1
    over = int(((args[0] < 2).sum(1) > cuda_seed.CLUSTER_WARP_T).sum())
    assert cuda_seed.block_rows_read() - rows0 == over
    want = cuda_seed.cluster_topc_ref(*args, band_radius=16,
                                      max_candidates=8)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert bool(want[2].any())


@pytest.mark.gpu
def test_block_rows_counts_only_rows_over_t(cuda_device):
    """Rows of T - 1 and T valid seeds stay on the warp path; each row of
    T + 1 or more takes the block path, once per call."""
    T = cuda_seed.CLUSTER_WARP_T
    args = tensors(seed_cases.cluster_count_case(
        np.random.default_rng(11), 4096, counts=(T - 1, T, T + 1, 4096),
        copies=5), cuda_device)
    cuda_seed.block_rows_reset()
    for calls in (1, 2):
        cuda_seed.cluster_topc(*args, band_radius=16, max_candidates=8)
        torch.cuda.synchronize()
        assert cuda_seed.block_rows_read() == 10 * calls
        assert cuda_seed.cluster_topc.block_rows == 10 * calls
    cuda_seed.block_rows_reset()
    assert cuda_seed.block_rows_read() == 0


@pytest.mark.gpu
def test_shared_memory_attributes_are_set_once(cuda_device):
    rng = np.random.default_rng(12)
    cl = tensors(seed_cases.cluster_case(rng, 16, 4096), cuda_device)
    keys = torch.from_numpy(seed_cases.argsort_case(rng, 9000)).to(
        cuda_device)
    cuda_seed.cluster_topc(*cl, band_radius=16, max_candidates=8)
    cuda_seed.argsort_i32(keys)
    torch.cuda.synchronize()
    sets = cuda_seed.attribute_sets()
    assert sets > 0
    for _ in range(3):
        cuda_seed.cluster_topc(*cl, band_radius=16, max_candidates=8)
        cuda_seed.argsort_i32(keys)
        cuda_seed.argsort_i32(keys[:100])
    torch.cuda.synchronize()
    assert cuda_seed.attribute_sets() == sets


@pytest.mark.gpu
@pytest.mark.parametrize("n", seed_cases.ARGSORT_SIZES)
def test_argsort_kernel_is_the_stable_permutation(cuda_device, n):
    keys = seed_cases.argsort_case(np.random.default_rng(n), n)
    before = cuda_seed.argsort_i32.launches
    got = cuda_seed.argsort_i32(torch.from_numpy(keys).to(cuda_device))
    torch.cuda.synchronize()
    assert cuda_seed.argsort_i32.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.argsort(keys, kind="stable"))


@pytest.mark.gpu
def test_wrappers_route_and_reject_on_card(cuda_device):
    """Above 16384 keys the argsort is torch's (no launch); shapes the
    kernels do not take raise."""
    keys = seed_cases.argsort_case(np.random.default_rng(3), 20000)
    before = cuda_seed.argsort_i32.launches
    got = cuda_seed.argsort_i32(torch.from_numpy(keys).to(cuda_device))
    assert cuda_seed.argsort_i32.launches == before
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.argsort(keys, kind="stable"))
    z = torch.zeros((4, 8192), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="power of two"):
        cuda_seed.cluster_topc(z, z, z, z.float(), band_radius=16,
                               max_candidates=8)
    w = torch.zeros((4, 1100), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="m <= 1024"):
        cuda_seed.softcap_compact(w.float(), w.bool(), w.bool(), w, w, w,
                                  score_fraction=0.9)
