"""The port's seeding functions against the JAX package's, on the CPU:
the plain versions of the three seeding kernels (vg_tpu_torch.ops.cuda_seed,
which CPU tensors run) against vg_tpu.ops.pallas_seed's Pallas kernels in
interpret mode, and vg_tpu_torch.ops.devseed against vg_tpu.ops.devseed.
The same numpy-seeded inputs go to both. Tolerance: exact everywhere. The
scores are multiples of 1/256, as the quantized score table makes them on
the path, except in seed_cases.cluster_float_case, where exactness rests on
the plain version adding the scores in vg_tpu's order."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from vg_tpu.index.minimizer import minimizer_score_table
from vg_tpu.ops import devseed as jax_devseed
from vg_tpu.ops import pallas_seed
from vg_tpu_torch.ops import cuda_seed, seed_cases
from vg_tpu_torch.ops import devseed as t_devseed

I32MAX = 2**31 - 1
TAB = minimizer_score_table(500, 500)
# The suite runs in several worker processes at once: torch's intra-op
# threads (spinning OpenMP) would oversubscribe the cores many times over.
torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def softcap_inputs(rng, R, m):
    """Quantized scores from the table; rows with nothing kept, all cheap,
    none cheap and tied scores among them."""
    cnt = rng.integers(0, 40, (R, m))
    cnt[0] = 0                              # nothing kept
    cnt[1] = rng.integers(1, 11, m)         # all cheap
    cnt[2] = rng.integers(11, 31, m)        # none cheap
    cnt[3] = 7                              # one tied score everywhere
    keep = (cnt > 0) & (cnt <= 30)
    ms = np.where(keep, TAB[np.minimum(cnt, 500)], 0).astype(np.float32)
    cheap = keep & (cnt <= 10)
    hs = rng.integers(0, 1000, (R, m)).astype(np.int32)
    cr = rng.integers(0, 2, (R, m)).astype(np.int32)
    return ms, keep, cheap, hs, cnt.astype(np.int32), cr


def test_softcap_compact_equals_vg_tpu():
    args = softcap_inputs(np.random.default_rng(0), 64, 132)
    want = pallas_seed.softcap_compact(*args, score_fraction=0.9)
    got = cuda_seed.softcap_compact(*(t(a) for a in args),
                                    score_fraction=0.9)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (64, 256) and g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def assert_softcap_equal(args, sf):
    want = pallas_seed.softcap_compact(*args, score_fraction=sf)
    got = cuda_seed.softcap_compact(*(t(a) for a in args),
                                    score_fraction=sf)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kind,sf", [("kept", 0.9), ("sign", 0.9),
                                     ("budget", 0.5)])
def test_softcap_compact_equals_vg_tpu_on_edge_rows(kind, sf):
    """Rows of 31-33 and 63-65 kept columns; zeros of either sign and
    negative scores (the order puts them after the positive scores, as
    float compares rank -0.0 with 0.0); exclusive sums equal to the
    budget at an expensive column (the strict < leaves it)."""
    rng = np.random.default_rng(30)
    args = {"kept": lambda: seed_cases.softcap_kept_case(rng),
            "sign": lambda: seed_cases.softcap_sign_case(rng, 24),
            "budget": lambda: seed_cases.softcap_budget_case(rng, 24)}[kind]()
    assert_softcap_equal(args, sf)


def cluster_inputs(rng, R, S, B):
    """tests/test_pallas_seed.py's generator: seeds around a few diagonal
    hotspots, duplicate read offsets, quantized scores."""
    valid = rng.random((R, S)) < 0.4
    strandk = np.where(valid, rng.integers(0, 2, (R, S)), 2).astype(
        np.int32)
    hot = rng.integers(0, 100000, (R, 6))
    diag = hot[np.arange(R)[:, None], rng.integers(0, 6, (R, S))] \
        + rng.integers(-B, B + 1, (R, S))
    diagk = np.where(valid, diag, I32MAX).astype(np.int32)
    ok = np.where(valid, rng.integers(0, 120, (R, S)), I32MAX).astype(
        np.int32)
    score = np.where(valid, rng.choice([1.0, 1.5, 2.25, 4.0], (R, S)),
                     0.0).astype(np.float32)
    return strandk, diagk, ok, score


def assert_cluster_equal(args, B, C):
    want = pallas_seed.cluster_topc(*args, band_radius=B, max_candidates=C)
    got = cuda_seed.cluster_topc(*(t(a) for a in args), band_radius=B,
                                 max_candidates=C)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("S", [256, 1024])
def test_cluster_topc_equals_vg_tpu(S):
    assert_cluster_equal(cluster_inputs(np.random.default_rng(1), 24, S, 16),
                         16, 8)


def test_cluster_topc_empty_and_single_rows():
    """tests/test_pallas_seed.py's rows: no seed, one seed, two clusters
    (the second scoring higher)."""
    R, S = 3, 256
    strandk = np.full((R, S), 2, np.int32)
    diagk = np.full((R, S), I32MAX, np.int32)
    ok = np.full((R, S), I32MAX, np.int32)
    score = np.zeros((R, S), np.float32)
    strandk[1, 0], diagk[1, 0], ok[1, 0], score[1, 0] = 0, 500, 3, 2.0
    strandk[2, :3] = [0, 0, 1]
    diagk[2, :3] = [100, 105, 9000]
    ok[2, :3] = [5, 9, 7]
    score[2, :3] = [1.0, 1.0, 3.0]
    assert_cluster_equal((strandk, diagk, ok, score), 16, 4)


def test_cluster_topc_equals_vg_tpu_at_seed_counts():
    """Rows of exactly 1, 31, 32, 33, T - 1, T and T + 1 valid seeds (T the
    kernel's warp-path limit) and a full row of S = 1024."""
    args = seed_cases.cluster_count_case(
        np.random.default_rng(6), 1024,
        counts=seed_cases.CLUSTER_COUNTS[:-1] + (1024,), copies=1)
    T = cuda_seed.CLUSTER_WARP_T
    np.testing.assert_array_equal(
        (args[0] < 2).sum(1), [1, 31, 32, 33, T - 1, T, T + 1, 1024])
    assert_cluster_equal(args, 16, 8)


@pytest.mark.parametrize("S", [256, 1024])
def test_cluster_topc_equals_vg_tpu_on_float_scores(S):
    """Arbitrary float32 scores: pairs of clusters with the same scores in
    another order, whose totals differ or tie by rounding alone."""
    args = seed_cases.cluster_float_case(np.random.default_rng(S + 7), 16, S)
    assert (args[3] * 256 != np.round(args[3] * 256)).any()
    assert_cluster_equal(args, 16, 8)


@pytest.mark.parametrize("n", [257, 2049, 8192])
def test_argsort_plain_is_stable_at_kernel_widths(n):
    keys = seed_cases.argsort_case(np.random.default_rng(n), n)
    got = cuda_seed.argsort_i32_ref(t(keys))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.argsort(keys, kind="stable"))


def test_argsort_equals_vg_tpu_on_distinct_keys():
    rng = np.random.default_rng(2)
    for n in (200, 1000):
        keys = rng.permutation(4 * n)[:n].astype(np.int32) - 2 * n
        want = np.asarray(pallas_seed.argsort_i32(keys))
        got = cuda_seed.argsort_i32(t(keys))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def tied_keys(rng, n):
    keys = rng.integers(0, 20, n).astype(np.int32)
    keys[rng.random(n) < 1 / 3] = I32MAX
    return keys


@pytest.mark.parametrize("n", [200, 1000])
def test_argsort_is_stable_on_ties(n):
    keys = tied_keys(np.random.default_rng(n), n)
    got = cuda_seed.argsort_i32(t(keys)).numpy()
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))


def test_argsort_reference_fault_is_not_ported():
    """vg_tpu's argsort_i32 sorts the padded row by key alone, so at
    n = 200 (padded to 256 with I32MAX) some of its entries are padding
    slots (>= n) that tie with real I32MAX keys. The port returns the
    stable permutation."""
    keys = tied_keys(np.random.default_rng(200), 200)
    jax_perm = np.asarray(pallas_seed.argsort_i32(keys))
    assert (jax_perm >= 200).sum() > 0
    got = cuda_seed.argsort_i32(t(keys)).numpy()
    assert (got < 200).all()
    assert sorted(got.tolist()) == list(range(200))


def test_wang_hash64_equals_vg_tpu():
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 1 << 63, 256, dtype=np.uint64)
    hi, lo = jax_devseed.split_keys(xs)
    wh, wl = jax_devseed.wang_hash64(jnp.asarray(hi), jnp.asarray(lo))
    gh, gl = t_devseed.wang_hash64(t(hi.astype(np.int64)),
                                   t(lo.astype(np.int64)))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


@pytest.mark.parametrize("k,w", [(29, 11), (21, 9), (15, 5)])
def test_rolling_minimizers_equals_vg_tpu(k, w):
    rng = np.random.default_rng(3)
    R, L = 8, 150
    codes = np.full((R, L + 10), 5, np.uint8)
    codes[:, :L] = rng.integers(0, 4, (R, L))
    codes[2, 40] = 4                 # an N breaks windows
    codes[5, 10:20] = 4
    rlen = np.full(R, L, np.int32)
    rlen[6] = 100                    # a short read: windows end at rlen
    codes[6, 100:] = 5
    want = jax_devseed.rolling_minimizers(codes, rlen, k, w)
    got = t_devseed.rolling_minimizers(t(codes), t(rlen), k, w)
    for g, wa in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wa))


def synthetic_index(rng, kh, kl, chosen, n_keys, max_hits):
    """tests/test_pallas_seed.py's fuzz index: some of the reads' own keys
    plus noise, random hit counts, positions and strands."""
    real = (np.asarray(kh).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(kl).astype(np.uint64)
    real = np.unique(real[np.asarray(chosen)])
    noise = rng.integers(0, 1 << 58, n_keys, dtype=np.uint64)
    keys = np.unique(np.concatenate([real[: n_keys // 2], noise]))
    counts = rng.integers(1, max_hits + 1, len(keys))
    offsets = np.zeros(len(keys) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    pos_text = rng.integers(0, 1 << 20, int(offsets[-1])).astype(np.int32)
    pos_rev = rng.integers(0, 2, int(offsets[-1])).astype(np.uint8)
    return keys, offsets.astype(np.int32), pos_text, pos_rev


def test_lookup_ranges2_equals_vg_tpu():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, (16, 150)).astype(np.uint8)
    kh, kl, _, chosen, _ = jax_devseed.rolling_minimizers(
        codes, np.full(16, 150, np.int32), 29, 11)
    keys, offsets, _, _ = synthetic_index(rng, kh, kl, chosen, 400, 4)
    ih, il = jax_devseed.split_keys(keys)
    want = jax_devseed.lookup_ranges2(
        jnp.asarray(kh), jnp.asarray(kl), jnp.asarray(ih), jnp.asarray(il),
        jnp.asarray(offsets))
    got = t_devseed.lookup_ranges2(
        t(np.asarray(kh).astype(np.int64)), t(np.asarray(kl).astype(np.int64)),
        t(ih.astype(np.int64)), t(il.astype(np.int64)), t(offsets))
    assert int((got[1] > got[0]).sum()) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_seed_candidates_dev_equals_vg_tpu():
    """Lookup, soft caps, hit expansion (a minimizer above Hd hits dropped
    whole), clustering and top-C, with the quantized score table."""
    rng = np.random.default_rng(42)
    R, L, k, w = 16, 150, 29, 11
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    rlen = np.full(R, L, np.int32)
    rlen[3] = 120
    codes[3, 120:] = 5
    kh, kl, cr, chosen, valid = jax_devseed.rolling_minimizers(
        codes, rlen, k, w)
    keys, offsets, pos_text, pos_rev = synthetic_index(
        rng, kh, kl, chosen, 400, 80)
    ih, il = jax_devseed.split_keys(keys)
    kw = dict(k=k, hit_cap=10, hard_hit_cap=500, score_fraction=0.9,
              max_candidates=8, band_radius=16)
    want = jax_devseed.seed_candidates_dev(
        kh, kl, cr, chosen, valid, jnp.asarray(rlen), jnp.asarray(ih),
        jnp.asarray(il), jnp.asarray(offsets), jnp.asarray(pos_text),
        jnp.asarray(pos_rev), jnp.asarray(TAB), **kw)
    tk = t_devseed.rolling_minimizers(t(codes), t(rlen), k, w)
    got = t_devseed.seed_candidates_dev(
        *tk, t(rlen), t(ih.astype(np.int64)), t(il.astype(np.int64)),
        t(offsets), t(pos_text), t(pos_rev), t(TAB), **kw)
    assert bool(got[2].any())
    for g, wa in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wa))
