"""The port's text-sharded steps (vg_tpu_torch.parallel.mesh) against the JAX
package's, in one process: the host split and localization, the
gapless bitmaps of every candidate, and the text-sharded paired step and
rescue scorer holding all D shards at once (vg_tpu's functions as they run
on one device), D = 1, 2 and 4, every output exact, and equal to the
replicated steps.

Inputs: parallel/shard_cases.shard_case, __graft_entry__._example_batch's
size with dryrun_multichip's mate 2 and the shard-edge windows (negative
local starts, windows reading the halo, windows past the text, lo and hi
clipped to -1 and Ls, masked slots); each test shows it reaches them. Then
rescue candidates from the port's own PairedGiraffeMapper."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from __graft_entry__ import _example_batch
from vg_tpu.index.haplotypes import thread_haplotypes
from vg_tpu.index.minimizer import MinimizerIndex
from vg_tpu.io import native as jax_native
from vg_tpu.parallel import mesh as jmesh
from vg_tpu_torch.convert import state_from_arrays
from vg_tpu_torch.io.fastq import Read
from vg_tpu_torch.map import giraffe as tg
from vg_tpu_torch.map.paired import PairedGiraffeMapper
from vg_tpu_torch.ops import align as torch_align
from vg_tpu_torch.parallel import dryrun
from vg_tpu_torch.parallel import mesh as tmesh
from vg_tpu_torch.parallel.shard_cases import B, RL, SD, MU, shard_case
from vg_tpu_torch.utils import dna

HALO = RL + 2 * B + 16          # the wrappers' default halo
NAMES = ["s1", "s2", "j1", "j2", "mq1", "mq2", "use_pair", "frags", "mm1",
         "mm2", "bits1", "bits2", "stats", "cov"]
# The suite runs in several worker processes at once: torch's intra-op
# threads (spinning OpenMP) would oversubscribe the cores many times over.
torch.set_num_threads(1)


def jax_tree(x):
    return tuple(jax_tree(a) for a in x) if isinstance(x, tuple) \
        else jnp.asarray(x)


def torch_tree(x):
    return tuple(torch_tree(a) for a in x) if isinstance(x, tuple) \
        else torch.from_numpy(np.ascontiguousarray(x))


def assert_same(got, want, names):
    for name, g, w in zip(names, got, want):
        g = g.numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=name)


def plan(text, D):
    """vg_tpu's host split, and the port's: equal."""
    own, shards = jmesh.split_text_shards(text, D, HALO)
    t_own, t_shards = tmesh.split_text_shards(text, D, HALO)
    assert t_own == own
    np.testing.assert_array_equal(t_shards, shards)
    return own, shards


def localized(cand, own, D):
    want = jmesh.localize_candidates(cand, own, D, HALO)
    got = tmesh.localize_candidates(cand, own, D, HALO)
    for name, g, w in zip(["start_l", "owner", "lo_l", "hi_l", "hap", "rev",
                           "valid", "rp", "ro"], got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    return got


def test_example_batch_is_graft_entrys():
    for kw in ({}, dict(R=64, RL=64, C=4, B=8, T=8192, seed=3)):
        for g, w in zip(dryrun._example_batch(**kw), _example_batch(**kw)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_split_and_localize_equal_jax(D):
    """Split and localize equal vg_tpu's on both mates and the rescue
    windows; the shard-edge branches are reached (for D > 1: negative
    local starts, windows reading the halo, lo clipped to -1 and hi to
    Ls; always: masked slots, three haplotype ids)."""
    text, mate1, mate2, (_, _, r_start, r_lo, r_hi, r_valid) = shard_case()
    own, _ = plan(text, D)
    plan(text[:-5], D)                   # a text that does not split evenly
    np.testing.assert_array_equal(
        tmesh.basediff_table(own, D),
        np.clip(np.arange(D)[None, :] * own - np.arange(D)[:, None] * own,
                -(2 ** 30), 2 ** 30).astype(np.int32))
    zeros = np.zeros_like(r_valid)
    rescue = (r_start, r_lo, r_hi, zeros, r_valid,
              np.full(r_valid.shape, -1), np.zeros(r_valid.shape, np.int64))
    counts = np.zeros(5, int)
    for cand in (mate1[3], mate2[3], rescue):
        sl, _ow, lo_l, hi_l, hap, _rev, v, _rp, _ro = localized(cand, own, D)
        counts += [(v & (sl < 0)).sum(), (v & (sl + RL + 2 * B > own)).sum(),
                   (v & (lo_l == -1)).sum(), (v & (hi_l == own + HALO)).sum(),
                   (~v).sum()]
        assert hap.max() == 2
    assert counts[0] > 0 and counts[4] > 0, counts
    if D > 1:
        assert (counts[1:4] > 0).all(), counts


def test_localize_int64_equals_jax():
    """tests/test_mesh.py's global coordinates past int32 (8 shards of 0.7
    Gbp): owners, local starts, dense haplotype ids equal vg_tpu's, and
    the saturated base-offset table."""
    own, D, halo = 700_000_000, 8, 200
    cand = (np.array([[5_000_000_123, 2_100_000_050]], np.int64),
            np.array([[4_900_000_000, 2_100_000_000]], np.int64),
            np.array([[5_600_000_000, 2_800_000_000]], np.int64),
            np.zeros((1, 2), bool), np.ones((1, 2), bool),
            np.full((1, 2), -1, np.int32), np.zeros((1, 2), np.int32))
    got = tmesh.localize_candidates(cand, own, D, halo)
    want = jmesh.localize_candidates(cand, own, D, halo)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[1].tolist() == [[7, 3]] and got[4].tolist() == [[1, 0]]
    bd = tmesh.basediff_table(own, D)
    assert bd[3, 3] == 0 and bd[0, 7] == 2 ** 30 and bd[7, 0] == -(2 ** 30)
    assert bd[2, 3] == own


@pytest.mark.parametrize("D", [2, 4])
def test_mismatch_bits_all_equals_jax(D):
    text, (reads, reads_rc, rlen, cand), _, _ = shard_case()
    own, shards = plan(text, D)
    sl, ow, lo_l, hi_l, _hap, rev, valid, _rp, _ro = localized(cand, own, D)
    for d in range(D):
        v = valid & (ow == d)
        args = (reads, reads_rc, rlen, sl, lo_l, hi_l, rev, v)
        want = jmesh._mismatch_bits_all(jnp.asarray(shards[d]), B,
                                        *jax_tree(args))
        got = tmesh._mismatch_bits_all(torch.from_numpy(shards[d]), B,
                                       *torch_tree(args))
        assert_same(got, want, ["mm", "bits"])
        assert int(got[0].sum()) > 0


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_text_step_in_process(D):
    """make_sharded_text_paired_step with all D shards in one process
    equals vg_tpu's on one JAX device, and the port's replicated
    make_paired_step, in every output (MAPQs and stats included)."""
    text, mate1, mate2, _ = shard_case()
    own, shards = plan(text, D)
    c1 = localized(mate1[3], own, D)
    c2 = localized(mate2[3], own, D)
    bd = tmesh.basediff_table(own, D)
    args = (bd, *mate1[:3], c1, *mate2[:3], c2)
    jstep = jmesh.make_sharded_text_paired_step(D, own, HALO, band_radius=B)
    want = jax.jit(jstep)(jnp.asarray(shards), *jax_tree(args),
                          jnp.float32(MU), jnp.float32(SD))
    tstep = tmesh.make_sharded_text_paired_step(D, own, HALO, band_radius=B)
    got = tstep(torch.from_numpy(shards), *torch_tree(args), MU, SD)
    assert_same(got, want, NAMES)
    repl = tmesh.make_paired_step(band_radius=B)(
        torch.from_numpy(text), *torch_tree(mate1), *torch_tree(mate2),
        MU, SD)
    for name, g, w in zip(NAMES, got, repl):
        assert torch.equal(g, w), name
    assert bool(got[6].any()), "no pair was chosen"
    # one rank's part alone needs its group to make up the D shards
    if D > 1:
        with pytest.raises(ValueError):
            tstep(torch.from_numpy(shards[:1]), *torch_tree(args), MU, SD,
                  shard_ids=[0])


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_rescue_scorer_in_process(D):
    """The rescue scorer with all D shards equals vg_tpu's and the
    replicated byte-text DP (the plain version of kernel 1c)."""
    text, _, _, (reads, rlen, r_start, r_lo, r_hi, r_valid) = shard_case()
    own, shards = plan(text, D)
    zeros = np.zeros_like(r_valid)
    sl, ow, lo_l, hi_l, _, _, v, _, _ = localized(
        (r_start, r_lo, r_hi, zeros, r_valid, np.full(r_valid.shape, -1),
         np.zeros(r_valid.shape, np.int64)), own, D)
    args = (reads, rlen, sl, ow, lo_l, hi_l, v)
    want = jax.jit(jmesh.make_sharded_rescue_scorer(D, band_radius=B))(
        jnp.asarray(shards), *jax_tree(args))
    got = tmesh.make_sharded_rescue_scorer(D, band_radius=B)(
        torch.from_numpy(shards), *torch_tree(args))
    assert_same((got,), (want,), ["scores"])
    repl = torch_align.banded_scores(
        *torch_tree((text, reads, reads, rlen, r_start, r_lo, r_hi, zeros,
                     r_valid)), band_radius=B)
    assert torch.equal(got, torch.where(torch.from_numpy(r_valid), repl, -1))
    assert int((got > 0).sum()) >= 9


@pytest.fixture(scope="module")
def rescue_state(tmp_path_factory):
    """Rescue candidates from the port's PairedGiraffeMapper, as
    tests/test_mesh.py builds them: 16 pairs 300 bp apart, mate 2's
    candidates wiped so every pair needs rescue, then _rescue_begin."""
    rng = np.random.default_rng(5)
    g, results, vcf = bench.make_pangenome(rng, ref_len=30_000)
    haps = thread_haplotypes(g, results, vcf)
    idx = MinimizerIndex.build(haps)
    d = tmp_path_factory.mktemp("index")
    jax_native.save_graph(str(d / "g.npz"), g)
    jax_native.save_haplotypes(str(d / "h.npz"), haps)
    jax_native.save_minimizer(str(d / "m.npz"), idx)
    _, t_haps, t_idx = state_from_arrays(
        *(dict(np.load(d / f)) for f in ("g.npz", "h.npz", "m.npz")))
    m = tg.GiraffeMapper(t_haps, t_idx, tg.GiraffeParams(batch_reads=16),
                         device="cpu")
    pm = PairedGiraffeMapper(m)
    for _ in range(64):
        pm.fragdist.add(420.0)
    pm.fragdist.finalize()
    pairs = []
    for i in range(16):
        s = int(rng.integers(0, t_haps.total_len - 500))
        c1 = t_haps.text[s : s + 100].copy()
        c2 = t_haps.text[s + 300 : s + 400].copy()
        pairs.append((Read(f"a{i}", dna.decode(c1), None),
                      Read(f"b{i}", dna.decode(dna.revcomp_codes(c2)),
                           None)))
    sb1, sb2 = pm.score_pairs(pairs)
    _ = sb1.scores, sb2.scores
    sb2.cand_valid[:] = False
    state = pm._rescue_begin(sb1, sb2)
    assert state is not None, "rescue did not fire"
    todo, r_start, r_lo, r_hi, r_rev, r_valid, scores_host = state
    assert len(todo) == 16 and r_valid.any()
    # oriented needy reads, as _score_rescues_host packs them
    Lmax = max(len(c) for c in sb2.codes)
    reads = np.full((16, Lmax), 5, np.uint8)
    rlen = np.zeros(16, np.int32)
    row_rev = r_rev.any(axis=1)
    for i in range(16):
        c = sb2.codes_rc[i] if row_rev[i] else sb2.codes[i]
        reads[i, : len(c)] = c
        rlen[i] = len(c)
    return (t_haps.text, reads, rlen, r_start, r_lo, r_hi, r_valid,
            np.asarray(scores_host), m.params)


def test_sharded_rescue_from_production_state(rescue_state):
    """The port's rescue candidates scored on 8 text shards in one
    process (the windows fall on the first haplotype, the first two
    shards): equal to the host rescue scores and to vg_tpu's scorer."""
    (text, reads, rlen, r_start, r_lo, r_hi, r_valid, host,
     p) = rescue_state
    D = 8
    halo = reads.shape[1] + 2 * p.band_radius + 16
    own, shards = tmesh.split_text_shards(text, D, halo)
    zeros = np.zeros_like(r_valid)
    loc = tmesh.localize_candidates(
        (r_start, r_lo, r_hi, zeros, r_valid, np.full(r_valid.shape, -1),
         np.zeros(r_valid.shape, np.int64)), own, D, halo)
    args = (reads, rlen, *loc[:4], loc[6])
    kw = dict(band_radius=p.band_radius, match=p.match, mismatch=p.mismatch,
              gap_open=p.gap_open, gap_extend=p.gap_extend,
              bonus=p.full_length_bonus)
    got = tmesh.make_sharded_rescue_scorer(D, **kw)(
        torch.from_numpy(shards), *torch_tree(args)).numpy()
    np.testing.assert_array_equal(got, np.where(r_valid, host, -1))
    want = jax.jit(jmesh.make_sharded_rescue_scorer(D, **kw))(
        jnp.asarray(shards), *jax_tree(args))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got[r_valid] > 0).any()
    assert len(set(loc[1][r_valid].tolist())) > 1, "one shard owns all"
