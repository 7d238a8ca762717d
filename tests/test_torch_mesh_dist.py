"""The port's sharded steps on four gloo ranks against vg_tpu's on JAX
meshes of the same shapes (conftest's 8 virtual CPU devices).

Each mesh shape is one spawn of four CPU ranks (parallel/dryrun.run_ranks;
the ranks run parallel/shard_cases.case_rank, which imports no JAX, and
each rank checks that before it exits): (4,) runs sharded_map_step and
sharded_paired_step, (2, 2) sharded_text_paired_step and
sharded_rescue_scores, (1, 4) sharded_text_paired_step. The test gathers
the data-sharded rows from the ranks' saved outputs. Integer outputs and
MAPQs are exact, and so is the fragment count; the fragment sums are held
to rtol 1e-5, as tests/test_mesh.py holds vg_tpu's across device counts
(the ranks sum their rows apart, in another order). Then the dry run as a
command, on four ranks, and the launcher's deadline and failure paths.
Each spawn has a deadline, so a hung rank fails its test."""
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from vg_tpu.parallel import mesh as jmesh
from vg_tpu_torch.parallel import dryrun, shard_cases
from vg_tpu_torch.parallel import mesh as tmesh
from vg_tpu_torch.parallel.shard_cases import B, MU, SD, shard_case

NPROC = 4
DEADLINE_S = 40.0
NAMES = ["s1", "s2", "j1", "j2", "mq1", "mq2", "use_pair", "frags", "mm1",
         "mm2", "bits1", "bits2", "stats", "cov"]
REPLICATED = ("stats", "cov")
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """shape -> the four ranks' saved outputs, one spawn a shape."""
    cache = {}

    def run(shape):
        if shape not in cache:
            d = tmp_path_factory.mktemp("ranks")
            dryrun.run_ranks(NPROC, shard_cases.case_rank, (shape, str(d)),
                             device="cpu", timeout=DEADLINE_S)
            cache[shape] = [dict(np.load(d / f"rank{r}.npz"))
                            for r in range(NPROC)]
        return cache[shape]
    return run


def gathered(outs, shape, key):
    """A data-sharded output's rows in data-rank order (rank = d * dt + t,
    row-major), each text rank of a data rank holding the same rows."""
    dt = shape[-1] if len(shape) == 2 else 1
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o[key], outs[r - r % dt][key],
                                      err_msg=f"{key} on rank {r}")
    return np.concatenate([outs[d * dt][key]
                           for d in range(len(outs) // dt)])


def replicated(outs, key):
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o[key], outs[0][key],
                                      err_msg=f"{key} on rank {r}")
    return outs[0][key]


def assert_step_equal(outs, shape, want):
    for i, (name, w) in enumerate(zip(NAMES, want)):
        w = np.asarray(w)
        key = f"step_{i}"
        g = replicated(outs, key) if name in REPLICATED else \
            gathered(outs, shape, key)
        assert g.shape == w.shape, name
        if name == "stats":
            assert g[0] == w[0], (g, w)
            np.testing.assert_allclose(g[1:], w[1:], rtol=1e-5, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w,
                                          err_msg=name)


def jax_mesh(shape):
    devs = np.array(jax.devices()[:NPROC]).reshape(shape)
    return Mesh(devs, ("data",) if len(shape) == 1 else ("data", "text"))


def test_sharded_map_step_four_ranks(ranks):
    outs = ranks((4,))
    text, (reads, reads_rc, rlen, cand), _, _ = shard_case()
    want_s, want_cov = jmesh.sharded_map_step(
        jmesh.make_mesh(NPROC), text, reads, reads_rc, rlen, *cand[:5],
        band_radius=B)
    np.testing.assert_array_equal(gathered(outs, (4,), "map_scores"),
                                  np.asarray(want_s))
    cov = replicated(outs, "map_cov")
    np.testing.assert_array_equal(cov, np.asarray(want_cov))
    assert cov.sum() == (np.asarray(want_s).max(1) > 0).sum()


def test_sharded_paired_step_four_ranks(ranks):
    outs = ranks((4,))
    text, mate1, mate2, _ = shard_case()
    want = jmesh.sharded_paired_step(jmesh.make_mesh(NPROC), text, mate1,
                                     mate2, mu=MU, sd=SD, band_radius=B)
    assert_step_equal(outs, (4,), want)
    assert replicated(outs, "step_13").sum() == 2 * len(mate1[0])


def test_uneven_batch_raises(ranks):
    """R - 1 rows on four data ranks: ValueError on every rank, as
    jax.device_put rejects such a batch."""
    assert [int(o["uneven_raises"]) for o in ranks((4,))] == [1] * NPROC


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_sharded_text_paired_step(ranks, shape):
    outs = ranks(shape)
    text, mate1, mate2, _ = shard_case()
    want = jmesh.sharded_text_paired_step(jax_mesh(shape), text, mate1,
                                          mate2, mu=MU, sd=SD, band_radius=B)
    assert_step_equal(outs, shape, want)


def test_sharded_rescue_scores_2x2(ranks):
    outs = ranks((2, 2))
    text, _, _, rescue = shard_case()
    want = jmesh.sharded_rescue_scores(jax_mesh((2, 2)), text, *rescue,
                                       band_radius=B)
    got = replicated(outs, "rescue")
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got > 0).sum() >= 9


def test_dryrun_command_four_ranks():
    out = subprocess.run(
        [sys.executable, "-m", "vg_tpu_torch.parallel.dryrun", "--nproc",
         "4", "--device", "cpu", "--timeout", str(DEADLINE_S)],
        capture_output=True, text=True, timeout=2 * DEADLINE_S)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "dryrun_multichip OK on 4 ranks" in out.stdout


def test_run_ranks_deadline_kills_the_ranks(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        dryrun.run_ranks(NPROC, shard_cases.case_rank, ((4,), str(tmp_path)),
                         device="cpu", timeout=0.5)
    assert time.monotonic() - t0 < 20
    assert not list(tmp_path.iterdir()), "a rank ran on past the deadline"


def test_run_ranks_reports_a_failed_rank(tmp_path):
    """A mesh shape that does not cover the ranks: every rank raises in
    make_mesh, and the launcher says so without waiting for a deadline."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="ranks failed"):
        dryrun.run_ranks(NPROC, shard_cases.case_rank,
                         ((3, 2), str(tmp_path)), device="cpu",
                         timeout=DEADLINE_S)
    assert time.monotonic() - t0 < DEADLINE_S / 2


def test_make_mesh_defaults_to_the_card():
    """make_mesh() with no arguments asks for a CUDA/NCCL mesh: without a
    card it raises before it touches torch.distributed."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh would be built")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_mesh()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError):
        tmesh.make_mesh(device="tpu")
