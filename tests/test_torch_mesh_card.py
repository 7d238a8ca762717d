"""The text-sharded steps on the card: parallel/shard_cases.shard_case (the
shard-edge windows: negative local starts, windows reading the halo,
windows past the text, lo and hi clipped, masked slots) through the
text-sharded paired step and the rescue scorer, every score by kernel 1c
(banded_dp_bytes), equal to the same steps on the CPU (its plain
version); and the dry run with NCCL, one rank a card. Imports no JAX, so
it runs on a machine that has only the card's stack:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mesh_card.py

Here, without a card, the `gpu` tests skip and the CPU test runs."""
import subprocess
import sys

import pytest
import torch

from vg_tpu_torch.ops import cuda_align
from vg_tpu_torch.parallel import mesh as pmesh
from vg_tpu_torch.parallel.shard_cases import B, RL, sharded_inputs

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The card, for the `gpu` tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("D", [2, 4])
def test_shard_case_reaches_the_edges(D):
    """The case's own checks: on D shards it has valid windows with a
    negative local start, windows reading the halo, lo clipped to -1 and
    hi to Ls, and masked slots."""
    own, halo, step, _ = sharded_inputs(D, torch.device("cpu"))
    c1 = step[5]
    sl, _ow, lo_l, hi_l, _hap, _rev, v = (x.numpy() for x in c1[:7])
    assert (v & (sl < 0)).sum() > 0
    assert (v & (sl + RL + 2 * B > own)).sum() > 0
    assert (v & (lo_l == -1)).sum() > 0
    assert (v & (hi_l == own + halo)).sum() > 0
    assert (~v).sum() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_steps_on_card_equal_cpu(cuda_device, D):
    _, _, step_c, rescue_c = sharded_inputs(D, torch.device("cpu"))
    own, halo, step_g, rescue_g = sharded_inputs(D, cuda_device)
    tstep = pmesh.make_sharded_text_paired_step(D, own, halo, band_radius=B)
    scorer = pmesh.make_sharded_rescue_scorer(D, band_radius=B)
    before = cuda_align.banded_scores_bytes.launches
    got = tstep(*step_g)
    got_r = scorer(*rescue_g)
    torch.cuda.synchronize()
    assert cuda_align.banded_scores_bytes.launches - before == 3 * D
    for i, (g, w) in enumerate(zip(got, tstep(*step_c))):
        assert torch.equal(g.cpu(), w), f"output {i}"
    assert torch.equal(got_r.cpu(), scorer(*rescue_c))


@pytest.mark.gpu
def test_dryrun_on_the_card(cuda_device):
    """The dry run with NCCL, one rank on each card of the host."""
    n = torch.cuda.device_count()
    out = subprocess.run(
        [sys.executable, "-m", "vg_tpu_torch.parallel.dryrun", "--nproc",
         str(n), "--timeout", "240"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"dryrun_multichip OK on {n} ranks (cuda, nccl)" in out.stdout
