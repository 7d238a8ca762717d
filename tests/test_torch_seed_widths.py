"""The soft-cap selection's plain version (vg_tpu_torch.ops.cuda_seed,
which CPU tensors run) against vg_tpu's Pallas kernel in interpret mode at
every row width the kernel takes: m from 1 to 1024, so mpad = 128, 256,
512 and 1024 and both sides of each power of two. Quantized scores;
exact. (The kernel itself is held against the plain version at the same
widths in tests/test_torch_seed_kernel.py, on the card.)"""
import numpy as np
import pytest
import torch

from vg_tpu.ops import pallas_seed
from vg_tpu_torch.ops import cuda_seed, seed_cases

# The suite runs in several worker processes at once: torch's intra-op
# threads (spinning OpenMP) would oversubscribe the cores many times over.
torch.set_num_threads(1)


@pytest.mark.parametrize("m", seed_cases.SOFTCAP_WIDTHS)
def test_softcap_compact_equals_vg_tpu_at_width(m):
    args = seed_cases.softcap_case(np.random.default_rng(m), 8, m)
    want = pallas_seed.softcap_compact(*args, score_fraction=0.9)
    got = cuda_seed.softcap_compact(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in args),
        score_fraction=0.9)
    mpad = cuda_seed.pow2_ge(max(m, 128))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == (8, mpad) and g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
