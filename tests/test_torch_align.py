"""The port's banded DP (vg_tpu_torch.ops.align / ops.cuda_align) against
the JAX package's: plain torch DP vs the XLA scan, the packed-text plain
version vs the same reference, the DP over gathered windows vs the Pallas
kernel in interpret mode, and pack_text byte for byte. All exact: the DP
is integer arithmetic. The CUDA kernel itself is held against its plain
version in tests/test_torch_kernel.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vg_tpu.ops import align as jax_align
from vg_tpu.ops.pallas_align import banded_scores_pallas
from vg_tpu.ops.pallas_align import pack_text as jax_pack_text
from vg_tpu_torch.ops import align as t_align
from vg_tpu_torch.ops import cuda_align, dp_cases

from test_torch_kernel import dp_batch, torch_args

# The suite runs in several worker processes at once: torch's intra-op
# threads (spinning OpenMP) would oversubscribe the cores many times over.
torch.set_num_threads(1)


def jax_scores(args, B):
    return np.asarray(jax_align.banded_scores(
        *(jnp.asarray(a) for a in args), band_radius=B))


@pytest.mark.parametrize("B", [12, 16])
def test_plain_dp_equals_jax(B):
    args = dp_batch(1, B)
    want = jax_scores(args, B)
    got = t_align.banded_scores(*torch_args(args), band_radius=B).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (want[~args[-1]] == -1).all() and (want[args[-1]] >= 0).all()


@pytest.mark.parametrize("B", [12, 16])
def test_packed_plain_version_equals_jax(B):
    args = dp_batch(2, B)
    text = args[0]
    want = jax_scores(args, B)
    packed = torch.from_numpy(cuda_align.pack_text(text))
    got = cuda_align.banded_scores_packed_ref(
        packed, len(text), *torch_args(args[1:]), band_radius=B).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    """A CPU tensor takes the plain version and launches nothing."""
    B = 16
    args = dp_batch(3, B)
    packed = torch.from_numpy(cuda_align.pack_text(args[0]))
    before = cuda_align.banded_scores_packed.launches
    got = cuda_align.banded_scores_packed(
        packed, len(args[0]), *torch_args(args[1:]), band_radius=B)
    assert cuda_align.banded_scores_packed.launches == before
    np.testing.assert_array_equal(got.numpy(), jax_scores(args, B))


def test_dp_on_windows_equals_pallas_interpret():
    """banded_dp over gathered windows equals the TPU kernel's body run
    in interpret mode (its shapes: N % 128 == 0, windows of RL + 2B)."""
    B = 12
    text, reads, reads_rc, rlen, start, lo, hi, rev, valid = dp_batch(4, B)
    R, C = start.shape
    RL = reads.shape[1]
    TW = RL + 2 * B
    pos = start.reshape(-1).astype(np.int64)[:, None] + np.arange(TW)
    lo_, hi_ = lo.reshape(-1)[:, None], hi.reshape(-1)[:, None]
    ok = (pos >= lo_) & (pos < hi_) & (pos >= 0) & (pos < len(text))
    win = np.where(ok, text[np.clip(pos, 0, len(text) - 1)],
                   jax_align.SENTINEL).astype(np.uint8)
    rd = np.where(rev.reshape(-1)[:, None], np.repeat(reads_rc, C, 0),
                  np.repeat(reads, C, 0))
    rl = np.repeat(rlen, C).astype(np.int32)
    assert len(rl) % 128 == 0
    want = np.asarray(banded_scores_pallas(
        jnp.asarray(win), jnp.asarray(rd), jnp.asarray(rl), band_radius=B,
        interpret=True))
    got = t_align.banded_dp(
        torch.from_numpy(win), torch.from_numpy(rd), torch.from_numpy(rl),
        band_radius=B, match=1, mismatch=4, gap_open=6, gap_extend=1,
        bonus=5).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T", [1, 8, 13, 300011])
def test_pack_text_byte_equal(T):
    text = np.random.default_rng(T).integers(0, 6, T).astype(np.uint8)
    want = jax_pack_text(text)
    got = cuda_align.pack_text(text)
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()


def pallas_1c(args, B):
    """What banded_scores_via_pallas (which has no interpret mode) computes:
    the lane windows and oriented reads it gathers, pushed through
    banded_scores_pallas in interpret mode, -1 on invalid slots."""
    text, reads, reads_rc, rlen, start, lo, hi, rev, valid = args
    R, C = start.shape
    RL = reads.shape[1]
    TW = RL + 2 * B
    N = R * C
    NP = -(-N // 128) * 128
    pos = start.reshape(-1).astype(np.int64)[:, None] + np.arange(TW)
    ok = ((pos >= lo.reshape(-1)[:, None]) & (pos < hi.reshape(-1)[:, None])
          & (pos >= 0) & (pos < len(text)))
    win = np.full((NP, TW), 6, np.uint8)
    win[:N] = np.where(ok, text[np.clip(pos, 0, len(text) - 1)], 6)
    rd = np.full((NP, RL), 5, np.uint8)
    rd[:N] = np.where(rev.reshape(-1)[:, None], np.repeat(reads_rc, C, 0),
                      np.repeat(reads, C, 0))
    rl = np.zeros(NP, np.int32)
    rl[:N] = np.where(valid.reshape(-1), np.repeat(rlen, C), 0)
    res = np.asarray(banded_scores_pallas(
        jnp.asarray(win), jnp.asarray(rd), jnp.asarray(rl), band_radius=B,
        interpret=True))[:N].reshape(R, C)
    return np.where(valid, res, -1)


@pytest.mark.parametrize("B", [8, 16])
def test_bytes_entry_equals_jax(B):
    """Kernel 1c's plain version (the CPU path of banded_scores_bytes)
    against its contract, the XLA scan, and against what 1c computes: its
    gathered windows through the Pallas kernel in interpret mode."""
    args = dp_batch(30 + B, B)
    before = cuda_align.banded_scores_bytes.launches
    got = cuda_align.banded_scores_bytes(*torch_args(args),
                                         band_radius=B).numpy()
    assert cuda_align.banded_scores_bytes.launches == before
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_scores(args, B))
    np.testing.assert_array_equal(got, pallas_1c(args, B))


def windows_batch(seed, B, R=64, C=4, RL=61):
    """Pre-gathered windows, oriented reads and lengths of dp_batch's
    slots at RL % 8 != 0, with slots past RL (rlen up to RL + 12: inside
    and beyond the TPU kernel's pad rows) and empty slots (rlen 0)."""
    text, reads, reads_rc, rlen, start, lo, hi, rev, _ = dp_batch(
        seed, B, R=R, C=C, RL=RL)
    TW = RL + 2 * B
    pos = start.reshape(-1).astype(np.int64)[:, None] + np.arange(TW)
    ok = ((pos >= lo.reshape(-1)[:, None]) & (pos < hi.reshape(-1)[:, None])
          & (pos >= 0) & (pos < len(text)))
    win = np.where(ok, text[np.clip(pos, 0, len(text) - 1)],
                   6).astype(np.uint8)
    rd = np.where(rev.reshape(-1)[:, None], np.repeat(reads_rc, C, 0),
                  np.repeat(reads, C, 0)).astype(np.uint8)
    rl = np.repeat(rlen, C).astype(np.int32)
    rng = np.random.default_rng(seed)
    over = rng.random(len(rl)) < 0.2
    rl[over] = RL + rng.integers(1, 13, int(over.sum()))
    rl[rng.random(len(rl)) < 0.05] = 0
    return win, rd, rl


@pytest.mark.parametrize("B", [8, 12, 16])
def test_windows_entry_equals_pallas_interpret(B):
    """Kernel 1b's wrapper on the CPU against banded_scores_pallas in
    interpret mode, rlen > RL at RL % 8 != 0 included: both run
    min(rlen, RLP) rows, RLP = 64 here."""
    win, rd, rl = windows_batch(40 + B, B)
    assert (rl > rd.shape[1]).any() and (rl > 64).any()
    want = np.asarray(banded_scores_pallas(
        jnp.asarray(win), jnp.asarray(rd), jnp.asarray(rl), band_radius=B,
        interpret=True))
    before = cuda_align.banded_scores_windows.launches
    got = cuda_align.banded_scores_windows(
        *torch_args((win, rd, rl)), band_radius=B).numpy()
    assert cuda_align.banded_scores_windows.launches == before
    assert got.dtype == np.int32 and got.shape == (len(rl),)
    np.testing.assert_array_equal(got, want)
    assert (got[rl == 0] == 0).all()


def test_windows_past_rl_differ_from_unpadded_dp():
    """Why the windows entry pads: ops/align.banded_dp alone stops at RL
    rows, as the XLA scan does, and misses the rows the TPU kernel runs
    for rlen in (RL, RLP] (their end bonus, here)."""
    win, rd, rl = windows_batch(50, 12)
    t_win, t_rd, t_rl = torch_args((win, rd, rl))
    unpadded = t_align.banded_dp(t_win, t_rd, t_rl, band_radius=12, match=1,
                                 mismatch=4, gap_open=6, gap_extend=1,
                                 bonus=5)
    padded = cuda_align.banded_scores_windows(t_win, t_rd, t_rl,
                                              band_radius=12)
    inside = rl <= rd.shape[1]
    assert torch.equal(unpadded[inside], padded[inside])
    assert (unpadded != padded).any()


def test_windows_entry_takes_whole_lanes_only():
    win, rd, rl = windows_batch(51, 8)
    with pytest.raises(AssertionError, match="multiple of 128"):
        cuda_align.banded_scores_windows(*torch_args((win[:100], rd[:100],
                                                      rl[:100])),
                                         band_radius=8)


@pytest.mark.parametrize("B", [8, 16])
def test_block_cases_equal_jax(B):
    """dp_cases.block_case (blocks of slots all valid, none, one, every
    other one, a random half; reads of rlen 0 and 2-base indels): the
    packed and byte-text plain versions against the XLA scan and against
    1c's windows through the Pallas kernel in interpret mode; the windows
    entry's plain version against banded_scores_pallas on the same slots
    (invalid slots given rlen 0)."""
    args = dp_cases.block_case(np.random.default_rng(70 + B), R=80, C=8,
                               RL=64, B=B, T=6000, L=60)
    want = jax_scores(args, B)
    packed = torch.from_numpy(cuda_align.pack_text(args[0]))
    got = cuda_align.banded_scores_packed(
        packed, len(args[0]), *torch_args(args[1:]), band_radius=B).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        cuda_align.banded_scores_bytes(*torch_args(args),
                                       band_radius=B).numpy(), want)
    np.testing.assert_array_equal(got, pallas_1c(args, B))
    win, rd, rl = dp_cases.windows_of(args, B)
    want_w = np.asarray(banded_scores_pallas(
        jnp.asarray(win), jnp.asarray(rd), jnp.asarray(rl), band_radius=B,
        interpret=True))
    got_w = cuda_align.banded_scores_windows(
        *torch_args((win, rd, rl)), band_radius=B).numpy()
    np.testing.assert_array_equal(got_w, want_w)
    np.testing.assert_array_equal(got_w, np.maximum(want.reshape(-1), 0))
