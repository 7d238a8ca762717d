"""The banded-DP kernel (vg_tpu_torch/csrc/banded_dp.cu) against its
plain PyTorch versions through its three entries (packed text, byte text,
pre-gathered windows), and the wrappers' routing, checks and work count.
Imports no JAX, so the `gpu` tests also run on a machine that has only
the card's stack:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel.py

Here, without a card, the `gpu` tests skip and the plain-version tests
run. The DP is integer arithmetic: every comparison is exact."""
import numpy as np
import pytest
import torch

from vg_tpu_torch.ops import align as t_align
from vg_tpu_torch.ops import cuda_align

COMP = np.array([3, 2, 1, 0, 4, 5], np.uint8)
# The suite runs in several worker processes at once: torch's intra-op
# threads (spinning OpenMP) would oversubscribe the cores many times over.
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The card, for the `gpu` tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def dp_batch(seed, B, R=32, C=4, RL=64, T=6000):
    """Reads drawn from a random text (mutations, 2-base deletions, N
    bases, pad 5 past rlen) with C candidates each, and the rows the
    kernel must get right at the edges: reverse-strand reads and
    candidates, lo/hi cutting the window, rlen = 0, window starts below 0
    and windows running past the text end, invalid slots."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, T).astype(np.uint8)
    text[rng.random(T) < 0.005] = 4
    TW = RL + 2 * B
    reads = np.full((R, RL), 5, np.uint8)
    rlen = np.zeros(R, np.int32)
    start = np.zeros((R, C), np.int32)
    lo = np.zeros((R, C), np.int32)
    hi = np.full((R, C), T, np.int32)
    rev = np.zeros((R, C), bool)
    valid = np.ones((R, C), bool)
    for i in range(R):
        L = int(rng.integers(35, RL + 1))
        if i == 0:
            s = 3                       # window starts below 0
        elif i == 1:
            s = T - L                   # window runs past the text end
        else:
            s = int(rng.integers(0, T - L))
        r = text[s : s + L].copy()
        for _ in range(int(rng.integers(0, 5))):
            q = int(rng.integers(0, L))
            r[q] = (r[q] + 1 + rng.integers(0, 3)) % 4
        if rng.random() < 0.3:
            q = int(rng.integers(5, L - 5))
            r = np.concatenate([r[:q], r[q + 2 :], text[s + L : s + L + 2]]
                               )[:L]
        L = len(r)
        if rng.random() < 0.2:
            r[int(rng.integers(0, L))] = 4          # N in the read
        strand = rng.random() < 0.4
        reads[i, :L] = COMP[r][::-1] if strand else r
        rlen[i] = L
        start[i, 0] = s - B
        rev[i, 0] = strand
        for c in range(1, C):
            start[i, c] = int(rng.integers(-TW, T))
            rev[i, c] = rng.random() < 0.5
        if rng.random() < 0.3:                      # lo/hi cut the window
            lo[i, 0] = start[i, 0] + int(rng.integers(0, TW // 3))
            hi[i, 0] = start[i, 0] + TW - int(rng.integers(0, TW // 3))
        valid[i, rng.random(C) < 0.15] = False
    rlen[5] = 0
    reads_rc = np.full_like(reads, 5)
    for i in range(R):
        n = int(rlen[i])
        reads_rc[i, :n] = COMP[reads[i, :n]][::-1]
    return text, reads, reads_rc, rlen, start, lo, hi, rev, valid


def torch_args(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


@pytest.mark.parametrize("B", [8, 12, 16])
def test_plain_version_equals_byte_text_dp(B):
    """The packed-word gather of the plain version reads the same windows
    as the byte-text DP of ops/align."""
    args = dp_batch(10 + B, B)
    text = args[0]
    packed = torch.from_numpy(cuda_align.pack_text(text))
    want = t_align.banded_scores(*torch_args(args), band_radius=B)
    got = cuda_align.banded_scores_packed_ref(
        packed, len(text), *torch_args(args[1:]), band_radius=B)
    assert torch.equal(got, want)


def test_cpu_tensors_launch_nothing():
    args = dp_batch(20, 16)
    packed = torch.from_numpy(cuda_align.pack_text(args[0]))
    before = cuda_align.banded_scores_packed.launches
    got = cuda_align.banded_scores_packed(
        packed, len(args[0]), *torch_args(args[1:]), band_radius=16)
    assert cuda_align.banded_scores_packed.launches == before
    assert got.dtype == torch.int32 and got.shape == args[4].shape


def test_dp_work_counts_valid_rows():
    """bytes: every input once, the output once; operations: OPS_PER_CELL
    for each band cell of each valid candidate's rows."""
    reads = torch.zeros((2, 10), dtype=torch.uint8)
    rlen = torch.tensor([10, 4], dtype=torch.int32)
    valid = torch.tensor([[True, False, True], [True, True, False]])
    nbytes, ops = cuda_align.dp_work(reads, rlen, valid, 100, 8)
    assert ops == cuda_align.OPS_PER_CELL * 17 * (10 * 2 + 4 * 2)
    assert nbytes == 400 + 2 * 20 + 8 + 6 * 14 + 6 * 4


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8, 12, 16])
def test_kernel_equals_plain_version_on_card(cuda_device, B):
    """The CUDA kernel against its plain version on the same inputs."""
    args = dp_batch(5 + B, B, R=512, C=8, RL=160, T=200_000)
    dev = cuda_device
    packed = torch.from_numpy(cuda_align.pack_text(args[0])).to(dev)
    targs = [t.to(dev) for t in torch_args(args[1:])]
    before = cuda_align.banded_scores_packed.launches
    got = cuda_align.banded_scores_packed(packed, len(args[0]), *targs,
                                          band_radius=B)
    torch.cuda.synchronize()
    assert cuda_align.banded_scores_packed.launches == before + 1
    want = cuda_align.banded_scores_packed_ref(packed, len(args[0]), *targs,
                                               band_radius=B)
    assert torch.equal(got, want)


def windows_from(args, B, over_seed=None):
    """The (N, TW) windows, oriented reads and lengths of a dp_batch's
    slots (N = R * C); with over_seed, a fifth of the slots get rlen past
    RL (up to RL + 12) and some rlen 0."""
    text, reads, reads_rc, rlen, start, lo, hi, rev, _ = args
    C = start.shape[1]
    TW = reads.shape[1] + 2 * B
    pos = start.reshape(-1).astype(np.int64)[:, None] + np.arange(TW)
    ok = ((pos >= lo.reshape(-1)[:, None]) & (pos < hi.reshape(-1)[:, None])
          & (pos >= 0) & (pos < len(text)))
    win = np.where(ok, text[np.clip(pos, 0, len(text) - 1)],
                   6).astype(np.uint8)
    rd = np.where(rev.reshape(-1)[:, None], np.repeat(reads_rc, C, 0),
                  np.repeat(reads, C, 0)).astype(np.uint8)
    rl = np.repeat(rlen, C).astype(np.int32)
    if over_seed is not None:
        rng = np.random.default_rng(over_seed)
        over = rng.random(len(rl)) < 0.2
        rl[over] = reads.shape[1] + rng.integers(1, 13, int(over.sum()))
        rl[rng.random(len(rl)) < 0.05] = 0
    return win, rd, rl


def test_byte_and_window_entries_agree_with_packed_on_cpu():
    """On the same slots the three plain versions give the same scores
    (rlen <= RL; invalid slots: -1 from the text entries, and 0 from the
    windows entry, whose slots are then given rlen 0)."""
    B = 12
    args = dp_batch(21, B)
    text = args[0]
    packed = torch.from_numpy(cuda_align.pack_text(text))
    want = cuda_align.banded_scores_packed(packed, len(text),
                                           *torch_args(args[1:]),
                                           band_radius=B)
    got = cuda_align.banded_scores_bytes(*torch_args(args), band_radius=B)
    assert torch.equal(got, want)
    win, rd, rl = windows_from(args, B)
    valid = args[-1].reshape(-1)
    rl = np.where(valid, rl, 0).astype(np.int32)
    w = cuda_align.banded_scores_windows(*torch_args((win, rd, rl)),
                                         band_radius=B)
    assert torch.equal(w, want.reshape(-1).clamp_min(0))


def test_dp_work_of_each_source():
    """Byte text counts one byte a base; windows count every slot's
    min(rlen, RLP) rows, RLP = RL rounded up to 8, and their own bytes."""
    reads = torch.zeros((2, 10), dtype=torch.uint8)
    rlen = torch.tensor([10, 4], dtype=torch.int32)
    valid = torch.tensor([[True, False, True], [True, True, False]])
    nbytes, ops = cuda_align.dp_work(reads, rlen, valid, 100, 8,
                                     source="bytes")
    assert ops == cuda_align.OPS_PER_CELL * 17 * (10 * 2 + 4 * 2)
    assert nbytes == 100 + 2 * 20 + 8 + 6 * 14 + 6 * 4
    wreads = torch.zeros((128, 10), dtype=torch.uint8)
    wrlen = torch.zeros(128, dtype=torch.int32)
    wrlen[:3] = torch.tensor([10, 20, 4], dtype=torch.int32)
    nbytes, ops = cuda_align.dp_work(wreads, wrlen, None, 128 * 26, 8,
                                     source="windows")
    assert ops == cuda_align.OPS_PER_CELL * 17 * (10 + 16 + 4)
    assert nbytes == 128 * 26 + 128 * 10 + 4 * 128 + 4 * 128


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8, 12, 16])
def test_byte_entry_equals_plain_version_on_card(cuda_device, B):
    """banded_dp_bytes against ops/align.banded_scores on the card."""
    args = dp_batch(25 + B, B, R=512, C=8, RL=160, T=200_000)
    targs = [t.to(cuda_device) for t in torch_args(args)]
    before = cuda_align.banded_scores_bytes.launches
    got = cuda_align.banded_scores_bytes(*targs, band_radius=B)
    torch.cuda.synchronize()
    assert cuda_align.banded_scores_bytes.launches == before + 1
    want = t_align.banded_scores(*targs, band_radius=B)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [8, 12, 16])
def test_window_entry_equals_plain_version_on_card(cuda_device, B):
    """banded_dp_windows against its plain version on the card, with slots
    past RL at RL % 8 != 0 and empty slots."""
    args = dp_batch(35 + B, B, R=512, C=8, RL=157, T=200_000)
    arrs = windows_from(args, B, over_seed=B)
    win, rd, rl = [t.to(cuda_device) for t in torch_args(arrs)]
    before = cuda_align.banded_scores_windows.launches
    got = cuda_align.banded_scores_windows(win, rd, rl, band_radius=B)
    torch.cuda.synchronize()
    assert cuda_align.banded_scores_windows.launches == before + 1
    want = cuda_align.banded_scores_windows_ref(win, rd, rl, band_radius=B)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    args = dp_batch(6, 10)
    packed = torch.from_numpy(cuda_align.pack_text(args[0])).to(cuda_device)
    targs = [t.to(cuda_device) for t in torch_args(args[1:])]
    with pytest.raises(ValueError, match="band radii"):
        cuda_align.banded_scores_packed(packed, len(args[0]), *targs,
                                        band_radius=10)
    bad = list(targs)
    bad[3] = targs[3].to(torch.int64)               # cand_start
    with pytest.raises(ValueError, match="cand_start"):
        cuda_align.banded_scores_packed(packed, len(args[0]), *bad,
                                        band_radius=16)
