"""The long-read link engine (vg_tpu_torch/ops/device_links.py, torch ops)
and the chain-DP twin (ops/device_chain.py) against the port's own host
code, and the link engine on the card against the same function on the
CPU. Imports no JAX, so the `gpu` test also runs on a machine that has
only the card's stack:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_device_links.py

The parity with vg_tpu's engine is in tests/test_torch_longread.py. The DP
is integer arithmetic: every comparison is exact."""
import numpy as np
import pytest
import torch

from vg_tpu_torch.map import chain as t_chain
from vg_tpu_torch.native import native_global_align
from vg_tpu_torch.ops import cuda_align
from vg_tpu_torch.ops import device_chain
from vg_tpu_torch.ops import device_links
from vg_tpu_torch.ops.align import DEFAULT_SCORING

# The suite runs in several worker processes at once: torch's intra-op
# threads (spinning OpenMP) would oversubscribe the cores many times over.
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The card, for the `gpu` tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the link engine's card run")
    return torch.device("cuda")


def synthetic_links(seed, N=1024, RMAX=256, B=16, T=20000):
    """Link problems the certification must sort out: clean and mutated
    slices, indels that leave the band, junk reads, |d| = 2B, la = RMAX,
    and padding (la = 0)."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, T).astype(np.uint8)
    a4 = np.zeros((N, RMAX // 8), np.uint32)
    la = np.zeros(N, np.int32)
    ta = np.zeros(N, np.int32)
    ba = np.zeros(N, np.int32)
    lb = np.ones(N, np.int32)
    nib = np.arange(8, dtype=np.uint32) * 4
    for k in range(N - 64):
        n_a = RMAX if k % 50 == 0 else int(rng.integers(1, RMAX + 1))
        d = 2 * B * (1 if k % 2 else -1) if k % 17 == 0 else \
            int(rng.integers(-2 * B, 2 * B + 1))
        n_b = max(1, n_a + d)
        s = int(rng.integers(0, T - n_b))
        b = text[s : s + n_b]
        kind = k % 4
        if kind == 3:
            a = rng.integers(0, 5, n_a).astype(np.uint8)     # junk, N bases
        else:
            src = text[s : s + max(n_a, n_b) + 64].copy()
            if kind == 2 and len(src) > 40:                  # a long indel
                q = int(rng.integers(5, len(src) - 30))
                src = np.concatenate([src[:q], src[q + 25 :]])
            a = src[:n_a].copy()
            if len(a) < n_a:
                a = np.concatenate([a, rng.integers(0, 4, n_a - len(a))
                                    .astype(np.uint8)])
            mut = rng.random(n_a) < 0.03
            a[mut] = (a[mut] + 1) % 4
        ap = np.zeros(RMAX, np.uint8)
        ap[:n_a] = a
        a4[k] = (ap.reshape(-1, 8).astype(np.uint32) << nib).sum(
            axis=1, dtype=np.uint32)
        la[k], ta[k], lb[k] = n_a, s, n_b
        ba[k] = min(0, n_b - n_a) - B
    return text, (a4, la, ta, ba, lb)


def run_engine(arrs, text, dev, RMAX=256, B=16):
    a4, la, ta, ba, lb = arrs
    sc = DEFAULT_SCORING
    put = lambda x: torch.as_tensor(x, device=dev)
    out = device_links.link_engine(
        put(a4.view(np.int32)), put(la), put(ta), put(ba), put(lb),
        put(cuda_align.pack_text(text)), RMAX=RMAX, WB=4 * B + 1,
        T=len(text), match=sc.match, mismatch=sc.mismatch,
        gap_open=sc.gap_open, gap_extend=sc.gap_extend)
    return [x.cpu() for x in out]


def unpack_a(a4, k, n):
    """The first n read codes of task k from its packed words."""
    w = a4[k].astype(np.uint64)
    return ((w[:, None] >> (np.arange(8, dtype=np.uint64) * 4)) & 15
            ).reshape(-1)[:n].astype(np.uint8)


def test_certified_links_equal_native_global_align():
    """Every task the engine certifies (complete, score above the escape
    bound) has native global_align's score, and its walk replays
    global_align's edit sequence op for op."""
    text, arrs = synthetic_links(3, N=1024)
    score, packed, n_steps, complete = run_engine(arrs, text, "cpu")
    a4, la, ta, _, lb = arrs
    ub = (np.minimum(la, lb) - 2 * DEFAULT_SCORING.gap_open
          - (np.abs(lb.astype(np.int64) - la) + 32))
    cert = complete.numpy() & (score.numpy() >= ub)
    ops = ((packed.numpy().view(np.uint32)[:, :, None]
            >> (np.arange(8, dtype=np.uint32) * 4)) & 15).reshape(
        len(la), -1)
    checked = 0
    for k in np.nonzero(cert[: len(la) - 64])[0][:200]:
        a = unpack_a(a4, k, int(la[k]))
        b = text[int(ta[k]) : int(ta[k]) + int(lb[k])]
        want_score, edits = native_global_align(a, b, DEFAULT_SCORING)
        assert int(score[k]) == want_score, k
        walk = ops[k, : int(n_steps[k])][::-1]
        runs = [(int(o), int((walk[:i + 1][::-1] == o).cumprod().sum()))
                for i, o in enumerate(walk)
                if i + 1 == len(walk) or walk[i + 1] != o]
        want = [("MXID".index(e[0]), e[1]) for e in edits]
        assert runs == want, k
        checked += 1
    assert checked >= 100


def test_padding_tasks_halt_at_once():
    """Padding tasks (la = 0, lb = 1) take one deletion and stop."""
    text, arrs = synthetic_links(5, N=1024)
    score, _, n_steps, complete = run_engine(arrs, text, "cpu")
    pad = arrs[1] == 0
    assert pad.sum() == 64
    assert (score.numpy()[pad] == -DEFAULT_SCORING.gap_open).all()
    assert (n_steps.numpy()[pad] == 1).all() and complete.numpy()[pad].all()


def test_device_chain_equals_host_chain_dp():
    """The chain-DP twin equals map/chain.chain_anchors exactly at exactly
    representable parameters (gap costs in powers of two)."""
    rng = np.random.default_rng(2)
    p = t_chain.ChainParams(gap_scale=0.125, gap_open=1.0,
                            lookback_cands=16, min_chain_score=10.0)
    for n in (1, 2, 90, 250):
        tpos = np.sort(rng.integers(0, 30000, n)).astype(np.int64)
        roff = rng.integers(0, 9500, n).astype(np.int64)
        o = np.lexsort((roff, tpos))
        roff, tpos = roff[o], tpos[o]
        score = rng.integers(1, 30, n).astype(np.float64)
        f_h, par_h = t_chain.chain_anchors(roff, tpos, score, p)
        f_d, par_d = device_chain.chain_anchors_device(roff, tpos, score, p,
                                                       device="cpu")
        np.testing.assert_array_equal(f_d, f_h)
        np.testing.assert_array_equal(par_d, par_h)


@pytest.mark.gpu
@pytest.mark.parametrize("RMAX", [256, 768])
def test_link_engine_on_card_equals_cpu(cuda_device, RMAX):
    """link_engine on the card against the same function on the CPU."""
    text, arrs = synthetic_links(11 + RMAX, N=2048, RMAX=RMAX)
    got = run_engine(arrs, text, cuda_device, RMAX=RMAX)
    want = run_engine(arrs, text, "cpu", RMAX=RMAX)
    for name, g, w in zip(("score", "ops", "n_steps", "complete"), got,
                          want):
        assert torch.equal(g, w), name
