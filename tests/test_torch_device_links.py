"""The long-read link engine (vg_tpu_torch/ops/device_links.py: the fill
and walk kernels of ops/cuda_links.py, csrc/link_engine.cu, and the pack
and runs passes around them) and the chain-DP twin (ops/device_chain.py)
against the port's own host code; the cases of ops/link_cases.py and
ops/pass_cases.py against the traps they are built for; and, on the card,
each kernel against its plain version, the wrappers' checks and launch
counts, and the link engine and DeviceLinkAligner against the same
function on the CPU.
Imports no JAX, so the `gpu` tests also run on a machine that has only the
card's stack:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_device_links.py

The parity with vg_tpu's engine is in tests/test_torch_longread.py. The DP
is integer arithmetic: every comparison is exact."""
import numpy as np
import pytest
import torch

from vg_tpu_torch.map import chain as t_chain
from vg_tpu_torch.native import native_global_align
from vg_tpu_torch.ops import cuda_align
from vg_tpu_torch.ops import cuda_links
from vg_tpu_torch.ops import device_chain
from vg_tpu_torch.ops import device_links
from vg_tpu_torch.ops import link_cases
from vg_tpu_torch.ops import pass_cases
from vg_tpu_torch.ops.align import DEFAULT_SCORING
from vg_tpu_torch.ops.link_cases import synthetic_links

# The suite runs in several worker processes at once: torch's intra-op
# threads (spinning OpenMP) would oversubscribe the cores many times over.
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The card, for the `gpu` tests; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the link engine's kernels")
    return torch.device("cuda")


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


# ------------------------------------------- cases, kernels, wrappers

CARD_CASES = [(name, RMAX) for name in ("synthetic",) + link_cases.CASES
              for RMAX in (256, 768)]


def case_inputs(name, RMAX, B=16):
    """(text, arrays, scoring, B) of a link case (with the case's own B),
    or of synthetic_links for "synthetic" (2,048 tasks, the
    certification's mix)."""
    if name == "synthetic":
        text, arrs = synthetic_links(11 + RMAX, N=2048, RMAX=RMAX, B=B)
        return text, arrs, link_cases.DEFAULT_SCORING, B
    c = link_cases.link_case(name, RMAX=RMAX, B=B)
    return c["text"], c["arrays"], c["scoring"], c["B"]


def fill_args(text, arrs, scoring, dev, RMAX, B=16):
    """link_fill's tensors on `dev` and its keywords."""
    a4, la, ta, ba, lb = arrs
    put = lambda x: torch.as_tensor(x, device=dev)
    match, mismatch, gap_open, gap_extend = scoring
    return ((put(a4.view(np.int32)), put(la), put(ta), put(ba), put(lb),
             put(cuda_align.pack_text(text))),
            dict(RMAX=RMAX, WB=4 * B + 1, T=len(text), match=match,
                 mismatch=mismatch, gap_open=gap_open,
                 gap_extend=gap_extend))


def op_codes(packed):
    """(N, STEPS) op codes of the walk's packed words."""
    w = packed.numpy().view(np.uint32)
    return ((w[:, :, None] >> (np.arange(8, dtype=np.uint32) * 4)) & 15
            ).reshape(len(w), -1)


@pytest.mark.parametrize("name", link_cases.CASES)
def test_link_case_reaches_its_trap(name):
    """Each case holds the inputs it is named for, and its walks go where
    the case says (the plain engine on the CPU)."""
    RMAX = 256
    text, arrs, scoring, B = case_inputs(name, RMAX)
    a4, la, ta, ba, lb = arrs
    T = len(text)
    args, kw = fill_args(text, arrs, scoring, "cpu", RMAX, B)
    score, packed, n_steps, complete = device_links.link_engine(*args, **kw)
    ops = op_codes(packed)
    consumed = (ops <= 2).sum(axis=1)     # M, X and I each take a row
    assert len(la) % 32, "a case's task count is ragged"
    if name == "row_below_zero":
        below = consumed > np.maximum(la, 0)
        assert below[0] and below.sum() >= 12
        # on row -1 the previous task's (for task 0 the last task's) bits
        # decide: some of those walks take D moves there
        assert (ops[0] == 3).any() and (ops[below] == 3).any(axis=1).sum() > 3
    elif name == "text_start":
        assert (ta == 0).any() and (ta.astype(np.int64) + ba - 1 < 0).all()
    elif name == "text_end":
        end = ta.astype(np.int64) + lb
        assert (end == T).any() and (end > T).any() and (ta == T).any()
    elif name == "d_2b":
        assert (np.abs(lb.astype(np.int64) - la) == 2 * B).all()
        assert (la == 1).any() and (la == RMAX).any()
    elif name == "la_rmax":
        assert (la == RMAX).all() and complete.numpy().any()
    elif name in ("extend_ties", "open_equals_extend"):
        assert (scoring[2] == scoring[3]) == (name == "open_equals_extend")
        assert complete.numpy().all()
        # gaps in repeats: both kinds in most walks
        assert ((ops == 2).any(axis=1) & (ops == 3).any(axis=1)).mean() > 0.5
    elif name == "odd_coordinates":
        assert (la < 0).any() and (la == 0).any() and (la > RMAX).any()
        assert (lb <= 0).any() and (ta < 0).any() and (ta > T).any()
        assert (score.numpy()[la > RMAX] == cuda_links.NEG).all()
    elif name == "ragged_n":
        assert len(la) == 45
        pad = la == 0
        assert pad.any() and (n_steps.numpy()[pad] == 1).all()
    elif name == "tile_edges":
        R = cuda_links.WALK_TILE_ROWS
        assert {R - 1, R, R + 1, 2 * R - 1, 2 * R, 2 * R + 1, RMAX - 1,
                RMAX} <= set(la.tolist())
        cpl = link_cases.lane_columns(B)
        cf = set((lb.astype(np.int64) - la - ba).tolist())
        assert {2 * cpl - 1, 2 * cpl, 3 * cpl - 1, 3 * cpl} <= cf
        assert complete.numpy().mean() > 0.9
    elif name == "ragged_warp":
        mid = RMAX // 2 + 3
        quads = la[32:].reshape(-1, 4)
        assert all(sorted(q) == [0, 1, mid, RMAX] for q in quads)
        # the first block, ordered by rows, puts all four in one warp
        first = np.sort(la[: cuda_links.WALK_BLOCK_TASKS])
        assert list(first[:4]) == [0, 1, mid, RMAX]
        assert (n_steps.numpy()[la == 0] == 1).all()
    elif name == "ins_tile_edge":
        # I runs in the walks that go on across row la - R or la - 2R
        R = cuda_links.WALK_TILE_ROWS
        crossed = 0
        for k in range(len(la)):
            row = la[k] - np.concatenate([[0], np.cumsum(ops[k] <= 2)[:-1]])
            ins = ops[k] == 2
            for edge in (R, 2 * R):
                s = np.nonzero(ins[1:] & ins[:-1]
                               & (row[:-1] == la[k] - edge + 1))[0]
                crossed += len(s) > 0
        assert crossed >= 20, crossed
    elif name == "row_below_zero_tile":
        R = cuda_links.WALK_TILE_ROWS
        below = consumed > np.maximum(la, 0)
        for edge in (R - 1, R, R + 1, 2 * R):
            assert (below & (la == edge)).sum() >= 3, edge
    else:                                 # narrow_band, wide_band
        assert B == link_cases.CASE_B[name]
        assert (np.abs(lb.astype(np.int64) - la)[la > 0] <= 2 * B).all()
        assert (np.abs(lb.astype(np.int64) - la) == 2 * B).any()
        assert complete.numpy()[la > 0].mean() > 0.5


def test_wrappers_on_cpu_run_the_plain_versions():
    """CPU tensors go through link_fill_ref / link_walk_ref and count no
    launch."""
    text, arrs, scoring, _ = case_inputs("ragged_n", 256)
    args, kw = fill_args(text, arrs, scoring, "cpu", 256)
    n0 = (cuda_links.link_fill.launches, cuda_links.link_walk.launches)
    score, bits = cuda_links.link_fill(*args, **kw)
    want = cuda_links.link_fill_ref(*args, **kw)
    assert torch.equal(score, want[0]) and torch.equal(bits, want[1])
    la, ba, lb = args[1], args[3], args[4]
    got = cuda_links.link_walk(bits, la, ba, lb)
    for g, w in zip(got, cuda_links.link_walk_ref(bits, la, ba, lb)):
        assert torch.equal(g, w)
    assert (cuda_links.link_fill.launches,
            cuda_links.link_walk.launches) == n0


@pytest.mark.gpu
@pytest.mark.parametrize("name,RMAX", CARD_CASES)
def test_fill_kernel_equals_plain(cuda_device, name, RMAX):
    """link_fill on the card against link_fill_ref: scores and every
    decision byte of rows 0..RMAX."""
    text, arrs, scoring, B = case_inputs(name, RMAX)
    args, kw = fill_args(text, arrs, scoring, "cpu", RMAX, B)
    want = cuda_links.link_fill_ref(*args, **kw)
    got = cuda_links.link_fill(*(a.to(cuda_device) for a in args), **kw)
    torch.cuda.synchronize()
    for what, g, w in zip(("score", "bits"), got, want):
        assert torch.equal(g.cpu(), w), (what, int((g.cpu() != w).sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("name,RMAX", CARD_CASES)
def test_walk_kernel_equals_plain(cuda_device, name, RMAX):
    """link_walk on the card against link_walk_ref on the same bits."""
    text, arrs, scoring, B = case_inputs(name, RMAX)
    args, kw = fill_args(text, arrs, scoring, "cpu", RMAX, B)
    _, bits = cuda_links.link_fill_ref(*args, **kw)
    la, ba, lb = args[1], args[3], args[4]
    want = cuda_links.link_walk_ref(bits, la, ba, lb)
    got = cuda_links.link_walk(*(a.to(cuda_device)
                                 for a in (bits, la, ba, lb)))
    torch.cuda.synchronize()
    for what, g, w in zip(("packed", "n_steps", "complete"), got, want):
        assert torch.equal(g.cpu(), w), (what, int((g.cpu() != w).sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("name,RMAX", [("wide_band", 1024),
                                       ("narrow_band", 8)])
def test_kernels_at_the_wrappers_limits(cuda_device, name, RMAX):
    """Both kernels against their plain versions at the largest shapes
    the wrappers take (RMAX 1024 with WB = 93: shared memory past 48 KB a
    block) and the smallest (RMAX 8)."""
    text, arrs, scoring, B = case_inputs(name, RMAX)
    args, kw = fill_args(text, arrs, scoring, "cpu", RMAX, B)
    want = cuda_links.link_fill_ref(*args, **kw)
    got = cuda_links.link_fill(*(a.to(cuda_device) for a in args), **kw)
    la, ba, lb = args[1], args[3], args[4]
    want_w = cuda_links.link_walk_ref(want[1], la, ba, lb)
    got_w = cuda_links.link_walk(*(a.to(cuda_device)
                                   for a in (want[1], la, ba, lb)))
    torch.cuda.synchronize()
    for what, g, w in zip(("score", "bits", "packed", "n_steps",
                           "complete"), got + got_w, want + want_w):
        assert torch.equal(g.cpu(), w), (what, int((g.cpu() != w).sum()))


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    """Wrong dtype, shape, layout, device or parameter: ValueError before
    any launch."""
    text, arrs, scoring, _ = case_inputs("ragged_n", 256)
    args, kw = fill_args(text, arrs, scoring, cuda_device, 256)
    a4, la, ta, ba, lb, tp = args
    n0 = (cuda_links.link_fill.launches, cuda_links.link_walk.launches)
    bad_fill = [
        ((a4.to(torch.int64), la, ta, ba, lb, tp), {}),
        ((a4[:, :-1], la, ta, ba, lb, tp), {}),
        ((a4, la[:-1], ta, ba, lb, tp), {}),
        ((a4, la.cpu(), ta, ba, lb, tp), {}),
        ((a4, la, ta.to(torch.int16), ba, lb, tp), {}),
        ((a4, la, ta, ba, lb, tp.to(torch.int64)), {}),
        ((a4, la, ta, ba, lb, tp[:0]), {}),
        ((a4.t().contiguous().t(), la, ta, ba, lb, tp), {}),
        (args, {"WB": cuda_links.MAX_WB + 1}),
        (args, {"RMAX": 260}),
        (args, {"gap_open": -1}),
        (args, {"mismatch": cuda_links.SCORE_LIMIT}),
    ]
    for a, extra in bad_fill:
        with pytest.raises(ValueError):
            cuda_links.link_fill(*a, **dict(kw, **extra))
    _, bits = cuda_links.link_fill(*args, **kw)
    bad_walk = [
        (bits.to(torch.int32), la, ba, lb),
        (bits[:, :, :-1].contiguous()[:, :, :0], la, ba, lb),
        (bits.reshape(len(la), -1), la, ba, lb),
        (bits, la[:-1], ba, lb),
        (bits, la, ba.cpu(), lb),
        (bits, la, ba, lb.to(torch.int64)),
        (bits.transpose(1, 2).contiguous().transpose(1, 2), la, ba, lb),
    ]
    for a in bad_walk:
        with pytest.raises(ValueError):
            cuda_links.link_walk(*a)
    assert (cuda_links.link_fill.launches,
            cuda_links.link_walk.launches) == (n0[0] + 1, n0[1])


@pytest.mark.gpu
def test_link_engine_launches_each_kernel_once(cuda_device):
    """One link_engine call on the card is one launch of each kernel; a
    CPU call launches nothing."""
    text, arrs = synthetic_links(4, N=300)
    n0 = (cuda_links.link_fill.launches, cuda_links.link_walk.launches)
    got = run_engine(arrs, text, cuda_device)
    n1 = (cuda_links.link_fill.launches, cuda_links.link_walk.launches)
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (1, 1)
    want = run_engine(arrs, text, "cpu")
    assert (cuda_links.link_fill.launches,
            cuda_links.link_walk.launches) == n1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# --------------------------------------------- the pack and runs passes

def pack_inputs(name, dev, RMAX=768):
    """(blob, read_off, tasks, N) for link_pack at RMAX: a pass_cases
    batch's tasks up to la RMAX, or big_tasks for "big"."""
    if name == "big":
        blob, read_off, tasks = pass_cases.big_tasks()
    else:
        b = pass_cases.read_batch(name)
        sel = np.nonzero(b["la"] <= RMAX)[0]
        blob, read_off = b["blob"], b["read_off"]
        tasks = np.stack([b["task_read"], b["task_rev"], b["ra"], b["la"]],
                         axis=1)[sel].astype(np.int32)
    N = max(1024, 1 << int(np.ceil(np.log2(max(len(tasks), 1)))))
    put = lambda x: torch.as_tensor(x, device=dev)
    return put(blob), put(read_off), put(tasks), N


def runs_inputs(name, dev):
    packed, n_steps, cert = pass_cases.step_case(name)
    return tuple(torch.as_tensor(x, device=dev)
                 for x in (packed, n_steps, cert))


def test_pack_ref_gives_the_oriented_slices():
    """link_pack_ref's words hold each task's oriented slice (the read's
    bases, or its reverse complement's, from ra on) up to la and 0 after
    it, and padding tasks are 0: held against dna.revcomp_codes task by
    task."""
    from vg_tpu_torch.utils import dna

    b = pass_cases.read_batch("mixed")
    RMAX = 768
    blob, read_off, tasks, N = pack_inputs("mixed", "cpu", RMAX)
    a4 = cuda_links.link_pack_ref(blob, read_off, tasks, N=N, RMAX=RMAX)
    words = a4.numpy().view(np.uint32)
    for k, (r, rev, ra, la) in enumerate(tasks.numpy()):
        read = b["reads"][r]
        s = (dna.revcomp_codes(read) if rev else read)[ra : ra + la]
        got = unpack_a(words, k, RMAX)
        np.testing.assert_array_equal(got[:la], s)
        assert not got[la:].any()
    assert not words[len(tasks):].any()


def test_runs_ref_expands_to_the_steps():
    """link_runs_ref's runs, expanded, are each certified task's ops in
    forward order, and neighbouring runs of a task differ."""
    packed, n_steps, cert = runs_inputs("random", "cpu")
    runs, counts = cuda_links.link_runs_ref(packed, n_steps, cert)
    ops = op_codes(packed)
    r = runs.numpy()
    off = np.concatenate([[0], np.cumsum(counts.numpy())])
    for t in range(len(n_steps)):
        seg = r[off[t] : off[t + 1]]
        if not cert[t]:
            assert len(seg) == 0
            continue
        ns = int(n_steps[t])
        np.testing.assert_array_equal(np.repeat(seg[:, 0], seg[:, 1]),
                                      ops[t, :ns][::-1])
        assert (seg[1:, 0] != seg[:-1, 0]).all() and not seg[:, 2].any()


def test_pass_wrappers_on_cpu_run_the_plain_versions():
    """CPU tensors go through link_pack_ref / link_runs_ref and count no
    launch."""
    n0 = (cuda_links.link_pack.launches, cuda_links.link_runs.launches)
    blob, read_off, tasks, N = pack_inputs("mixed", "cpu", 256)
    RMAX = 256
    assert torch.equal(
        cuda_links.link_pack(blob, read_off, tasks, N=N, RMAX=RMAX),
        cuda_links.link_pack_ref(blob, read_off, tasks, N=N, RMAX=RMAX))
    args = runs_inputs("random", "cpu")
    for g, w in zip(cuda_links.link_runs(*args),
                    cuda_links.link_runs_ref(*args)):
        assert torch.equal(g, w)
    assert (cuda_links.link_pack.launches,
            cuda_links.link_runs.launches) == n0


@pytest.mark.gpu
@pytest.mark.parametrize("name,RMAX", [
    ("mixed", 256), ("mixed", 768), ("no_certified_bucket", 768),
    ("empty", 768), ("big", 768)])
def test_pack_kernel_equals_plain(cuda_device, name, RMAX):
    """link_pack on the card against link_pack_ref on the same inputs:
    every word, at bucket 256 and 768 and at 43,008 bucket-768 tasks."""
    blob, read_off, tasks, N = pack_inputs(name, cuda_device, RMAX)
    n0 = cuda_links.link_pack.launches
    got = cuda_links.link_pack(blob, read_off, tasks, N=N, RMAX=RMAX)
    want = cuda_links.link_pack_ref(blob, read_off, tasks, N=N, RMAX=RMAX)
    torch.cuda.synchronize()
    assert cuda_links.link_pack.launches == n0 + 1
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("name", pass_cases.STEP_CASES)
def test_runs_kernel_equals_plain(cuda_device, name):
    """link_runs on the card against link_runs_ref on the same step codes:
    every run and count, at 1,100 bucket-256 tasks and at 43,008
    bucket-768 tasks; the count pass launches, and the write pass where
    there is a run to write."""
    args = runs_inputs(name, cuda_device)
    n0 = cuda_links.link_runs.launches
    got = cuda_links.link_runs(*args)
    want = cuda_links.link_runs_ref(*args)
    torch.cuda.synchronize()
    assert cuda_links.link_runs.launches == n0 + 1 + (len(want[0]) > 0)
    for what, g, w in zip(("runs", "counts"), got, want):
        assert g.shape == w.shape and torch.equal(g, w), what


@pytest.mark.gpu
def test_pass_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    """Wrong dtype, shape, layout or device: ValueError before any
    launch."""
    RMAX = 768
    blob, read_off, tasks, N = pack_inputs("mixed", cuda_device, RMAX)
    n0 = (cuda_links.link_pack.launches, cuda_links.link_runs.launches)
    bad_pack = [
        ((blob.to(torch.int32), read_off, tasks), {}),
        ((blob, read_off.to(torch.int32), tasks), {}),
        ((blob, read_off[:0], tasks), {}),
        ((blob, read_off, tasks.to(torch.int64)), {}),
        ((blob, read_off, tasks[:, :3].contiguous()), {}),
        ((blob, read_off, tasks.t().contiguous().t()), {}),
        ((blob, read_off.cpu(), tasks), {}),
        ((blob, read_off, tasks), {"RMAX": 260}),
        ((blob, read_off, tasks), {"N": len(tasks) - 1}),
    ]
    for a, extra in bad_pack:
        with pytest.raises(ValueError):
            cuda_links.link_pack(*a, **dict(dict(N=N, RMAX=RMAX), **extra))
    packed, n_steps, cert = runs_inputs("random", cuda_device)
    bad_runs = [
        (packed.to(torch.int64), n_steps, cert),
        (packed[:, :0], n_steps, cert),
        (packed.reshape(-1), n_steps, cert),
        (packed, n_steps[:-1], cert),
        (packed, n_steps.to(torch.int64), cert),
        (packed, n_steps, cert.to(torch.uint8)),
        (packed, n_steps, cert.cpu()),
        (packed.t().contiguous().t(), n_steps, cert),
    ]
    for a in bad_runs:
        with pytest.raises(ValueError):
            cuda_links.link_runs(*a)
    assert (cuda_links.link_pack.launches,
            cuda_links.link_runs.launches) == n0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mixed", "no_certified_bucket",
                                  "all_fall_back"])
def test_aligner_on_card_equals_cpu(cuda_device, name):
    """DeviceLinkAligner.align_runs_blob on the card against the same call
    on the CPU: one link_pack, link_fill and link_walk a bucket with tasks,
    link_runs' count and write passes a bucket with a certified task
    (neither for a bucket that certifies nothing)."""
    b = pass_cases.read_batch(name)
    tp = cuda_align.pack_text(b["text"])
    out = {}
    counts = {}
    for dev in ("cpu", cuda_device):
        dla = device_links.DeviceLinkAligner(
            torch.as_tensor(tp, device=dev), len(b["text"]), DEFAULT_SCORING)
        dla.stats = {}
        n0 = {k: getattr(cuda_links, k).launches for k in
              ("link_pack", "link_fill", "link_walk", "link_runs")}
        res = dla.align_runs_blob(
            torch.as_tensor(b["blob"], device=dev), b["read_off"],
            b["task_read"], b["task_rev"], b["ra"], b["la"], b["ta"],
            b["lb"])
        out[str(dev)] = res[:3] + (device_links.splice_runs(
            res[2], res[3])[1],)
        counts[str(dev)] = {k: getattr(cuda_links, k).launches - v
                            for k, v in n0.items()}
        buckets = dla.stats.get("buckets", {})
    for g, w in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(g, w)
    assert set(counts["cpu"].values()) == {0}
    with_tasks = len(buckets)
    certified = sum(1 for v in buckets.values() if v["certified"])
    assert counts["cuda"] == dict(link_pack=with_tasks, link_fill=with_tasks,
                                  link_walk=with_tasks, link_runs=2 * certified)
    assert {"mixed": (2, 2), "no_certified_bucket": (2, 1),
            "all_fall_back": (0, 0)}[name] == (with_tasks, certified)
