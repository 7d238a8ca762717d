"""A CPU model of the link engine's two kernels (vg_tpu_torch/csrc/
link_engine.cu), in numpy, held equal to their plain versions
(ops/cuda_links.link_fill_ref, link_walk_ref) on every ops/link_cases.py
case. The kernels run only on the card; this model repeats their design
step for step, so that the arithmetic of the design is tested where the
kernels cannot run:

- the fill: a block's tasks ordered by rows, four tasks a warp and the
  warp running its longest task's rows; a task on 8 lanes, lane g holding
  the CPL = ceil(WB / 8) consecutive columns g CPL ..; the previous row's
  H and F of the next lane's first column and the previous lane's last hn
  taken from the neighbouring lane; the lazy E as a serial max along a
  lane's columns, then a prefix max of the lane totals across the 8 lanes
  (3 steps) and the exclusive carry, from which the previous lane's last
  E and H follow; out-of-band and past-WB slots fed unmasked into all of
  it and masked after; the text codes slid along the window a row;
- the walk: a tile of the task's rows [ci - R + 1, ci] (R =
  cuda_links.WALK_TILE_ROWS) taken when the row leaves the tile, steps
  inside the task's rows read from the tile, the others through the
  wrapped and clamped flat index; a block's tasks ordered by rows, eight
  a warp, and a warp ending when its walks have halted and filling the
  rest with halted ops.

Imports no JAX."""
import functools

import numpy as np
import pytest
import torch

from vg_tpu_torch.ops import cuda_align
from vg_tpu_torch.ops import cuda_links
from vg_tpu_torch.ops import link_cases

torch.set_num_threads(1)

NEG = cuda_links.NEG
G = cuda_links.FILL_LANES
INT_MIN = -(1 << 31)


def w32(x):
    """int32 wrap (two's complement) of int64 values."""
    return (np.asarray(x, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)


def lane_up(x, d):
    """__shfl_up_sync(x, d, 8) along the lane axis (1): lane g takes lane
    g - d's value, lanes below d keep their own."""
    y = x.copy()
    y[:, d:] = x[:, :-d]
    return y


def warp_tasks(la, RMAX, block, per):
    """The kernels' warps: each block of `block` tasks ordered by rows
    (min(max(la, 0), RMAX)), ties by index, then `per` tasks a warp. A
    list of index arrays."""
    key = np.clip(la, 0, RMAX)
    warps = []
    for n0 in range(0, len(la), block):
        idx = np.arange(n0, min(n0 + block, len(la)))
        order = idx[np.lexsort((idx, key[idx]))]
        warps += [order[w : w + per] for w in range(0, len(order), per)]
    return warps


def fill_model(a4, la, ta, base, lb, text_packed, *, RMAX, WB, T, match,
               mismatch, gap_open, gap_extend):
    """link_fill as csrc/link_engine.cu computes it: (score (N,) int32,
    bits (N, RMAX + 1, WB) uint8)."""
    la, ta, base, lb = (np.asarray(x, np.int64) for x in (la, ta, base, lb))
    N = len(la)
    go, ge = gap_open, gap_extend
    CPL = -(-WB // G)
    KB = cuda_links.window_bytes(RMAX, WB)
    text = np.asarray(text_packed).view(np.uint32).astype(np.int64)
    # shared memory: the text window and the read codes
    p = w32(ta + base - 1)[:, None] + np.arange(KB)
    wi = np.where(p < 0, 0, np.minimum(p >> 3, len(text) - 1))
    win = np.where((p >= 0) & (p < T), (text[wi] >> ((p & 7) * 4)) & 15, 6)
    words = np.asarray(a4).view(np.uint32).astype(np.int64)
    col = np.arange(RMAX)
    acode = (words[:, col // 8] >> ((col % 8) * 4)) & 15
    c = np.arange(G)[:, None] * CPL + np.arange(CPL)[None, :]   # (G, CPL)
    c0 = c[:, 0]
    slot_ok = c < WB
    b3 = lambda x: x[:, None, None]

    j0 = w32(b3(base) + c)
    in0 = (j0 >= 0) & (j0 <= b3(lb))
    H = np.where(~slot_ok, NEG, np.where(j0 == 0, 0, np.where(
        in0 & (j0 > 0), w32(-w32(go + w32((j0 - 1) * ge))), NEG)))
    F = np.full_like(H, NEG)
    bits = np.zeros((N, RMAX + 1, WB), np.uint8)
    row0 = np.where(in0 & (j0 > 0), 2 | ((j0 >= 2) << 2), 0)
    bits[:, 0] = row0.reshape(N, -1)[:, :WB]
    tk = win[:, 1 + c]                                          # row 1

    rows = np.where(la < 0, 0, np.minimum(la, RMAX))
    wrows = np.zeros(N, np.int64)
    for w in warp_tasks(la, RMAX, cuda_links.FILL_BLOCK_TASKS,
                         cuda_links.FILL_WARP_TASKS):
        wrows[w] = rows[w].max()
    cf = np.clip(w32(lb - la - base), 0, WB - 1)
    score = np.full(N, NEG, np.int64)
    g_pos = (np.arange(G) > 0)[None, :]
    negcol = np.full((N, G, 1), NEG)
    for i in range(1, int(wrows.max(initial=0)) + 1):
        act = i <= wrows
        ai = acode[:, i - 1]
        aim = np.where(ai < 4, ai, -1)
        jb = w32(i + base)
        rowin = (i <= la) & (lb >= 0)
        colH = b3(np.where(i <= la, w32(-w32(go + (i - 1) * ge)), NEG))
        # row i - 1's H and F at the next lane's first column
        Hup = np.concatenate([H[:, :, 1:], np.concatenate(
            [H[:, 1:, :1], negcol[:, :1]], axis=1)], axis=2)
        Fup = np.concatenate([F[:, :, 1:], np.concatenate(
            [F[:, 1:, :1], negcol[:, :1]], axis=1)], axis=2)
        mb = tk == b3(aim)
        diag = w32(H + np.where(mb, match, -mismatch))
        fo, fx = w32(Hup - go), w32(Fup - ge)
        Fn = np.maximum(fo, fx)
        fext = fx > fo                  # Fn == fx and Fn != fo
        hn = np.maximum(diag, Fn)
        j = w32(b3(jb) + c)
        # the lazy E: serial along the lane, then across the 8 lanes
        hprev = np.where(g_pos, lane_up(hn[:, :, -1], 1), NEG)
        left = np.concatenate([hprev[:, :, None], hn[:, :, :-1]], axis=2)
        opensrc = np.where(j == 1, np.maximum(left, colH), left)
        gk = w32(np.maximum(opensrc, NEG) + w32(c * ge))
        pre = np.maximum.accumulate(gk, axis=2)
        incl = pre[:, :, -1]
        for d in (1, 2, 4):
            incl = np.maximum(incl, lane_up(incl, d))
        carry = lane_up(incl, 1)
        Eprev = np.where(g_pos, np.maximum(
            w32(w32(carry - go) - w32((c0 - 1) * ge)), NEG), NEG)
        Hprev = np.where(g_pos, np.maximum(hprev, Eprev), NEG)
        carry = np.where(g_pos, carry, INT_MIN)
        E = np.maximum(w32(w32(np.maximum(pre, carry[:, :, None]) - go)
                           - w32(c * ge)), NEG)
        Hn = np.maximum(hn, E)
        Ek1 = np.concatenate([Eprev[:, :, None], E[:, :, :-1]], axis=2)
        Hk1 = np.concatenate([Hprev[:, :, None], Hn[:, :, :-1]], axis=2)
        Hsh = np.where(j == 1, np.maximum(Hk1, colH), Hk1)
        eext = (E == w32(Ek1 - ge)) & (E != w32(Hsh - go))
        esel = Hn == E
        dok = Hn == diag
        inb = (slot_ok & b3(rowin)
               & ((j & 0xFFFFFFFF) <= (b3(lb) & 0xFFFFFFFF)))
        byte = np.where(inb, dok | (esel << 1) | (eext << 2) | (fext << 3)
                        | (mb << 4), 0)
        bits[act, i] = byte[act].reshape(int(act.sum()), -1)[:, :WB]
        H = np.where(b3(act), np.where(inb, Hn, NEG), H)
        F = np.where(b3(act), np.where(inb, Fn, NEG), F)
        hit = act & (la == i)
        score[hit] = H.reshape(N, -1)[hit, cf[hit]]
        # slide the text codes along the window
        tk = np.concatenate(
            [tk[:, :, 1:], win[:, i + 1 + c[:, -1]][:, :, None]], axis=2)
    score = np.where((la >= 1) & (la <= RMAX), score,
                     np.where(la != 0, NEG, np.where(
                         lb == 0, 0, w32(-w32(go + w32((lb - 1) * ge))))))
    return score.astype(np.int32), bits


def walk_model(bits, la, base, lb):
    """link_walk as csrc/link_engine.cu computes it: (packed (N, STEPS/8)
    int32, n_steps (N,) int32, complete (N,) bool), and the number of
    steps that read the bits through the flat index."""
    bits = np.asarray(bits)
    la, base, lb = (np.asarray(x, np.int64) for x in (la, base, lb))
    N, R1, WB = bits.shape
    RMAX = R1 - 1
    R = cuda_links.WALK_TILE_ROWS
    flat_bits = bits.reshape(-1)
    size = flat_bits.size
    SW = cuda_links.walk_steps(RMAX, WB) // 8
    lane_base = np.arange(N, dtype=np.int64) * R1 * WB
    ci = la.copy()
    cc = np.clip(w32(lb - la - base), 0, WB - 1)
    st = np.zeros(N, np.int64)
    done = (la == 0) & (lb == 0)
    steps = np.zeros(N, np.int64)
    lo = np.full(N, RMAX + 1)
    hi = np.full(N, -1)
    tile = np.zeros((N, R * WB), np.uint8)
    words = np.full((N, SW), 0x44444444, np.int64)
    running = np.ones(N, bool)              # the task's warp still loops
    warps = warp_tasks(la, RMAX, cuda_links.WALK_BLOCK_TASKS,
                       cuda_links.WALK_WARP_TASKS)
    flat_reads = 0
    for w in range(SW):
        word = np.zeros(N, np.int64)
        for q in range(8):
            j = w32(ci + base + cc)
            at_end = (ci == 0) & (j == 0)
            need = running & ~done & ~at_end & (ci >= 0) & (ci <= RMAX) & (
                ci < lo)
            for n in np.nonzero(need)[0]:
                hi[n], lo[n] = ci[n], max(ci[n] - R + 1, 0)
                s = lane_base[n] + lo[n] * WB
                tile[n, : (hi[n] - lo[n] + 1) * WB] = flat_bits[
                    s : s + (hi[n] - lo[n] + 1) * WB]
            col = np.clip(cc, 0, WB - 1)
            intile = (ci >= lo) & (ci <= hi)
            t_idx = np.where(intile, (ci - lo) * WB + col, 0)
            flat = lane_base + ci * WB + col
            flat = np.clip(np.where(flat < 0, flat + size, flat), 0, size - 1)
            cell = np.where(intile, tile[np.arange(N), t_idx],
                            flat_bits[flat]).astype(np.int64)
            step = running & ~done & ~at_end
            flat_reads += int((step & ~intile).sum())
            take_d = (st == 0) & (ci > 0) & (j > 0) & ((cell & 1) > 0)
            in_e = (st == 2) | ((st == 0) & ~take_d & (j > 0)
                                & ((cell & 2) > 0))
            op = np.where(take_d, np.where(cell & 16, 0, 1),
                          np.where(in_e, 3, 2))
            op = np.where(step, op, 4)
            nci = np.where(take_d | ~in_e, w32(ci - 1), ci)
            ncc = np.where(take_d, cc, np.where(in_e, w32(cc - 1),
                                                w32(cc + 1)))
            nst = np.where(take_d, 0, np.where(
                in_e, np.where(((cell & 4) > 0) & (j > 1), 2, 0),
                np.where(((cell & 8) > 0) & (ci > 1), 1, 0)))
            ci = np.where(step, nci, ci)
            cc = np.where(step, ncc, cc)
            st = np.where(step, nst, st)
            steps += step
            done = done | (running & at_end)
            word |= op << (4 * q)
        words[running, w] = word[running]
        for wt in warps:                   # a warp ends with its walks
            if running[wt[0]] and done[wt].all():
                running[wt] = False
    packed = w32(words).astype(np.int32)
    complete = done | ((ci == 0) & (w32(ci + base + cc) == 0))
    return packed, steps.astype(np.int32), complete, flat_reads


# ------------------------------------------------------------ the tests

CASES = [(name, RMAX) for name in ("synthetic",) + link_cases.CASES
         for RMAX in (256, 768)]


@functools.lru_cache(maxsize=None)
def plain(name, RMAX):
    """(fill args, fill keywords, plain fill, plain walk) of a case."""
    if name == "synthetic":
        text, arrs = link_cases.synthetic_links(5 + RMAX, N=300, RMAX=RMAX)
        scoring, B = link_cases.DEFAULT_SCORING, 16
    else:
        c = link_cases.link_case(name, RMAX=RMAX)
        text, arrs, scoring, B = c["text"], c["arrays"], c["scoring"], c["B"]
    a4, la, ta, ba, lb = (torch.from_numpy(np.ascontiguousarray(x))
                          for x in arrs)
    args = (a4.view(torch.int32), la, ta, ba, lb,
            torch.from_numpy(cuda_align.pack_text(text)))
    kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"), scoring),
              RMAX=RMAX, WB=4 * B + 1, T=len(text))
    fill = cuda_links.link_fill_ref(*args, **kw)
    walk = cuda_links.link_walk_ref(fill[1], la, ba, lb)
    return args, kw, fill, walk


@pytest.mark.parametrize("name,RMAX", CASES)
def test_fill_design_equals_plain(name, RMAX):
    """The fill's lane decomposition gives link_fill_ref's scores and
    every decision byte of rows 0..RMAX."""
    args, kw, (score, bits), _ = plain(name, RMAX)
    got_score, got_bits = fill_model(*(a.numpy() for a in args), **kw)
    np.testing.assert_array_equal(got_score, score.numpy())
    bad = got_bits != bits.numpy()
    assert not bad.any(), (int(bad.sum()), np.argwhere(bad)[:5])


@pytest.mark.parametrize("name,RMAX", CASES)
def test_walk_design_equals_plain(name, RMAX):
    """The walk's tile-plus-fallback rule gives link_walk_ref's packed ops,
    step counts and completion on the plain fill's bits."""
    args, _, (_, bits), want = plain(name, RMAX)
    la, ba, lb = args[1], args[3], args[4]
    *got, flat_reads = walk_model(bits.numpy(), la.numpy(), ba.numpy(),
                                  lb.numpy())
    for what, g, w in zip(("packed", "n_steps", "complete"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=what)
    if name.startswith("row_below_zero"):
        assert flat_reads > 0, "no step left the task's rows"


def test_models_reach_the_design_edges():
    """The cases drive the designs to their edges: warps whose tasks run
    0 and RMAX rows, final columns on both sides of each lane edge, walks
    crossing tile edges inside insertions and reaching row -1 from a tile
    that ends at row 0."""
    RMAX = 256
    args, kw, _, walk = plain("ragged_warp", RMAX)
    la = args[1].numpy()
    quads = warp_tasks(la, RMAX, cuda_links.FILL_BLOCK_TASKS,
                         cuda_links.FILL_WARP_TASKS)
    spans = {(int(la[w].min()), int(la[w].max())) for w in quads}
    assert (0, RMAX) in spans
    mid = RMAX // 2 + 3
    assert any(sorted(la[w])[:4] == [0, 1, mid, RMAX] for w in warp_tasks(
        la, RMAX, cuda_links.WALK_BLOCK_TASKS, cuda_links.WALK_WARP_TASKS))
    args, kw, _, _ = plain("tile_edges", RMAX)
    la, ba, lb = (args[i].numpy().astype(np.int64) for i in (1, 3, 4))
    cpl = link_cases.lane_columns(16)
    cf = set((lb - la - ba).tolist())
    assert {2 * cpl - 1, 2 * cpl, 3 * cpl - 1, 3 * cpl} <= cf
    R = cuda_links.WALK_TILE_ROWS
    assert {R - 1, R, R + 1, 2 * R - 1, 2 * R, 2 * R + 1, RMAX - 1,
            RMAX} <= set(la.tolist())
    args, _, _, (packed, n_steps, _) = plain("ins_tile_edge", RMAX)
    la = args[1].numpy()
    w = packed.numpy().view(np.uint32)
    ops = ((w[:, :, None] >> (np.arange(8, dtype=np.uint32) * 4)) & 15
           ).reshape(len(w), -1)
    crossed = 0
    for k in range(len(la)):
        row = la[k] - np.concatenate([[0], np.cumsum(ops[k] <= 2)[:-1]])
        ins = ops[k] == 2
        for edge in (R, 2 * R):
            # an I step from the tile's last row into the next tile, with
            # the run going on past it
            s = np.nonzero(ins & (row == la[k] - edge + 1))[0]
            crossed += any(ins[x + 1] or ins[max(x - 1, 0)] for x in s)
    assert crossed >= 20, crossed
