"""A CPU model of the quality entry's split route (csrc/banded_dp.cu,
banded_dp_qual_split_kernel), in numpy, held exactly equal to its plain
version (ops/cuda_align.banded_scores_qual_packed_ref). The kernel runs
only on the card; this model repeats its lane order step by step, so that
the arithmetic of the design is tested where the kernel cannot run:

- the block's compaction: a block owns S = 128 / G slots, ranks its valid
  ones and hands the q-th to group q; invalid slots get -1 in place;
- the window's match masks, 32-column words a base built once a slot
  (up to row RL - 1's at the last lane's offset), lane g's bits
  funnel-shifted from words (i + g CPL) >> 5 and the one after;
- lane g holding the CPL = ceil(W / G) consecutive band columns g CPL ..,
  columns past W present in the registers: row i - 1's G and F of the
  next lane's first column by one shuffle (the last lane reads its own);
- E' as a serial max along the lane's columns, then the carry into
  lane g: the totals of lanes 0 .. g - 1, read by G - 1 independent
  shuffles, each decayed by CPL e a lane, their max folded into the
  lane's columns;
- column W pinned to the cell above the band after every row, the row
  maxima of the columns up to W - 1 only (two running bests a lane,
  and the slot's last row's two maxima), reduced over the G lanes once;
  the end-of-read bonus at the last row;
- a warp's 32 / G groups running its longest slot's rows in step, a
  slot's rows past its own changing its registers but not its maxima.

The kernel is built for G = 4 (cuda_align.QUAL_LANES); the model takes
any G, and G = 2 and 8 hold the decomposition to other widths of a lane.

Imports no JAX."""
import numpy as np
import pytest
import torch

from vg_tpu_torch.ops import cuda_align, dp_cases, qualadj

torch.set_num_threads(1)

NEG = -100_000_000              # csrc/banded_dp.cu kNeg
MASK_ROWS = 5                   # bases 0-3 and the empty mask
THREADS = 128                   # kQualThreads: threads of a block
I32 = (-(1 << 31), (1 << 31) - 1)


def compact(valid, G):
    """Group q of each block -> its slot, as compact_block ranks them:
    (slots (M,), the block and the group of each)."""
    S = THREADS // G
    v = np.asarray(valid).reshape(-1)
    slots, blocks, groups = [], [], []
    for blk, n0 in enumerate(range(0, len(v), S)):
        live = n0 + np.flatnonzero(v[n0 : n0 + S])
        assert len(live) <= S
        slots += list(live)          # group q takes the q-th valid slot
        blocks += [blk] * len(live)
        groups += list(range(len(live)))
    return (np.array(slots, np.int64), np.array(blocks, np.int64),
            np.array(groups, np.int64))


def window_words(text, start, lo, hi, nwords):
    """(M, 4, nwords) uint32: bit j of word w of base b is set where the
    text at start + 32 w + j, inside [lo, hi) ∩ [0, T), holds b."""
    T = len(text)
    pos = start[:, None] + np.arange(32 * nwords)[None, :]
    ok = ((pos >= np.maximum(lo, 0)[:, None])
          & (pos < np.minimum(hi, T)[:, None]))
    code = np.where(ok, text[np.clip(pos, 0, T - 1)], 6)
    bits = (code[:, None, :] == np.arange(4)[None, :, None])
    bits = bits.reshape(len(start), 4, nwords, 32).astype(np.uint64)
    return (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint64)


def split_model(args, tabs, B, G, gap_open=6, gap_extend=1):
    """The split route's scores, (R, C) int32, computed in the kernel's
    order."""
    (text, reads, reads_rc, quals, rlen, start, lo, hi, rev,
     valid) = [np.asarray(a) for a in args]
    mt, mm, bt = (np.asarray(t, np.int64) for t in tabs)
    R, RL = reads.shape
    C = start.shape[1]
    W = 2 * B + 1
    CPL = -(-W // G)
    kLast, jLast = divmod(W - 1, CPL)
    kPin, jPin = divmod(W, CPL)
    o, e = gap_open, gap_extend
    qmax = len(mt) - 1

    out = np.full(R * C, -1, np.int64)
    slots, blocks, groups = compact(valid, G)
    M = len(slots)
    if M == 0:
        return out.reshape(R, C).astype(np.int32)
    r = slots // C
    rv = rev.reshape(-1)[slots]
    rl = rlen[r].astype(np.int64)
    rows = np.minimum(rl, RL)
    # a warp (32 / G groups of a block) runs its longest slot's rows
    warp = blocks * (THREADS // 32) + groups // (32 // G)
    wrows = np.zeros(warp.max() + 1, np.int64)
    np.maximum.at(wrows, warp, rows)
    wrows = wrows[warp]
    rd = np.where(rv[:, None], reads_rc[r], reads[r]).astype(np.int64)
    qs = quals[r].astype(np.int64)

    def qual(i):                  # (M,) the oriented quality of row i
        j = np.where(rv, rl - 1 - i, i)
        j = np.clip(j, 0, RL - 1)
        return np.minimum(qs[np.arange(M), j], qmax)

    # the window's words, built once a slot: enough for row RL - 1 at the
    # last lane's offset, and the word past it
    nwords = ((RL - 1 + (G - 1) * CPL) >> 5) + 2
    words = window_words(text, start.reshape(-1)[slots].astype(np.int64),
                         lo.reshape(-1)[slots].astype(np.int64),
                         hi.reshape(-1)[slots].astype(np.int64), nwords)
    words = np.concatenate([words, np.zeros((M, 1, nwords), np.uint64)], 1)

    lane = np.arange(G)
    c0 = lane * CPL
    col = c0[:, None] + np.arange(CPL)[None, :]               # (G, CPL)
    g0 = np.where(rows > 0, bt[qual(0)], 0) - o               # (M,)
    Gc = np.where(col[None] < W, g0[:, None, None], NEG - o)  # (M, G, CPL)
    Gc = np.broadcast_to(Gc, (M, G, CPL)).astype(np.int64).copy()
    Fc = np.full((M, G, CPL), NEG, np.int64)
    carry = -(o + np.arange(CPL) * e)                          # (CPL,)
    h = np.arange(G - 1)
    dec = np.where(h[None, :] < lane[:, None],                 # (G, G - 1)
                   -((lane[:, None] - 1 - h[None, :]) * CPL * e), NEG)
    best_a = np.zeros((M, G), np.int64)
    best_b = np.zeros((M, G), np.int64)
    last_a = np.full((M, G), NEG, np.int64)
    last_b = np.full((M, G), NEG, np.int64)
    down = np.minimum(lane + 1, G - 1)   # __shfl_down_sync(.., 1, G)

    for i in range(int(wrows.max())):
        run = i < wrows                  # the slot's warp runs row i
        act, lastrow = i < rows, i == rows - 1
        code = rd[:, i]
        b = np.where(code < 4, code, MASK_ROWS - 1)
        p = i + c0[None, :]                                   # (1, G)
        wd = p >> 5
        lo_w = words[np.arange(M)[:, None], b[:, None], wd]
        hi_w = words[np.arange(M)[:, None], b[:, None], wd + 1]
        bits = (((hi_w << np.uint64(32)) | lo_w)
                >> (p & 31).astype(np.uint64)) & np.uint64(0xFFFFFFFF)
        v = qual(i)
        hs = (mt[v] + o)[:, None]
        ms = (o + mm[v])[:, None]
        Gn = np.concatenate([Gc, Gc[:, down, :1]], axis=2)    # (M, G, CPL+1)
        Fn = np.concatenate([Fc, Fc[:, down, :1]], axis=2)
        G2, F2 = Gc.copy(), Fc.copy()
        ep = np.full((M, G), NEG, np.int64)
        for k in range(CPL):
            f = np.maximum(Fn[:, :, k + 1] - e, Gn[:, :, k + 1])
            hit = ((bits >> np.uint64(k)) & np.uint64(1)).astype(bool)
            hn = np.maximum(np.maximum(Gn[:, :, k] + np.where(hit, hs, ms),
                                       f), 0)
            x = hn - o
            G2[:, :, k] = np.maximum(ep - o, x)
            ep = np.maximum(ep - e, x)
            F2[:, :, k] = f
        # the totals of lanes 0 .. G - 2 by shuffle, decayed to each lane
        u = ep[:, None, : G - 1] + dec[None]                   # (M, G, G-1)
        cin = u.max(-1) if G > 1 else np.full((M, G), NEG)
        G2 = np.maximum(cin[:, :, None] + carry[None, None], G2)
        G2[:, kPin, jPin] = NEG - o
        F2[:, kPin, jPin] = NEG
        ra = G2[:, :, : jLast + 1].max(-1)
        rb = (G2[:, :, jLast + 1 :].max(-1) if jLast + 1 < CPL
              else np.full((M, G), NEG))
        upd = (run & act)[:, None]
        best_a = np.where(upd, np.maximum(ra + o, best_a), best_a)
        best_b = np.where(upd, np.maximum(rb + o, best_b), best_b)
        last_a = np.where((run & lastrow)[:, None], ra, last_a)
        last_b = np.where((run & lastrow)[:, None], rb, last_b)
        Gc = np.where(run[:, None, None], G2, Gc)
        Fc = np.where(run[:, None, None], F2, Fc)
        for x in (Gc, Fc, best_a, best_b):
            assert I32[0] <= x.min() and x.max() <= I32[1], "int32 left"

    below, at = lane[None, :] < kLast, lane[None, :] == kLast
    best = np.where(below, np.maximum(best_a, best_b),
                    np.where(at, best_a, 0)).max(1)
    last = np.where(below, np.maximum(last_a, last_b),
                    np.where(at, last_a, NEG)).max(1)
    end = (rows > 0) & (rows == rl)
    best = np.where(end, np.maximum(best, last + o + bt[qual(rl - 1)]), best)
    out[slots] = best
    return out.reshape(R, C).astype(np.int32)


def plain(args, tabs, B):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    tt = [torch.from_numpy(np.asarray(x, np.int32)) for x in tabs]
    packed = torch.from_numpy(cuda_align.pack_text(args[0]))
    return cuda_align.banded_scores_qual_packed_ref(
        packed, len(args[0]), *t[1:], *tt, band_radius=B).numpy()


@pytest.mark.parametrize("B", [8, 12, 16])
@pytest.mark.parametrize("G", [2, 4, 8])
def test_split_model_equals_plain_on_qual_case(G, B):
    """qual_case (both strands, rlen 0 and short reads, N bases, phred
    0-93, windows cut by lo / hi and the text's ends, block_valid's
    patterns), W = 17, 25, 33 columns over G lanes: exact."""
    args = dp_cases.qual_case(np.random.default_rng(100 + B), R=48, C=8,
                              RL=160, B=B, T=20_000)
    tabs = qualadj.qual_tables(1, 4, 5)
    want = plain(args, tabs, B)
    np.testing.assert_array_equal(split_model(args, tabs, B, G), want)
    assert (want[~args[-1]] == -1).all()


@pytest.mark.parametrize("name", dp_cases.SPLIT_CASES)
@pytest.mark.parametrize("B", [8, 12, 16])
@pytest.mark.parametrize("G", [2, 4, 8])
def test_split_model_equals_plain_on_split_cases(G, B, name):
    args, tabs = dp_cases.split_case(name, np.random.default_rng(7 * B), B,
                                     R=32)
    np.testing.assert_array_equal(split_model(args, tabs, B, G),
                                  plain(args, tabs, B))


@pytest.mark.parametrize("B", [8, 12, 16])
@pytest.mark.parametrize("G", [2, 4, 8])
def test_lane_layout(G, B):
    """Every split leaves columns past W in the last lane (so that column
    W - 1 reads its neighbour from the registers, pinned), and the lanes
    before column W - 1's hold band columns only."""
    W = 2 * B + 1
    CPL = -(-W // G)
    assert G * CPL > W
    kLast, jLast = divmod(W - 1, CPL)
    assert kLast * CPL + jLast == W - 1 and kLast < G
    assert divmod(W, CPL) == ((kLast, jLast + 1) if jLast + 1 < CPL
                              else (kLast + 1, 0))


def test_compaction_hands_valid_slots_to_groups_in_order():
    """Blocks of 128 / G slots; block_valid's patterns (all, none, one,
    alternate, half) over 128-slot ranges, so a split block may hold
    none."""
    valid = dp_cases.block_valid(np.random.default_rng(3), 160, 8)
    for G in (2, 4, 8):
        slots, blocks, groups = compact(valid, G)
        S = THREADS // G
        assert (np.diff(slots) > 0).all()
        assert ((slots // S) == blocks).all()
        np.testing.assert_array_equal(slots, np.flatnonzero(valid))
        assert len(np.unique(blocks)) < -(-valid.size // S)   # some empty


def test_split_cases_hold_their_edges():
    """The split cases hold what they name: rows 0, 1, 2, RL and past RL
    in one warp's slots; indels of 1 .. 2B bases; signed mismatches;
    phred past an 8-entry table."""
    rng = np.random.default_rng(5)
    args, _ = dp_cases.split_case("rows", rng, 16)
    rlen, valid = args[4], args[-1]
    assert valid.all() and {0, 1, 2, 160, 167} <= set(rlen[:8].tolist())
    args, _ = dp_cases.split_case("indel", rng, 16)
    assert args[-1].all() and (args[4] == 150).all()
    _, tabs = dp_cases.split_case("signed", rng, 16)
    assert (tabs[1] > 0).any() and (tabs[1] < 0).any()
    args, tabs = dp_cases.split_case("past_end", rng, 16)
    assert len(tabs[0]) == 8 and (args[3] >= 8).mean() > 0.5


@pytest.mark.parametrize("N,G", [(1, 4), (2048, 4), (4096, 4), (8192, 4),
                                 (12672, 4), (12673, 1), (16384, 1),
                                 (49152, 1), (131072, 1)])
def test_qual_lanes_rule(N, G):
    """The route rule on 132 SMs: the vg map batch (512 reads x 8
    candidates, N = 4,096) takes 4 lanes a slot, as does every batch up
    to 96 slots an SM (12,672); larger batches, the main path's 49,152
    among them, and reads past QUAL_SPLIT_MAX_RL rows take one slot a
    thread."""
    assert cuda_align.qual_lanes(N, 132, 160) == G
    assert cuda_align.qual_lanes(N, 132, cuda_align.QUAL_SPLIT_MAX_RL) == G
    assert cuda_align.qual_lanes(N, 132,
                                 cuda_align.QUAL_SPLIT_MAX_RL + 1) == 1
