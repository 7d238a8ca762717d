"""Device engine for long-read LINK alignments, in torch ops.

The torch port of vg_tpu/ops/device_links.py. The long-read pipeline's
hot stage is the slow-path link DP: ~19 global affine alignments per read
between consecutive anchor blocks (reference role: chain-gap alignment in
minimizer_mapper_from_chains.cpp:708 / chain_items.cpp; the host twin is
native global_align, banded with an exact band-doubling escape bound).
This module batches every slow link of a read batch into one device pass:

  fill:      banded affine DP in diagonal space (offset c = j - i - base,
             base = min(0, d) - B, d = lb - la), a Python loop over rows;
             per-cell traceback DECISION BITS (diag-ok / E-selected /
             E-extend / F-extend / match) are exactly the equality checks
             the host traceback re-derives, so the walk reproduces the
             host edit sequence bit for bit. The in-row E scan uses the
             lazy-E identity (opening from an H that equals E never beats
             extending while gap_open >= gap_extend), one cummax a row.
  traceback: a lockstep walk over all problems (one gather per step),
             emitting 4-bit ops packed 8 a word.

The b (text) side is gathered on the device from the resident 4-bit
packed text (ops/cuda_align.pack_text), so only the read-side slices
cross to the card. A device result is used only when provably exact:
score >= match*min(la,lb) - 2*gap_open - gap_extend*(|d| + 2B) (any path
leaving the band scores below that), else the caller's host DP runs — the
same exactness rule as native global_align's band doubling
(vgtpu_host.cpp).

Everything is int32 with NEG = -(1 << 28) and wraps as JAX's int32 does;
the uint32 words (packed text, read nibbles, op words) ride in int64 and
are masked to 32 bits after each shift. The fill and the walk are plain
torch ops: about 35 small ops a row or a step, tens of thousands of
launches a batch on the card (PERF.md); a hand-written kernel waits for a
measurement that says it matters.
"""
from __future__ import annotations

import time

import numpy as np
import torch

NEG = -(1 << 28)
U32 = 0xFFFFFFFF


def _round_up(x, m):
    return (x + m - 1) // m * m


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def link_engine(a4, la, ta, base, lb, text_packed, *, RMAX: int, WB: int,
                T: int, match: int, mismatch: int, gap_open: int,
                gap_extend: int, timing: dict = None):
    """Fill + traceback of N padded link problems on the device of the
    tensors: a4 (N, RMAX/8) int32 (read codes, 8 nibbles a uint32 word),
    la, ta, base, lb (N,) int32, text_packed the packed text. Returns
    (score (N,) int32, packed ops (N, STEPS/8) int32 holding uint32 bits,
    n_steps (N,) int32, complete (N,) bool), equal to
    vg_tpu.ops.device_links.link_engine()'s on the same arrays. With
    `timing`, synchronises after each phase and adds its seconds under
    "fill" and "walk"."""
    dev = a4.device
    i32 = torch.int32
    u8 = torch.uint8
    N = a4.shape[0]
    KB = _round_up(RMAX + WB + 8, 8)
    t0 = time.perf_counter()

    # device-side b gather: bdiag[n, t] = text[ta + base - 1 + t]
    b0 = ta.to(i32) + base - 1
    p = b0.to(torch.int64)[:, None] + torch.arange(KB, device=dev)
    nw = text_packed.shape[0]
    words = text_packed[(p >> 3).clamp(0, nw - 1)].to(torch.int64)
    nib = ((words & U32) >> ((p & 7) * 4)) & 15
    bdiag = torch.where((p >= 0) & (p < T), nib, 6).to(u8)

    # unpack read side: a_all[n, i] = a[i] (4-bit packed input)
    col = torch.arange(RMAX, device=dev)
    a_all = (((a4.to(torch.int64)[:, col // 8] & U32) >> ((col % 8) * 4))
             & 15).to(u8)

    cgrid = torch.arange(WB, dtype=i32, device=dev)[None, :]   # (1, WB)
    ramp = cgrid * gap_extend
    lbb = lb[:, None]
    bse = base[:, None]
    la_c = la[:, None]
    negcol = torch.full((N, 1), NEG, dtype=i32, device=dev)

    # row 0 boundary: H[0, j] = E[0, j] = -(go + (j-1)*ge), H[0,0]=0
    j0 = bse + cgrid
    in0 = (j0 >= 0) & (j0 <= lbb)
    H = torch.where(j0 == 0, 0,
                    torch.where(in0 & (j0 > 0),
                                -(gap_open + (j0 - 1) * gap_extend),
                                NEG)).to(i32)
    F = torch.full((N, WB), NEG, dtype=i32, device=dev)
    # decision bits of rows 0..RMAX, one (N, RMAX+1, WB) block: the walk
    # gathers from it with vg_tpu's flat index n*(RMAX+1)*WB + i*WB + c
    bits_all = torch.empty((N, RMAX + 1, WB), dtype=u8, device=dev)
    # row-0 decision bits: every j>0 cell is E-selected; E extends while
    # j >= 2 (E(0,j) == E(0,j-1) - ge, and H(0,j-1) - go differs because
    # go != ge)
    bits_all[:, 0] = torch.where(in0 & (j0 > 0),
                                 2 | ((j0 >= 2).to(u8) << 2),
                                 0).to(u8)
    cfin = lb - la - base                           # final band column
    cfin_c = cfin.clamp(0, WB - 1)[:, None]
    score = torch.full((N,), NEG, dtype=i32, device=dev)

    for i in range(1, RMAX + 1):
        j = i + bse + cgrid                         # (N, WB)
        inb = (j >= 0) & (j <= lbb) & (i <= la_c)
        ai = a_all[:, i - 1 : i]                    # (N, 1)
        # b[j-1] = text[ta + j - 1] = bdiag[i + c]
        bt = bdiag[:, i : i + WB]
        mbit = (bt == ai) & (ai < 4)
        sub = torch.where(mbit, match, -mismatch).to(i32)
        # diag (i-1, j-1) -> same c; up (i-1, j) -> c+1
        diag = H + sub
        Hup1 = torch.cat([H[:, 1:], negcol], 1)
        Fup1 = torch.cat([F[:, 1:], negcol], 1)
        F = torch.maximum(Hup1 - gap_open, Fup1 - gap_extend)
        f_ext = (F == Fup1 - gap_extend) & (F != Hup1 - gap_open)
        hn = torch.maximum(diag, F)                 # H without E
        # lazy-E via cummax: E[c] = max_{c'<=c}(open[c'] + c'*ge) - go - c*ge
        hn_sh = torch.cat([negcol, hn[:, :-1]], 1)
        colH = torch.where(i <= la_c, -(gap_open + (i - 1) * gap_extend),
                           NEG).to(i32)
        j1 = j == 1
        opensrc = torch.where(j1, torch.maximum(hn_sh, colH), hn_sh)
        g = torch.clamp_min(opensrc, NEG) + ramp
        pref = torch.cummax(g, dim=1).values
        E = torch.clamp_min(pref - gap_open - ramp, NEG)
        H = torch.maximum(hn, E)
        e_sel = H == E
        E_sh = torch.cat([negcol, E[:, :-1]], 1)
        Hfull_sh = torch.cat([negcol, H[:, :-1]], 1)
        Hfull_sh = torch.where(j1, torch.maximum(Hfull_sh, colH), Hfull_sh)
        e_ext = (E == E_sh - gap_extend) & (E != Hfull_sh - gap_open)
        diag_ok = H == diag
        H = torch.where(inb, H, NEG)
        F = torch.where(inb, F, NEG)
        bits = (diag_ok.to(u8) | (e_sel.to(u8) << 1) | (e_ext.to(u8) << 2)
                | (f_ext.to(u8) << 3) | (mbit.to(u8) << 4))
        bits_all[:, i] = torch.where(inb, bits, 0)
        hit = torch.gather(H, 1, cfin_c)[:, 0]
        score = torch.where(la == i, hit, score)
    score = torch.where(
        la == 0,
        torch.where(lb == 0, 0, -(gap_open + (lb - 1) * gap_extend)),
        score).to(i32)
    if timing is not None:
        _sync(dev)
        t1 = time.perf_counter()
        timing["fill"] = timing.get("fill", 0.0) + t1 - t0
        t0 = t1

    bpf = bits_all.reshape(-1)
    size = bpf.shape[0]
    lane_base = torch.arange(N, dtype=torch.int64, device=dev) * (
        (RMAX + 1) * WB)
    # certified paths satisfy total-gap-length <= 2*go/ge + |d| + 2B (from
    # the escape bound), so steps = lb + #I <= (RMAX + 2B) +
    # (2*go/ge + |d| + 2B + |d|)/2 — 64 slack covers any scoring in use;
    # longer walks fail `complete` and fall back to the host
    STEPS = _round_up(RMAX + WB + 64, 8)
    ci = la.clone()
    cc = cfin.clamp(0, WB - 1)
    st = torch.zeros(N, dtype=i32, device=dev)
    done = (la == 0) & (lb == 0)
    ops = torch.empty((STEPS, N), dtype=u8, device=dev)
    for s in range(STEPS):
        j = ci + base + cc
        # vg_tpu's gather: int32 flat index, negative wraps once, then
        # clamped into the array (int64 here: no overflow at large N)
        flat = lane_base + ci.to(torch.int64) * WB + cc.clamp(0, WB - 1)
        flat = torch.where(flat < 0, flat + size, flat).clamp(0, size - 1)
        cell = bpf[flat]
        diag_ok = (cell & 1).to(torch.bool)
        e_sel = ((cell >> 1) & 1).to(torch.bool)
        e_ext = ((cell >> 2) & 1).to(torch.bool)
        f_ext = ((cell >> 3) & 1).to(torch.bool)
        mtc = ((cell >> 4) & 1).to(torch.bool)
        at_end = (ci == 0) & (j == 0)
        take_d = (st == 0) & (ci > 0) & (j > 0) & diag_ok
        in_e = (st == 2) | ((st == 0) & ~take_d & (j > 0) & e_sel)
        in_f = ~take_d & ~in_e
        # ops: 0=M 1=X 2=I(read gap char) 3=D(text) 4=pad
        op = torch.where(take_d, torch.where(mtc, 0, 1),
                         torch.where(in_e, 3, 2))
        halt = done | at_end
        ops[s] = torch.where(halt, 4, op).to(u8)
        ni = torch.where(take_d | in_f, ci - 1, ci)
        nc = torch.where(take_d, cc, torch.where(in_e, cc - 1, cc + 1))
        nst = torch.where(
            take_d, 0,
            torch.where(in_e, torch.where(e_ext & (j > 1), 2, 0),
                        torch.where(f_ext & (ci > 1), 1, 0))).to(i32)
        ci = torch.where(halt, ci, ni)
        cc = torch.where(halt, cc, nc)
        st = torch.where(halt, st, nst)
        done = halt
    n_steps = (ops != 4).sum(dim=0).to(i32)
    complete = done | ((ci == 0) & ((ci + base + cc) == 0))
    # pack 4-bit ops 8/word, traceback order
    SW = STEPS // 8
    sh4 = (torch.arange(STEPS, device=dev) % 8) * 4
    packed = (ops.T.to(torch.int64) << sh4).reshape(N, SW, 8).sum(dim=2)
    packed = torch.where(packed >= 2 ** 31, packed - 2 ** 32,
                         packed).to(i32)
    if timing is not None:
        _sync(dev)
        timing["walk"] = timing.get("walk", 0.0) + time.perf_counter() - t0
    return score, packed, n_steps, complete


class DeviceLinkAligner:
    """Host wrapper: batches slow-link problems into the device engine
    and returns per-problem (score, unit edits) identical to native
    global_align — (op, 1, read_off) triples in traceback order, op
    0=M 1=X 2=I 3=D. Problems outside the engine's shape envelope, or
    whose band cannot be certified exact, return None (caller runs the
    host DP).

    `stats`, when set to a dict, gathers over calls: the tasks handed to
    align_runs_arrays, the tasks, padded tasks and certified
    (device-resolved) tasks of each size bucket, and the seconds of the
    fill, the walk and the fetch (synchronising between them)."""

    def __init__(self, text_packed_dev, T: int, scoring,
                 RMAX: int = 256, B: int = 16, buckets=(256, 768)):
        self.text_packed = text_packed_dev
        self.device = text_packed_dev.device
        self.T = T
        self.sc = scoring
        self.RMAX = RMAX
        self.B = B
        self.buckets = tuple(buckets)
        self.stats = None
        assert scoring.gap_open >= scoring.gap_extend, \
            "lazy-E fill requires gap_open >= gap_extend"

    def eligible(self, la: int, lb: int) -> bool:
        # band cover: WB = 4B+1 columns hold offsets up to |d| + 2B + 1
        return 0 < la <= self.RMAX and 0 < lb and abs(lb - la) <= 2 * self.B

    def _engine(self, a4, la_a, ta_a, ba_a, lb_a, RMAX):
        """Run link_engine on the padded numpy task arrays; numpy out."""
        sc = self.sc
        dev = self.device
        put = lambda x: torch.as_tensor(x, device=dev)
        timing = {} if self.stats is not None else None
        out = link_engine(
            put(a4.view(np.int32)), put(la_a), put(ta_a), put(ba_a),
            put(lb_a), self.text_packed, RMAX=RMAX, WB=4 * self.B + 1,
            T=self.T, match=sc.match, mismatch=sc.mismatch,
            gap_open=sc.gap_open, gap_extend=sc.gap_extend, timing=timing)
        t0 = time.perf_counter()
        score, packed, n_steps, complete = (x.cpu().numpy() for x in out)
        if timing is not None:
            timing["fetch"] = time.perf_counter() - t0
            for k, v in timing.items():
                self.stats[k] = self.stats.get(k, 0.0) + v
        return score, packed.view(np.uint32), n_steps, complete

    def align_runs_arrays(self, a_rows, la, ta, lb):
        """Bulk resolver form over PRE-PADDED task arrays: a_rows (n,
        LAMAX) uint8 oriented read slices, la/ta/lb (n,) int. Returns
        (resolved bool, scores i64, runs (m,3) i32 forward-merged
        (op, len, 0) for resolved tasks concatenated in task order,
        counts i64). Tasks route to the smallest engine size bucket
        that fits (one padded task grid per bucket); everything is
        vectorized — a per-task Python loop here cost more than the device
        DP at ~18k tasks."""
        sc = self.sc
        n = len(la)
        la = np.asarray(la, np.int64)
        lb = np.asarray(lb, np.int64)
        ta = np.asarray(ta, np.int64)
        resolved = np.zeros(n, bool)
        scores = np.zeros(n, np.int64)
        counts = np.zeros(n, np.int64)
        run_segs = {}
        d = lb - la
        base_ok = (la > 0) & (lb > 0) & (np.abs(d) <= 2 * self.B)
        assigned = np.zeros(n, bool)
        nib = np.arange(8, dtype=np.uint32) * 4
        if self.stats is not None:
            self.stats["tasks"] = self.stats.get("tasks", 0) + n
        for RMAX in self.buckets:
            sel = np.nonzero(base_ok & ~assigned & (la <= RMAX))[0]
            assigned[base_ok & (la <= RMAX)] = True
            if len(sel) == 0:
                continue
            # pad the task count to a power-of-two grid (vg_tpu compiles
            # one XLA program per grid; the padding is kept for parity)
            N = max(1 << int(np.ceil(np.log2(max(len(sel), 1)))), 1024)
            a_pad = np.zeros((N, RMAX), np.uint8)
            w = min(RMAX, a_rows.shape[1])
            a_pad[: len(sel), :w] = a_rows[sel, :w]
            # zero bases beyond la (padding must be deterministic)
            colm = np.arange(RMAX)[None, :] >= la[sel, None]
            a_pad[: len(sel)][colm[:, :RMAX]] = 0
            a4 = (a_pad.reshape(N, RMAX // 8, 8).astype(np.uint32)
                  << nib[None, None]).sum(axis=2, dtype=np.uint32)
            la_a = np.zeros(N, np.int32)
            ta_a = np.zeros(N, np.int32)
            ba_a = np.zeros(N, np.int32)
            lb_a = np.ones(N, np.int32)
            la_a[: len(sel)] = la[sel]
            ta_a[: len(sel)] = ta[sel]
            lb_a[: len(sel)] = lb[sel]
            ba_a[: len(sel)] = np.minimum(0, d[sel]) - self.B
            score_d, packed, n_steps, complete = self._engine(
                a4, la_a, ta_a, ba_a, lb_a, RMAX)
            score_d = score_d[: len(sel)]
            n_steps = n_steps[: len(sel)]
            complete = complete[: len(sel)]
            packed = packed[: len(sel)]
            dd = np.abs(d[sel])
            escape_ub = (sc.match * np.minimum(la[sel], lb[sel])
                         - 2 * sc.gap_open
                         - sc.gap_extend * (dd + 2 * self.B))
            cert = complete & (score_d >= escape_ub)
            if self.stats is not None:
                b = self.stats.setdefault("buckets", {}).setdefault(
                    RMAX, {"tasks": 0, "padded": 0, "certified": 0})
                b["tasks"] += len(sel)
                b["padded"] += N
                b["certified"] += int(cert.sum())
            if not cert.any():
                continue
            SW8 = packed.shape[1] * 8
            codes = ((packed[:, :, None]
                      >> (np.arange(8, dtype=np.uint32) * 4)[None, None])
                     & 15).reshape(len(packed), SW8).astype(np.uint8)
            ci = np.nonzero(cert)[0]
            ns = n_steps[ci].astype(np.int64)
            rev_idx = np.clip(ns[:, None] - 1
                              - np.arange(SW8, dtype=np.int64)[None, :],
                              0, SW8 - 1)
            fwd = np.take_along_axis(codes[ci], rev_idx, axis=1)
            msk = np.arange(SW8)[None, :] < ns[:, None]
            flat = fwd[msk]
            tid = np.repeat(np.arange(len(ci)), ns)
            brk = np.ones(len(flat), bool)
            brk[1:] = (flat[1:] != flat[:-1]) | (tid[1:] != tid[:-1])
            starts = np.nonzero(brk)[0]
            ends = np.concatenate([starts[1:], [len(flat)]])
            runs = np.zeros((len(starts), 3), np.int32)
            runs[:, 0] = flat[starts]
            runs[:, 1] = (ends - starts).astype(np.int32)
            tstart = np.concatenate([[0], np.cumsum(ns)])[:-1]
            r0 = np.searchsorted(starts, tstart, side="left")
            r1 = np.concatenate([r0[1:], [len(starts)]])
            g_t = sel[ci]
            counts[g_t] = r1 - r0
            resolved[g_t] = True
            scores[g_t] = score_d[ci]
            # per-task run segments, keyed by global task id
            seg_off = np.concatenate([[0], np.cumsum(r1 - r0)])
            run_segs[RMAX] = (g_t, runs, seg_off)
        # concatenate per-bucket run segments in GLOBAL task order
        if not run_segs:
            return resolved, scores, np.zeros((0, 3), np.int32), counts
        runs_off = np.concatenate([[0], np.cumsum(counts)])
        all_runs = np.zeros((int(runs_off[-1]), 3), np.int32)
        for RMAX, (g_t, runs, seg_off) in run_segs.items():
            seg = counts[g_t]
            tot = int(seg.sum())
            if tot == 0:
                continue
            within = (np.arange(tot)
                      - np.repeat(seg_off[:-1], seg))
            dest = np.repeat(runs_off[g_t], seg) + within
            all_runs[dest] = runs[:tot]
        return resolved, scores, all_runs, counts

    def align(self, problems):
        """problems: list of (a_codes uint8[la], ta_global int, lb int).
        Returns a list of (score, edits) or None per problem."""
        sc = self.sc
        n = len(problems)
        out = [None] * n
        dev_idx = [t for t, (a, _ta, lb) in enumerate(problems)
                   if self.eligible(len(a), lb)]
        if not dev_idx:
            return out
        N = _round_up(len(dev_idx), 8)
        RMAX = self.RMAX
        a4 = np.zeros((N, RMAX // 8), np.uint32)
        la_a = np.zeros(N, np.int32)
        ta_a = np.zeros(N, np.int32)
        ba_a = np.zeros(N, np.int32)
        lb_a = np.ones(N, np.int32)
        nib = (np.arange(8, dtype=np.uint32) * 4)
        for k, t in enumerate(dev_idx):
            a, ta, lb = problems[t]
            la = len(a)
            ap = np.zeros(RMAX, np.uint8)
            ap[:la] = a
            a4[k] = (ap.reshape(-1, 8).astype(np.uint32) << nib).sum(
                axis=1, dtype=np.uint32)
            la_a[k], ta_a[k], lb_a[k] = la, ta, lb
            ba_a[k] = min(0, lb - la) - self.B
        score, packed, n_steps, complete = self._engine(
            a4, la_a, ta_a, ba_a, lb_a, RMAX)
        SW8 = packed.shape[1] * 8
        codes = ((packed[:, :, None]
                  >> (np.arange(8, dtype=np.uint32) * 4)[None, None])
                 & 15).reshape(len(packed), SW8).astype(np.uint8)
        for k, t in enumerate(dev_idx):
            a, _ta, lb = problems[t]
            la = len(a)
            d = abs(lb - la)
            escape_ub = (sc.match * min(la, lb) - 2 * sc.gap_open
                         - sc.gap_extend * (d + 2 * self.B))
            if not complete[k] or score[k] < escape_ub:
                continue
            ns = int(n_steps[k])
            ops = codes[k, :ns]
            consume = (ops == 0) | (ops == 1) | (ops == 2)
            rp_after = (la - np.cumsum(consume)).astype(np.int64)
            # host convention (vgtpu_host.cpp global_align traceback):
            # M/X/I carry the read index consumed; D carries -1
            rp_after = np.where(ops == 3, -1, rp_after)
            out[t] = (int(score[k]),
                      [(int(o), 1, int(p))
                       for o, p in zip(ops, rp_after)])
        return out
