"""Device engine for long-read LINK alignments.

The torch port of vg_tpu/ops/device_links.py. The long-read pipeline's
hot stage is the slow-path link DP: ~19 global affine alignments per read
between consecutive anchor blocks (reference role: chain-gap alignment in
minimizer_mapper_from_chains.cpp:708 / chain_items.cpp; the host twin is
native global_align, banded with an exact band-doubling escape bound).
This module batches every slow link of a read batch into one device pass,
two kernels (ops/cuda_links.py, csrc/link_engine.cu):

  fill:      banded affine DP in diagonal space (offset c = j - i - base,
             base = min(0, d) - B, d = lb - la), eight lanes a task on
             the card; per-cell traceback DECISION BITS (diag-ok / E-selected
             / E-extend / F-extend / match) are exactly the equality
             checks the host traceback re-derives, so the walk reproduces
             the host edit sequence bit for bit. The in-row E scan uses
             the lazy-E identity (opening from an H that equals E never
             beats extending while gap_open >= gap_extend), one prefix max
             a row.
  traceback: a walk of every problem (four lanes a task on the card,
             reading the bits from tiles of rows in shared memory, one
             byte a step), emitting 4-bit ops packed 8 a word.

CUDA tensors launch the two kernels; CPU tensors run their plain torch
versions (cuda_links.link_fill_ref, link_walk_ref), the loop of torch ops
over rows and steps that vg_tpu's lax.scans become without a kernel.

The b (text) side is gathered on the device from the resident 4-bit
packed text (ops/cuda_align.pack_text), so only the read-side slices
cross to the card. A device result is used only when provably exact:
score >= match*min(la,lb) - 2*gap_open - gap_extend*(|d| + 2B) (any path
leaving the band scores below that), else the caller's host DP runs — the
same exactness rule as native global_align's band doubling
(vgtpu_host.cpp).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import cuda_links


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
    vg_tpu.ops.device_links.link_engine()'s on the same arrays. On the
    card one call is one launch of each kernel. With `timing`,
    synchronises after each phase and adds its seconds under "fill" and
    "walk"."""
    dev = a4.device
    t0 = time.perf_counter()
    score, bits = cuda_links.link_fill(
        a4, la, ta, base, lb, text_packed, RMAX=RMAX, WB=WB, T=T,
        match=match, mismatch=mismatch, gap_open=gap_open,
        gap_extend=gap_extend)
    if timing is not None:
        _sync(dev)
        t1 = time.perf_counter()
        timing["fill"] = timing.get("fill", 0.0) + t1 - t0
        t0 = t1
    packed, n_steps, complete = cuda_links.link_walk(bits, la, base, lb)
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
