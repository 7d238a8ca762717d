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
packed text (ops/cuda_align.pack_text). The read side crosses to the card
as the batch's forward codes, once a batch: cuda_links.link_pack gathers
each task's oriented slice there, and cuda_links.link_runs turns the
walk's step codes into runs there, so that a bucket sends back only its
scores, certified mask, run counts and runs (vg_tpu did both passes in
numpy on the host). A device result is used only when provably exact:
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
    align_runs_blob, the tasks, padded tasks and certified
    (device-resolved) tasks of each size bucket, and the seconds of the
    pack, the fill, the walk, the runs and the fetch (synchronising
    between them)."""

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

    def _engine(self, a4, la_a, ta_a, ba_a, lb_a, RMAX, timing=None):
        """link_engine on one bucket's padded task tensors (on the
        aligner's device); its outputs stay there."""
        sc = self.sc
        return link_engine(
            a4, la_a, ta_a, ba_a, lb_a, self.text_packed, RMAX=RMAX,
            WB=4 * self.B + 1, T=self.T, match=sc.match,
            mismatch=sc.mismatch, gap_open=sc.gap_open,
            gap_extend=sc.gap_extend, timing=timing)

    def align_runs_blob(self, blob, read_off, task_read, task_rev, ra, la,
                        ta, lb):
        """Bulk resolver over a batch's reads on the device: blob (nb,)
        uint8 tensor of the forward read codes on the aligner's device,
        read_off (R + 1,) int64 (read r is blob[read_off[r] ..
        read_off[r + 1])), and per task (n,) ints: its read, its strand
        (the slice is read_codes[ra .. ra + la) of the read's reverse
        complement where task_rev), ra, la, ta, lb. Returns (resolved bool,
        scores i64, counts i64, pieces): pieces holds, for each size bucket
        with a certified task, (its certified task ids ascending, their
        forward-merged (op, len, 0) int32 runs in that order); splice_runs
        puts them in task order. Tasks route to the smallest size bucket
        that fits (one padded task grid per bucket); a bucket's slices are
        packed (cuda_links.link_pack), filled, walked and turned into runs
        (cuda_links.link_runs) on the device, and only its scores,
        certified mask, run counts and runs come back."""
        sc = self.sc
        dev = self.device
        n = len(la)
        la = np.asarray(la, np.int64)
        lb = np.asarray(lb, np.int64)
        resolved = np.zeros(n, bool)
        scores = np.zeros(n, np.int64)
        counts = np.zeros(n, np.int64)
        pieces = []
        d = lb - la
        base_ok = (la > 0) & (lb > 0) & (np.abs(d) <= 2 * self.B)
        assigned = np.zeros(n, bool)
        table = np.stack([np.asarray(x, np.int64) for x in (
            task_read, task_rev, ra, la, ta, lb)], axis=1)
        offs = torch.as_tensor(np.asarray(read_off, np.int64), device=dev)
        stats = self.stats
        if stats is not None:
            stats["tasks"] = stats.get("tasks", 0) + n
        timing = {} if stats is not None else None
        clock = _Clock(dev, timing)
        for RMAX in self.buckets:
            sel = np.nonzero(base_ok & ~assigned & (la <= RMAX))[0]
            assigned[base_ok & (la <= RMAX)] = True
            m = len(sel)
            if m == 0:
                continue
            # pad the task count to a power-of-two grid (vg_tpu compiles
            # one XLA program per grid; the padding is kept for parity)
            N = max(1 << int(np.ceil(np.log2(max(m, 1)))), 1024)
            tab = torch.as_tensor(table[sel].astype(np.int32), device=dev)
            a4 = cuda_links.link_pack(blob, offs, tab[:, :4].contiguous(),
                                      N=N, RMAX=RMAX)
            la_t, ta_t, lb_t = tab[:, 3], tab[:, 4], tab[:, 5]
            pad = lambda x, v: torch.cat([x, x.new_full((N - m,), v)])
            la_a, ta_a, lb_a = pad(la_t, 0), pad(ta_t, 0), pad(lb_t, 1)
            ba_a = pad(torch.clamp_max(lb_t - la_t, 0) - self.B, 0)
            clock.lap("pack")
            score, packed, n_steps, complete = self._engine(
                a4, la_a, ta_a, ba_a, lb_a, RMAX, timing=timing)
            clock.lap(None)
            cert = pad(certified(score[:m], complete[:m], la_t, lb_t, sc,
                                 self.B), False)
            cert_h = cert[:m].cpu().numpy()
            score_h = score[:m].cpu().numpy()
            clock.lap("fetch")
            if stats is not None:
                b = stats.setdefault("buckets", {}).setdefault(
                    RMAX, {"tasks": 0, "padded": 0, "certified": 0})
                b["tasks"] += m
                b["padded"] += N
                b["certified"] += int(cert_h.sum())
            if not cert_h.any():
                continue
            runs, cnt = cuda_links.link_runs(packed, n_steps, cert)
            clock.lap("runs")
            g_t = sel[cert_h]
            counts[sel] = cnt[:m].cpu().numpy()
            pieces.append((g_t, runs.cpu().numpy()))
            clock.lap("fetch")
            resolved[g_t] = True
            scores[g_t] = score_h[cert_h]
        if stats is not None:
            for k, v in timing.items():
                stats[k] = stats.get(k, 0.0) + v
        return resolved, scores, counts, pieces

    def align_runs_arrays(self, a_rows, la, ta, lb):
        """Bulk resolver form over PRE-PADDED task arrays: a_rows (n,
        LAMAX) uint8 oriented read slices (bases from LAMAX on read 0),
        la/ta/lb (n,) int. Returns (resolved bool, scores i64, runs (m,3)
        i32 forward-merged (op, len, 0) for resolved tasks concatenated in
        task order, counts i64), equal to vg_tpu's: align_runs_blob with
        each row a forward read of its own."""
        rows = np.ascontiguousarray(a_rows, np.uint8)
        n, w = rows.shape
        zero = np.zeros(n, np.int64)
        resolved, scores, counts, pieces = self.align_runs_blob(
            torch.as_tensor(rows.reshape(-1), device=self.device),
            np.arange(n + 1, dtype=np.int64) * w, np.arange(n), zero, zero,
            la, ta, lb)
        return resolved, scores, splice_runs(counts, pieces)[1], counts

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
        put = lambda x: torch.as_tensor(x, device=self.device)
        score, packed, n_steps, complete = (x.cpu().numpy() for x in (
            self._engine(put(a4.view(np.int32)), put(la_a), put(ta_a),
                         put(ba_a), put(lb_a), RMAX)))
        packed = packed.view(np.uint32)
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


def certified(score, complete, la, lb, sc, B: int):
    """The tasks whose device result is exact: complete, and scoring at
    least the escape bound, above any path that leaves the band."""
    la64, lb64 = la.to(torch.int64), lb.to(torch.int64)
    escape_ub = (sc.match * torch.minimum(la64, lb64) - 2 * sc.gap_open
                 - sc.gap_extend * ((lb64 - la64).abs() + 2 * B))
    return complete & (score >= escape_ub)


def splice_runs(counts, pieces):
    """(runs_off (n + 1,) int64, runs (m, 3) int32): the runs of n tasks in
    task order, task t's at rows runs_off[t] .. runs_off[t + 1], from
    pieces of (task ids ascending, the first counts[ids].sum() rows their
    runs in that order): one scatter of each piece's rows."""
    runs_off = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=runs_off[1:])
    out = np.zeros((int(runs_off[-1]), 3), np.int32)
    for ids, runs in pieces:
        seg = counts[ids]
        tot = int(seg.sum())
        if tot == 0:
            continue
        # run k of the piece goes to its task's offset plus its place in
        # the task: k - (the piece's runs before the task)
        shift = runs_off[ids] - (np.cumsum(seg) - seg)
        out[np.repeat(shift, seg) + np.arange(tot)] = runs[:tot]
    return runs_off, out


class _Clock:
    """With a timing dict, synchronises the device at each lap and adds
    the seconds since the last lap under its name (None: not kept)."""

    def __init__(self, dev, timing):
        self.dev = dev
        self.timing = timing
        self.t0 = time.perf_counter()

    def lap(self, name):
        if self.timing is None:
            return
        _sync(self.dev)
        t1 = time.perf_counter()
        if name is not None:
            self.timing[name] = self.timing.get(name, 0.0) + t1 - self.t0
        self.t0 = t1
