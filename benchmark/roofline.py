"""The card's peaks and the least time of each kernel's call.

Peaks of one NVIDIA H100 SXM (the card the cells run on; its power limit
goes on an earlier line of each run): 132 SMs x 4 schedulers x 32 lanes
x 1.98 GHz = 33.4 T lane operations/s, no instruction mix issuing more
than one warp instruction a scheduler a clock; HBM3 at 3.35 TB/s; float64
on 132 x 64 FP64 lanes x 1.98 GHz = 16.7 T/s.

A call's least time is the larger of its operations over the peak rate
and its bytes (each input read once, the output written once) over the
HBM rate. The counts are of the work the function needs, whatever
kernel computes it:

- the banded DP (`dp_least_seconds`): each valid (read, candidate) slot
  runs min(rlen, RL) rows of 2B + 1 band cells of the local affine
  recurrence. A cell's operations: the base pair's score, one; the
  diagonal's add, one; H's maxima over the diagonal, E, F and 0, three;
  E's two subtractions and maximum, three; F's, three; the row's best,
  one: DP_OPS_PER_CELL = 12. The card's fastest form for them is DPX on
  two 16-bit halves a lane, whose three-input forms (add-max-relu,
  max3-relu) do three of them a half: DP_OPS_PER_LANE_OP = 6, a rate of
  6 x 33.4 T recurrence operations/s that no kernel can pass.
- the MAPQ cap (`cap_least_seconds`): a frozen copy of the port's
  `ops/cuda_mapqcap.cap_work` (the function's least work: 64 int32
  operations a kmer position, the key search, the sweep's pairs and
  columns, 6 float64 operations a (column, minimizer) pair outside the
  core), the larger of its int32 operations over 33.4 T/s, its float64
  operations over 16.7 T/s and its bytes over 3.35 TB/s. Its helpers
  (quality_lengths, _minimizers, _intervals, wang_hash64 and the 64-bit
  arithmetic it rests on) are copied unchanged from
  vg_tpu_torch/ops/cuda_mapqcap.py and ops/devseed.py.
"""
from __future__ import annotations

import math

import torch

LANE_OPS_PER_S = 132 * 4 * 32 * 1.98e9     # 33.4 T lane operations/s
HBM_BYTES_PER_S = 3.35e12
FP64_PER_S = 132 * 64 * 1.98e9              # 16.7 T float64 operations/s
DP_OPS_PER_CELL = 12
DP_OPS_PER_LANE_OP = 6
M32 = 0xFFFFFFFF
INT64_MIN = -(2 ** 63)
INT64_MAX = 2 ** 63 - 1


def least_seconds(nbytes: float, ops: float, rate: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / rate)


def dp_work(reads_shape, rlen, cand_valid, band: int) -> tuple:
    """(bytes, recurrence operations) of one call of the packed DP entry:
    the reads and their reverse complements, rlen, the candidate tables
    (start, lo, hi as int32, rev and valid as bytes) read once, each
    valid slot's window of RL + 2B packed bases (half a byte a base), the
    (R, C) int32 scores written once; and each valid slot's rows of band
    cells."""
    R, RL = reads_shape
    C = cand_valid.shape[1]
    rows = rlen[:R].to(torch.int64).clamp(0, RL)
    valid = cand_valid[:R].to(torch.int64)
    slots = int(valid.sum())
    slot_rows = int((valid * rows[:, None]).sum())
    nbytes = (2 * R * RL + 4 * R + R * C * (3 * 4 + 2) + 4 * R * C
              + slots * (RL + 2 * band) / 2)
    return nbytes, slot_rows * (2 * band + 1) * DP_OPS_PER_CELL


def dp_least_seconds(reads_shape, rlen, cand_valid, band: int) -> float:
    nbytes, ops = dp_work(reads_shape, rlen, cand_valid, band)
    return least_seconds(nbytes, ops, DP_OPS_PER_LANE_OP * LANE_OPS_PER_S)


def cap_least_seconds(codes2d, rlen, quals, qoff, keys, k: int,
                      w: int) -> float:
    nbytes, int_ops, f64 = cap_work(codes2d, rlen, quals, qoff, keys, k=k,
                                    w=w)
    return max(nbytes / HBM_BYTES_PER_S, int_ops / LANE_OPS_PER_S,
               f64 / FP64_PER_S)


# ------------------------------------------------------------------
# frozen copy: vg_tpu_torch/ops/devseed.py

def _add64(ah, al, bh, bl):
    lo = (al + bl) & M32
    carry = (lo < al).to(ah.dtype)
    return (ah + bh + carry) & M32, lo


def _shl64(h, l, s: int):
    if s == 0:
        return h, l
    if s >= 32:
        return ((l << (s - 32)) & M32) if s > 32 else l, torch.zeros_like(l)
    return ((h << s) | (l >> (32 - s))) & M32, (l << s) & M32


def _shr64(h, l, s: int):
    if s == 0:
        return h, l
    if s >= 32:
        return torch.zeros_like(h), (h >> (s - 32)) if s > 32 else h
    return h >> s, ((l >> s) | (h << (32 - s))) & M32


def wang_hash64(h, l):
    """wang_hash (native/vgtpu_host.cpp:17) on (hi, lo) uint32 pairs held
    in int64 tensors."""
    nh, nl = h ^ M32, l ^ M32
    sh, sl = _shl64(h, l, 21)
    h, l = _add64(nh, nl, sh, sl)
    rh, rl = _shr64(h, l, 24)
    h, l = h ^ rh, l ^ rl
    s3h, s3l = _shl64(h, l, 3)
    s8h, s8l = _shl64(h, l, 8)
    th, tl = _add64(h, l, s3h, s3l)
    h, l = _add64(th, tl, s8h, s8l)
    rh, rl = _shr64(h, l, 14)
    h, l = h ^ rh, l ^ rl
    s2h, s2l = _shl64(h, l, 2)
    s4h, s4l = _shl64(h, l, 4)
    th, tl = _add64(h, l, s2h, s2l)
    h, l = _add64(th, tl, s4h, s4l)
    rh, rl = _shr64(h, l, 28)
    h, l = h ^ rh, l ^ rl
    sh, sl = _shl64(h, l, 31)
    return _add64(h, l, sh, sl)



# frozen copy: vg_tpu_torch/ops/cuda_mapqcap.py

def quality_lengths(qoff, Q: int):
    """(start, length) of each read's quality bytes, the offsets cut to
    0 .. Q as the kernel cuts them."""
    qa = qoff[:-1].clamp(0, Q)
    return qa, torch.maximum(qoff[1:].clamp(max=Q), qa) - qa


def _minimizers(codes2d, rlen, keys, k: int, w: int) -> dict:
    """(a) and (b) for every read: the kept minimizers, sorted by
    (agg_end, agg_start) in offset order, as (R, nmax) tensors off, ast,
    aend, hf (float(hash)) and the count n (R,)."""
    dev = codes2d.device
    i64 = torch.int64
    R, L = codes2d.shape
    m = L - k + 1
    c = codes2d.to(i64)
    ok = c < 4
    c2 = torch.where(ok, c, 0)
    fwd = torch.zeros((R, m), dtype=i64, device=dev)
    rev = torch.zeros((R, m), dtype=i64, device=dev)
    for j in range(k):
        sl = c2[:, j : j + m]
        fwd |= sl << (2 * (k - 1 - j))
        rev |= (3 - sl) << (2 * j)
    nbad = torch.zeros((R, L + 1), dtype=i64, device=dev)
    nbad[:, 1:] = torch.cumsum((~ok).to(i64), 1)
    pos = torch.arange(m, device=dev)
    m_r = (rlen.to(i64).clamp(max=L) - k + 1).clamp(min=0)
    valid = ((nbad[:, k:] - nbad[:, :-k]) == 0) & (pos < m_r[:, None])
    key = torch.minimum(fwd, rev)
    hh, hl = wang_hash64(key >> 32, key & M32)
    # the unsigned order of the hash as a signed int64; ~0 -> INT64_MAX
    h = torch.where(valid, (hh - 2 ** 31) * 2 ** 32 + hl, INT64_MAX)
    w_eff = torch.minimum(torch.full_like(m_r, w), m_r)[:, None]
    nw = m_r[:, None] - w_eff + 1
    fill = torch.full((R, w), INT64_MAX, dtype=i64, device=dev)
    hpad = torch.cat([h, fill], 1)
    mins = h.clone()
    for j in range(1, w):
        mins = torch.where(j < w_eff, torch.minimum(mins, hpad[:, j : j + m]),
                           mins)
    mpad = torch.cat([fill, mins], 1)
    first = torch.full((R, m), m, dtype=i64, device=dev)
    last = torch.full((R, m), -1, dtype=i64, device=dev)
    for j in range(w):
        t = pos - j
        hit = ((j < w_eff) & (t >= 0) & (t < nw)
               & (mpad[:, w - j : w - j + m] == h))
        first = torch.where(hit, torch.minimum(first, t), first)
        last = torch.where(hit, torch.maximum(last, t), last)
    keep = (last >= 0) & valid
    if keys.numel():
        kf = keys ^ INT64_MIN
        q = key ^ INT64_MIN
        at = torch.searchsorted(kf, q).clamp(max=keys.numel() - 1)
        keep &= kf[at] == q
    else:
        keep = torch.zeros_like(keep)
    aend = last + w_eff - 1 + k
    sort_key = torch.where(keep, aend * (L + 1) + first, INT64_MAX)
    order = torch.sort(sort_key, dim=1, stable=True).indices
    n = keep.sum(1)
    nmax = max(int(n.max()) if R else 0, 1)
    order = order[:, :nmax]
    g = lambda x: torch.gather(x, 1, order)
    hf = hh.to(torch.float64) * 2.0 ** 32 + hl.to(torch.float64)
    return dict(off=order, ast=g(first), aend=g(aend), hf=g(hf), n=n)


def _intervals(mn: dict, qlen) -> dict:
    """(c)'s sweep for every read with a quality and a kept minimizer, in
    lockstep: each step moves each read's state machine by one interval
    or one push. Returns the reads swept (rows) and their intervals in
    sweep order: row (index into rows), left, right, bottom, top."""
    dev = qlen.device
    i64 = torch.int64
    rows = torch.nonzero((mn["n"] > 0) & (qlen > 0)).flatten()
    ast, aend = mn["ast"][rows], mn["aend"][rows]
    n, nq = mn["n"][rows], qlen.to(i64)[rows]
    Rr = rows.numel()
    nmax = ast.shape[1]
    at = lambda x, i: torch.gather(x, 1, i.clamp(max=nmax - 1)[:, None])[:, 0]
    j = torch.ones(Rr, dtype=i64, device=dev)
    bottom = torch.zeros(Rr, dtype=i64, device=dev)
    size = torch.ones(Rr, dtype=i64, device=dev)
    left = ast[:, 0] if Rr else torch.zeros(0, dtype=i64, device=dev)
    done = torch.zeros(Rr, dtype=torch.bool, device=dev)
    steps = []
    while Rr and not bool(done.all()):
        right = torch.where(j < n, at(ast, j), nq)
        go = ~done & (left < right)
        top_end = at(aend, bottom)
        pop = go & (top_end <= right)
        end = torch.where(pop, top_end, right)
        steps.append((go & (left < end), left, end, bottom, bottom + size))
        left = torch.where(pop, torch.where(size == 1, right, top_end),
                           torch.where(go, right, left))
        bottom = bottom + pop.long()
        size = size - pop.long()
        idle = ~done & ~go
        push = idle & (j < n)
        j = j + push.long()
        size = size + push.long()
        done = done | (idle & ~push)
    if not steps:
        z = torch.zeros(0, dtype=i64, device=dev)
        return dict(rows=rows, row=z, left=z, right=z, bottom=z, top=z)
    emit = torch.stack([s[0] for s in steps], 1)          # (Rr, T)
    pick = lambda i: torch.stack([s[i] for s in steps], 1)[emit]
    row = torch.arange(Rr, device=dev)[:, None].expand_as(emit)[emit]
    return dict(rows=rows, row=row, left=pick(1), right=pick(2),
                bottom=pick(3), top=pick(4))


# The function's least integer work a kmer position, in int32 operations
# (the card has no 64-bit integer unit: a 64-bit operation is counted as
# two): a rolling canonical kmer, one base in, 20 (the N-run count 2, the
# forward kmer's shift, or and mask 6, the reverse's shift, complement,
# shift and or 8, the canonical min 4); wang_hash_64, 38 (its 19 64-bit
# operations); the window minima with each kmer's first and last window,
# 6 (a monotone queue, amortized: a push and a pop's 64-bit compares, the
# first/last update)
ROLL_OPS, HASH_OPS, WINDOW_OPS = 20, 38, 6
SEARCH_OPS_PER_STEP = 3    # a binary-search step: load, compare, select
# float64 operations: a (column, minimizer) pair outside the minimizer's
# core (p_beat 2, 1 - p_beat 1, pow 1, 1 - pow 1, the product 1), a
# column (its phred, the fold 3), an interval (log10 1, the add 1), a DP
# update (the compare 1)
F64_PER_PAIR, F64_PER_COLUMN, F64_PER_INTERVAL, F64_PER_UPDATE = 6, 4, 2, 1
# int32-equivalent operations of the sweep: a (column, minimizer) pair
# (the core test 3, possible 5), an interval step of the state machine 12
INT_PER_PAIR, INT_PER_STEP = 8, 12


def cap_work(codes2d, rlen, quals, qoff, keys, *, k: int, w: int) -> tuple:
    """(bytes, int ops, float64 ops) one mapq_cap call needs on these
    inputs: each read's codes and quality bytes, rlen and qoff, a key
    read for each kept minimizer (at most the whole key set: the port's
    count reads it all, which would make the bound grow with the graph,
    not with the call), the caps written once; the operations
    above, counted on the
    sweep these inputs take (the plain version's intervals and groups,
    the pairs inside a minimizer's core left out of the float64 count).
    The kernel does more (it finds each kmer's windows by scanning up to
    w - 1 hashes on each side, and builds each lane's first kmer from its
    k bases); the bound counts what the function needs."""
    R, L = codes2d.shape
    rl = rlen.to(torch.int64).clamp(0, L)
    ql = quality_lengths(qoff, quals.numel())[1]
    nbytes = (int(rl[ql > 0].sum()) + int(ql.sum()) + 4 * R + 8 * (R + 1)
              + 8 * R)
    positions = int((rl - k + 1).clamp(min=0)[ql > 0].sum())
    int_ops = positions * (ROLL_OPS + HASH_OPS + WINDOW_OPS)
    if R == 0 or L < k:
        return nbytes, int_ops, 0
    mn = _minimizers(codes2d, rlen, keys, k, w)
    kept = int(mn["n"][ql > 0].sum())
    nbytes += 8 * min(kept, keys.numel())
    int_ops += kept * SEARCH_OPS_PER_STEP * max(
        math.ceil(math.log2(keys.numel() + 1)), 1)
    iv = _intervals(mn, ql)
    width = iv["right"] - iv["left"]
    group = iv["top"] - iv["bottom"]
    # the columns of each (interval, member) pair inside the member's core
    core = torch.zeros_like(width)
    nmax = mn["off"].shape[1]
    off = mn["off"][iv["rows"]].reshape(-1)
    for g in range(int(group.max()) if group.numel() else 0):
        o = off[iv["row"] * nmax + (iv["bottom"] + g).clamp(max=nmax - 1)]
        inside = (torch.minimum(iv["right"], o + k)
                  - torch.maximum(iv["left"], o)).clamp(min=0)
        core += torch.where(g < group, inside, 0)
    pairs = int((width * group).sum())
    f64 = ((pairs - int(core.sum())) * F64_PER_PAIR
           + int(width.sum()) * F64_PER_COLUMN
           + width.numel() * F64_PER_INTERVAL
           + int(group.sum()) * F64_PER_UPDATE)
    int_ops += pairs * INT_PER_PAIR + width.numel() * INT_PER_STEP
    return nbytes, int_ops, f64
