"""The explored-minimizer MAPQ cap of a batch of reads: a CUDA kernel and
its plain version.

vg_tpu computes the cap on the host, a read at a time in Python
(vg_tpu/map/mapqcap.py:94-171, explored_cap and faster_cap, from
GiraffeMapper.apply_mapq_caps); no Pallas kernel. `mapq_cap` computes it
for every read of a batch in one call: CUDA tensors launch the kernel of
csrc/mapq_cap.cu (CUDA C++ for sm_90a; counted in `mapq_cap.launches`),
CPU tensors run `mapq_cap_ref`, its plain PyTorch version. The device of
the tensors decides, nothing falls back. The source note says what the
kernel computes, step by step, and how it is laid out.

Exactness. Both follow the copy's float64 operations in its order: the
phred probabilities from PHRED, a table made with Python's ** (the copy's
own bits); float(hash) as one rounding ((hi, lo) halves here: hi 2^32 + lo
in float64); the columns of an interval folded left to right; the strict
DP update. pow and log10 are the library's (glibc's in numpy, SLEEF's or
the C library's in torch on the CPU, CUDA's on the card), so a cap may
differ from the copy's in its last bits: the tests hold caps to 1e-9 phred
and the rounded MAPQ exactly. Where the copy raises IndexError (its sweep
reads a quality column at or past the quality's length: a quality shorter
than its read), the cap is NaN.

The plain version runs the reads side by side: the minimizers and the
filter as (R, m) tensors; the sweep as one state machine stepped for all
reads at once, an interval a read a step; the intervals' column products
as (intervals, columns) tensors; the DP an interval a read a step.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import cuda_build
from .cuda_align import _check
from .cuda_seed import _cuda_or_cpu
from .devseed import M32, wang_hash64

_SRC = cuda_build.PKG / "csrc" / "mapq_cap.cu"
# kmer positions of the widest read whose scratch (SCRATCH_BYTES a
# position, + 8) lies in shared memory (24,584 bytes a block); a read with
# more takes it from a global buffer
SMEM_POSITIONS = 512
SCRATCH_BYTES = 48
MAX_K = 31
# 10^(-q/10) for every uint8 phred, as the copy computes it
PHRED = [10.0 ** (-float(q) / 10.0) for q in range(256)]
INT64_MIN = -(2 ** 63)
INT64_MAX = 2 ** 63 - 1
_CHUNK = 1 << 12           # intervals a step of the plain column products

_lib = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()   # two emitter threads launch at once
_phred_dev: dict = {}            # device -> the PHRED tensor on it
build_info: dict = {}      # path, seconds, ptxas report of the last build

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """Build (once per source/flags hash) and load the kernel library.
    Raises on any build or load failure."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = cuda_build.build(_SRC, build_info)
        lib.mapq_cap.restype = _I
        lib.mapq_cap.argtypes = ([_I, _P, _I, _I, _P, _P, _I, _P, _P,
                                  ctypes.c_longlong, _P, _I, _I, _I, _P, _P,
                                  _P, _P])
        _lib = lib
        return _lib


def _phred_table(dev: torch.device) -> torch.Tensor:
    with _lib_lock:
        if dev not in _phred_dev:
            _phred_dev[dev] = torch.tensor(PHRED, dtype=torch.float64,
                                           device=dev)
        return _phred_dev[dev]


def _check_inputs(codes2d, rlen, quals2d, qlen, keys, k, w) -> tuple:
    if codes2d.dim() != 2 or quals2d.dim() != 2 or keys.dim() != 1:
        raise ValueError("mapq_cap: codes2d and quals2d must be 2-D, keys "
                         "1-D")
    if not (1 <= k <= MAX_K and w >= 1):
        raise ValueError(f"mapq_cap: k must lie in 1..{MAX_K} and w be "
                         f"positive, not k={k}, w={w}")
    dev = codes2d.device
    R, L = codes2d.shape
    _check(codes2d, "mapq_cap: codes2d", torch.uint8, (R, L), dev)
    _check(rlen, "mapq_cap: rlen", torch.int32, (R,), dev)
    _check(quals2d, "mapq_cap: quals2d", torch.uint8,
           (R, quals2d.shape[1]), dev)
    _check(qlen, "mapq_cap: qlen", torch.int32, (R,), dev)
    _check(keys, "mapq_cap: keys", torch.int64, keys.shape, dev)
    return R, L


def mapq_cap(codes2d, rlen, quals2d, qlen, keys, *, k: int, w: int):
    """The explored-minimizer MAPQ cap of R reads: codes2d (R, L) uint8
    read codes (0-4; rlen[r] of row r are the read's), rlen (R,) int32,
    quals2d (R, LQ) uint8 phred (qlen[r] of row r; 0 for a read without a
    quality), qlen (R,) int32, keys (K,) int64 the uint64 bits of the
    index's minimizer keys that occur (MinimizerIndex.count > 0), sorted
    as unsigned. Returns (R,) float64: explored_cap(codes, quals, k, w,
    count_fn=index.count) of each read, +inf where it is +inf (no quality,
    no kept minimizer, no finite cap), NaN where it raises IndexError.
    Reads of any length: on the card, a batch with a row of more than
    SMEM_POSITIONS kmer positions gives the reads that have more (and a
    quality) scratch in global memory, sized on the host after one sync
    of the current stream."""
    if not _cuda_or_cpu(codes2d, "mapq_cap"):
        return mapq_cap_ref(codes2d, rlen, quals2d, qlen, keys, k=k, w=w)
    R, L = _check_inputs(codes2d, rlen, quals2d, qlen, keys, k, w)
    dev = codes2d.device
    cap = torch.empty(R, dtype=torch.float64, device=dev)
    if R == 0:
        return cap
    smem_pos, ws_off, total = scratch_plan(rlen, qlen, L, k)
    ws = (None if ws_off is None
          else torch.empty(total, dtype=torch.uint8, device=dev))
    phred = _phred_table(dev)
    index, stream = cuda_build.launch_args(codes2d)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = library().mapq_cap(
        index, codes2d.data_ptr(), R, L, rlen.data_ptr(), quals2d.data_ptr(),
        quals2d.shape[1], qlen.data_ptr(), keys.data_ptr(), keys.shape[0],
        phred.data_ptr(), k, w, smem_pos, ptr(ws_off), ptr(ws),
        cap.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mapq_cap launch failed: CUDA error {err}")
    with _count_lock:
        mapq_cap.launches += 1
    return cap


mapq_cap.launches = 0


def scratch_plan(rlen, qlen, L: int, k: int) -> tuple:
    """Where each read's scratch lies: (smem_pos, ws_off, total). Reads
    of at most smem_pos kmer positions use shared memory; a read with more
    and a quality has SCRATCH_BYTES m + 8 bytes from ws_off[r] of a
    global buffer of total bytes. A batch whose rows all fit (L - k + 1 <=
    SMEM_POSITIONS) needs no buffer: (L - k + 1, None, 0) without reading
    rlen; otherwise smem_pos is the widest read that fits, and the plan
    costs one sync of the current stream."""
    smem_pos = max(L - k + 1, 0)
    if smem_pos <= SMEM_POSITIONS:
        return smem_pos, None, 0
    m = (rlen.to(torch.int64).clamp(0, L) - k + 1).clamp(min=0)
    m = torch.where(qlen > 0, m, 0)
    wide = m > SMEM_POSITIONS
    need = torch.where(wide, SCRATCH_BYTES * m + 8, 0)
    total, smem_pos = torch.stack(
        [need.sum(), torch.where(wide, 0, m).max()]).tolist()
    return smem_pos, torch.cumsum(need, 0) - need, total


# ---------------------------------------------------------- plain version

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


def _interval_logs(mn: dict, iv: dict, quals2d, k: int):
    """log10 of each interval's probability (-inf where it is 0): each
    column's product over the group in order, then the columns folded
    left to right. The intervals go in chunks of like width."""
    dev = quals2d.device
    f64 = torch.float64
    phred = _phred_table(dev)
    I = iv["row"].numel()
    out = torch.empty(I, dtype=f64, device=dev)
    LQ = quals2d.shape[1]
    nmax = mn["off"].shape[1]
    flat = {x: mn[x][iv["rows"]].reshape(-1)
            for x in ("off", "ast", "aend", "hf")}
    by_width = torch.argsort(iv["right"] - iv["left"])
    for a in range(0, I, _CHUNK):
        sel = by_width[a : a + _CHUNK]
        row, left, right = iv["row"][sel], iv["left"][sel], iv["right"][sel]
        bottom, top = iv["bottom"][sel], iv["top"][sel]
        W = int((right - left).max())
        G = int((top - bottom).max())
        cols = left[:, None] + torch.arange(W, device=dev)
        act = cols < right[:, None]
        q = quals2d[iv["rows"][row][:, None], cols.clamp(max=LQ - 1)]
        cp = phred[q.to(torch.int64)]
        for g in range(G):
            at = row * nmax + (bottom + g).clamp(max=nmax - 1)
            off, st, en, hf = (flat[x][at][:, None]
                               for x in ("off", "ast", "aend", "hf"))
            core = (off <= cols) & (cols < off + k)
            possible = torch.minimum(torch.minimum(
                torch.full_like(cols, k), cols - st + 1), en - cols)
            p_beat = (hf * 2.0 ** -64).clamp(max=1.0)
            miss = torch.pow(1.0 - p_beat, possible.clamp(min=0).to(f64))
            use = ((bottom + g) < top)[:, None] & ~core
            cp = torch.where(use, cp * (1.0 - miss), cp)
        p = cp[:, 0]
        for t in range(1, W):
            x = cp[:, t]
            p = torch.where(act[:, t], p + x - p * x, p)
        out[sel] = torch.where(p > 0, torch.log10(p), -math.inf)
    return out


def mapq_cap_ref(codes2d, rlen, quals2d, qlen, keys, *, k: int, w: int):
    """Plain PyTorch version of mapq_cap (same arguments and result)."""
    R, L = _check_inputs(codes2d, rlen, quals2d, qlen, keys, k, w)
    dev = codes2d.device
    f64 = torch.float64
    cap = torch.full((R,), math.inf, dtype=f64, device=dev)
    if R == 0 or L < k:
        return cap
    LQ = quals2d.shape[1]
    qlen = qlen.to(torch.int64).clamp(max=LQ)
    mn = _minimizers(codes2d, rlen, keys, k, w)
    iv = _intervals(mn, qlen)
    rows, row = iv["rows"], iv["row"]
    if row.numel() == 0:              # no interval: each c[n] stays -inf
        return cap
    here = _interval_logs(mn, iv, quals2d, k)
    Rr = rows.numel()
    # the DP: each read's intervals in order (row is sorted), a step each
    bad = torch.zeros(Rr, dtype=torch.bool, device=dev)
    bad[row[iv["right"] > qlen[rows][row]]] = True
    seq = torch.arange(row.numel(), device=dev) - torch.searchsorted(row, row)
    S = int(seq.max()) + 1
    n = mn["n"][rows]
    nmax = mn["off"].shape[1]
    c = torch.full((Rr, nmax + 1), -math.inf, dtype=f64, device=dev)
    c[:, 0] = 0.0
    col = torch.arange(nmax + 1, device=dev)
    grid = lambda x, fill: torch.full((Rr, S), fill, dtype=x.dtype,
                                      device=dev).index_put_((row, seq), x)
    has = grid(torch.ones_like(row, dtype=torch.bool), False)
    B, T, H = grid(iv["bottom"], 0), grid(iv["top"], 0), grid(here, 0.0)
    for s in range(S):
        b, t = B[:, s : s + 1], T[:, s : s + 1]
        val = torch.gather(c, 1, b) + H[:, s : s + 1]
        upd = has[:, s : s + 1] & (col > b) & (col <= t) & (c < val)
        c = torch.where(upd, val, c)
    last = torch.gather(c, 1, n[:, None])[:, 0]
    out = torch.where(torch.isfinite(last), -10.0 * last, math.inf)
    cap[rows] = torch.where(bad, math.nan, out)
    return cap


# ---------------------------------------------------------------- work

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


def cap_work(codes2d, rlen, quals2d, qlen, keys, *, k: int, w: int) -> tuple:
    """(bytes, int ops, float64 ops) one mapq_cap call needs on these
    inputs: each read's codes and quality bases, rlen and qlen, the keys
    once, the caps written once; the operations above, counted on the
    sweep these inputs take (the plain version's intervals and groups,
    the pairs inside a minimizer's core left out of the float64 count).
    The kernel does more (it rebuilds each kmer from its k bases and
    rescans each window); the bound counts what the function needs."""
    R, L = codes2d.shape
    rl = rlen.to(torch.int64).clamp(0, L)
    ql = qlen.to(torch.int64).clamp(0, quals2d.shape[1])
    nbytes = (int(rl[ql > 0].sum()) + int(ql.sum()) + 8 * R
              + 8 * keys.numel() + 8 * R)
    positions = int((rl - k + 1).clamp(min=0)[ql > 0].sum())
    int_ops = positions * (ROLL_OPS + HASH_OPS + WINDOW_OPS)
    if R == 0 or L < k:
        return nbytes, int_ops, 0
    mn = _minimizers(codes2d, rlen, keys, k, w)
    kept = int(mn["n"][ql > 0].sum())
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
