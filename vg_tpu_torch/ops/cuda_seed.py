"""Device-side seeding kernels: CUDA C++ kernels and their plain versions.

The counterpart of vg_tpu/ops/pallas_seed.py on the H100. The kernels in
csrc/seed_kernels.cu (CUDA C++ for sm_90a) replace the TPU kernels
_softcap_kernel (a warp per row, instantiated for 4, 8, 16 or 32 columns
a lane by mpad), _cluster_kernel (two kernels: a warp per row, and a
block per row for rows of more than CLUSTER_WARP_T valid seeds) and
_argsort_kernel; the source note says what bounds each and why it is
built as it is.

Each wrapper takes the arguments of its JAX counterpart and returns the
same arrays. CUDA tensors launch the kernel (counted in `<wrapper>.launches`)
or raise; CPU tensors run the plain PyTorch version (`<wrapper>_ref`) —
the device of the tensors decides, nothing falls back. The one route that
depends on a shape is argsort_i32 above ARGSORT_MAX_N keys, which sorts
with torch.argsort as the JAX function sorts with XLA above its own limit.

Exactness: the kernels and the plain versions add float32 scores with
vg_tpu's Hillis-Steele tree, so prefix sums agree term for term. Row totals
are summed in another order; they are exact when the scores are multiples
of 1/256 (index/minimizer.minimizer_score_table, the path's scores), and
the comparisons of kernel, plain version and vg_tpu are exact there.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build

_SRC = cuda_build.PKG / "csrc" / "seed_kernels.cu"
I32MAX = 2**31 - 1
ARGSORT_MAX_N = 16384      # keys one argsort block sorts
CLUSTER_MAX_S = 4096       # seed slots a cluster block holds
CLUSTER_WARP_T = 128       # valid seeds a row may hold on the warp path

_lib = None
_lib_lock = threading.Lock()
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
        lib.seed_softcap.restype = _I
        lib.seed_softcap.argtypes = ([_I] + [_P] * 6 + [_I] * 3
                                     + [ctypes.c_float] + [_P] * 7)
        lib.seed_cluster.restype = _I
        lib.seed_cluster.argtypes = [_I] + [_P] * 4 + [_I] * 4 + [_P] * 6
        lib.seed_argsort.restype = _I
        lib.seed_argsort.argtypes = [_I, _P, _I, _P, _P]
        lib.seed_cluster_warp_t.restype = _I
        lib.seed_attr_sets.restype = _I
        lib.seed_softcap_launches.restype = ctypes.c_longlong
        lib.seed_softcap_launches.argtypes = [_I]
        if lib.seed_cluster_warp_t() != CLUSTER_WARP_T:
            raise RuntimeError(
                f"seed_kernels.cu keeps rows of up to "
                f"{lib.seed_cluster_warp_t()} seeds on the warp path, "
                f"cuda_seed.CLUSTER_WARP_T says {CLUSTER_WARP_T}")
        _lib = lib
        return _lib


def attribute_sets() -> int:
    """Dynamic shared-memory attributes the library has set: once per
    device and kernel, at the first launch on the device."""
    return library().seed_attr_sets()


def softcap_launches_by_items() -> dict:
    """Launches of the soft-cap kernel so far by its columns a lane
    (mpad / 32: 4, 8, 16 or 32), counted by the library's C entry."""
    lib = library()
    return {e: int(lib.seed_softcap_launches(e)) for e in (4, 8, 16, 32)}


def pow2_ge(x: int) -> int:
    n = 1
    while n < x:
        n *= 2
    return n


def _contig(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype).contiguous()


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _cuda_or_cpu(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def _hs_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along dim 1 with vg_tpu's Hillis-Steele tree
    (pallas_seed._prefix_sum): step d adds x[p - d], or 0 below d."""
    S = x.shape[1]
    d = 1
    while d < S:
        x = x + torch.cat([torch.zeros_like(x[:, :d]), x[:, :-d]], 1)
        d *= 2
    return x


# ------------------------------------------------------ soft-cap select

def softcap_compact(mscore, keep, cheap, hs, cnt, cr, *,
                    score_fraction: float):
    """Soft hit-cap minimizer selection + compaction (reference policy:
    src/minimizer_mapper.cpp:4349-4360), vg_tpu's softcap_compact.
    Inputs (R, m): mscore f32 (0 where not kept), keep/cheap bool, hs/cnt/cr
    int32. Returns (pos, hs, cnt, cr, score, take), each (R, mpad) with
    mpad = pow2_ge(max(m, 128)): the taken minimizers first in read-position
    order, then the rest in position order; slice [:, :M] for M slots."""
    if not _cuda_or_cpu(mscore, "softcap_compact"):
        return softcap_compact_ref(mscore, keep, cheap, hs, cnt, cr,
                                   score_fraction=score_fraction)
    R, m = mscore.shape
    mpad = pow2_ge(max(m, 128))
    if mpad > 1024:
        raise ValueError(f"softcap_compact: the kernel takes m <= 1024 "
                         f"minimizer positions, not {m}")
    dev = mscore.device
    ins = [_contig(mscore, torch.float32), _contig(keep, torch.bool),
           _contig(cheap, torch.bool), _contig(hs, torch.int32),
           _contig(cnt, torch.int32), _contig(cr, torch.int32)]
    for t in ins:
        if t.device != dev or tuple(t.shape) != (R, m):
            raise ValueError(f"softcap_compact: inputs must be ({R}, {m}) "
                             f"on {dev}")
    outs = [torch.empty((R, mpad), dtype=torch.int32, device=dev)
            for _ in range(4)]
    outs.append(torch.empty((R, mpad), dtype=torch.float32, device=dev))
    outs.append(torch.empty((R, mpad), dtype=torch.int32, device=dev))
    index, stream = cuda_build.launch_args(mscore)
    err = library().seed_softcap(
        index, *(t.data_ptr() for t in ins), R, m, mpad,
        float(score_fraction), *(t.data_ptr() for t in outs), stream)
    _raise_on(err, "seed_softcap")
    softcap_compact.launches += 1
    return tuple(outs)


softcap_compact.launches = 0


def softcap_compact_ref(mscore, keep, cheap, hs, cnt, cr, *,
                        score_fraction: float):
    """Plain PyTorch version of the kernel: a stable sort by descending
    score (zeros of either sign tie, as float compares do), the two
    Hillis-Steele exclusive sums, the float32 budget test, and a scatter
    that puts the taken columns first."""
    R, m = mscore.shape
    mpad = pow2_ge(max(m, 128))
    dev = mscore.device

    def pad(a, dt):
        out = torch.zeros((R, mpad), dtype=dt, device=dev)
        out[:, :m] = a.to(dt)
        return out

    ms = pad(mscore, torch.float32)
    kp = pad(keep, torch.bool)
    ch = pad(cheap, torch.bool)
    col = torch.arange(mpad, device=dev).expand(R, mpad)
    key = torch.where(ms == 0, torch.zeros_like(ms), -ms)
    order = torch.sort(key, dim=1, stable=True).indices
    ms_s = torch.gather(ms, 1, order)
    kp_s = torch.gather(kp, 1, order)
    ch_s = torch.gather(ch, 1, order)
    zero = torch.zeros_like(ms_s)
    cheapv = torch.where(kp_s & ch_s, ms_s, zero)
    expv = torch.where(kp_s & ~ch_s, ms_s, zero)
    csum = _hs_scan(cheapv) - cheapv
    esum = _hs_scan(expv) - expv
    budget = torch.tensor(score_fraction, dtype=torch.float32,
                          device=dev) * ms.sum(dim=1, keepdim=True)
    take_s = kp_s & (ch_s | (csum + esum < budget))
    take = torch.zeros_like(take_s).scatter(1, order, take_s)
    ti = take.to(torch.int64)
    before = torch.cumsum(ti, dim=1) - ti
    ntake = ti.sum(dim=1, keepdim=True)
    slot = torch.where(take, before, ntake + col - before)

    def put(a):
        return torch.empty_like(a).scatter(1, slot, a)

    return (put(col.to(torch.int32)), put(pad(hs, torch.int32)),
            put(pad(cnt, torch.int32)), put(pad(cr, torch.int32)),
            put(ms), put(take.to(torch.int32)))


def softcap_work(R: int, m: int) -> tuple:
    """(bytes, operations) one softcap_compact call needs: every input
    read once (f32 score, two bool flags, three int32 columns), the six
    (R, mpad) outputs written once; operations for a comparison sort of
    the m scores (m * ceil(log2 m) compares), the two prefix sums, the
    budget test and the compaction scan (about 6 per column)."""
    mpad = pow2_ge(max(m, 128))
    nbytes = R * m * (4 + 1 + 1 + 3 * 4) + R * mpad * 6 * 4
    log2m = max((m - 1).bit_length(), 1)
    return nbytes, R * m * (log2m + 6)


# -------------------------------------------------------- cluster top-C

def cluster_topc(strandk, diagk, ok, score, *, band_radius: int,
                 max_candidates: int):
    """Seeds -> (strand, diagonal) clustering -> top-C candidates,
    vg_tpu's cluster_topc. Inputs (R, S), S a power of two: strandk int32
    (0 fwd / 1 rev / 2 invalid), diagk int32, ok int32 read offsets, score
    f32. Returns (cand_diag, cand_rev, cand_valid), each (R, C): int32,
    int32, bool. On the card one call is two launches: the warp kernel
    takes the rows of up to CLUSTER_WARP_T valid seeds and lists the
    others, which the block kernel then takes; the card's running count of
    those rows is read by block_rows_read()."""
    if not _cuda_or_cpu(strandk, "cluster_topc"):
        return cluster_topc_ref(strandk, diagk, ok, score,
                                band_radius=band_radius,
                                max_candidates=max_candidates)
    R, S = strandk.shape
    C = max_candidates
    if S & (S - 1) or S > CLUSTER_MAX_S:
        raise ValueError(f"cluster_topc: the kernel takes a power of two "
                         f"<= {CLUSTER_MAX_S} seed slots, not {S}")
    dev = strandk.device
    ins = [_contig(strandk, torch.int32), _contig(diagk, torch.int32),
           _contig(ok, torch.int32), _contig(score, torch.float32)]
    for t in ins:
        if t.device != dev or tuple(t.shape) != (R, S):
            raise ValueError(f"cluster_topc: inputs must be ({R}, {S}) "
                             f"on {dev}")
    cdiag = torch.empty((R, C), dtype=torch.int32, device=dev)
    crev = torch.empty((R, C), dtype=torch.int32, device=dev)
    cvalid = torch.empty((R, C), dtype=torch.bool, device=dev)
    overflow = torch.empty(R + 1, dtype=torch.int32, device=dev)
    index, stream = cuda_build.launch_args(strandk)
    err = library().seed_cluster(
        index, *(t.data_ptr() for t in ins), R, S, C, int(band_radius),
        cdiag.data_ptr(), crev.data_ptr(), cvalid.data_ptr(),
        overflow.data_ptr(), _block_rows_counter(dev).data_ptr(), stream)
    _raise_on(err, "seed_cluster")
    cluster_topc.launches += 1
    return cdiag, crev, cvalid


cluster_topc.launches = 0
cluster_topc.block_rows = 0
_block_rows = {}           # card index -> int64 count of block-path rows


def _block_rows_counter(dev: torch.device) -> torch.Tensor:
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    with _lib_lock:
        if index not in _block_rows:
            _block_rows[index] = torch.zeros(
                1, dtype=torch.int64, device=torch.device("cuda", index))
        return _block_rows[index]


def block_rows_read() -> int:
    """Rows the block path of cluster_topc took since the last reset, over
    all cards; also stored in cluster_topc.block_rows. Copies the cards'
    counters to the host: call it after the work it counts, never on a
    mapping path."""
    with _lib_lock:
        counters = list(_block_rows.values())
    cluster_topc.block_rows = sum(int(c.item()) for c in counters)
    return cluster_topc.block_rows


def block_rows_reset() -> None:
    """Zero the cards' counters of block-path rows and the attribute."""
    with _lib_lock:
        for c in _block_rows.values():
            c.zero_()
    cluster_topc.block_rows = 0


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 two's complement (JAX's int32
    arithmetic wraps)."""
    return ((x + 2**31) & 0xFFFFFFFF) - 2**31


def cluster_topc_ref(strandk, diagk, ok, score, *, band_radius: int,
                     max_candidates: int):
    """Plain PyTorch version: the reference's two sorts as sorts of one
    int64 key each, its break / cluster-id / middle / distinct-offset
    steps as cumulative ops, the Hillis-Steele score scan, and its C
    rounds of first-maximum selection."""
    R, S = strandk.shape
    C = max_candidates
    dev = strandk.device
    i64 = torch.int64
    col = torch.arange(S, device=dev).expand(R, S)
    st = strandk.to(i64)
    key1 = (st << 48) | ((diagk.to(i64) + 2**31) << 16) | col
    o1 = torch.sort(key1, dim=1).indices
    strand1 = torch.gather(st, 1, o1)
    diag1 = torch.gather(diagk.to(i64), 1, o1)
    off1 = torch.gather(ok.to(i64), 1, o1)
    sc1 = torch.gather(score.to(torch.float32), 1, o1)
    valid1 = strand1 < 2
    nvalid = valid1.sum(dim=1, keepdim=True)

    def shift_down(x, fill):
        return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], 1)

    brk = ((col == 0) | (strand1 != shift_down(strand1, -1))
           | (_wrap32(diag1 - shift_down(diag1, 0)) > 2 * band_radius))
    new_c = brk & valid1
    cid = (torch.cumsum(new_c.to(i64), dim=1) - 1).clamp(min=0)
    start = torch.cummax(torch.where(new_c, col, -1), dim=1).values
    big = torch.full_like(col, S + 1)
    nxt = torch.where(new_c, col, big).flip(1)
    nstart = torch.cummin(nxt, dim=1).values.flip(1)
    nstart = torch.cat([nstart[:, 1:], big[:, :1]], 1)
    end = torch.minimum(nstart, nvalid) - 1
    is_middle = valid1 & (col == torch.div(start + end, 2,
                                           rounding_mode="floor"))

    # invalid seeds sort last (cluster ids are < S)
    cidk = torch.where(valid1, cid, torch.full_like(cid, S))
    key2 = (cidk << 48) | ((off1 + 2**31) << 16) | col
    o2 = torch.sort(key2, dim=1).indices
    cid2 = torch.gather(cidk, 1, o2)
    off2 = torch.gather(off1, 1, o2)
    sc2 = torch.gather(sc1, 1, o2)
    valid2 = torch.gather(valid1, 1, o2)
    newseg = (col == 0) | (cid2 != shift_down(cid2, -1))
    uniq = newseg | (off2 != shift_down(off2, -1))
    contrib = torch.where(uniq & valid2, sc2, torch.zeros_like(sc2))
    ps = _hs_scan(contrib)
    first = torch.cummax(torch.where(newseg, col, 0), dim=1).values
    before = torch.gather(ps - contrib, 1, first)
    lastseg = torch.cat([newseg[:, 1:], torch.ones_like(newseg[:, :1])], 1)
    last = torch.cummin(torch.where(lastseg, col, big).flip(1),
                        dim=1).values.flip(1)
    total = torch.gather(ps, 1, last) - before
    val = torch.where(is_middle, total, torch.full_like(total, -1.0))

    cdiag = torch.zeros((R, C), dtype=torch.int32, device=dev)
    crev = torch.zeros((R, C), dtype=torch.int32, device=dev)
    cvalid = torch.zeros((R, C), dtype=torch.bool, device=dev)
    for c in range(C):
        mx = val.max(dim=1, keepdim=True).values
        pos_ok = (val == mx) & (mx > 0)
        mincol = torch.where(pos_ok, col, big).min(dim=1,
                                                   keepdim=True).values
        firstm = col == mincol
        cdiag[:, c] = torch.where(firstm, diag1, 0).sum(dim=1).to(
            torch.int32)
        crev[:, c] = torch.where(firstm, strand1, 0).sum(dim=1).to(
            torch.int32)
        cvalid[:, c] = mx[:, 0] > 0
        val = torch.where(firstm, torch.full_like(val, -1.0), val)
    return cdiag, crev, cvalid


def cluster_work(strandk: torch.Tensor, C: int) -> tuple:
    """(bytes, operations) one cluster_topc call needs on these inputs:
    the strand of every slot and the diagonal, offset and score of each
    valid seed read once, the (R, C) outputs written once; operations for
    two comparison sorts of each row's n seeds (n * ceil(log2 n) compares
    each), the break / id / dedup / total passes (about 12 per seed) and
    C maximum searches over the row's seeds."""
    R, S = strandk.shape
    n = (strandk < 2).sum(dim=1).to(torch.int64)
    nvalid = int(n.sum())
    log2n = torch.where(n > 1, torch.ceil(torch.log2(n.clamp(min=1)
                                                     .double())), 0)
    ops = int((2 * n * log2n.to(torch.int64) + (12 + C) * n).sum())
    nbytes = 4 * R * S + 12 * nvalid + R * C * 9
    return nbytes, ops


# --------------------------------------------------------- 1-D argsort

def argsort_i32(keys):
    """Ascending argsort of a 1-D int32 vector, ties broken by index (the
    contract of vg_tpu's argsort_i32; its TPU network breaks ties by
    position in the padded row, see csrc/seed_kernels.cu; the kernel is a
    one-block radix sort). Returns the
    int32 permutation. Up to ARGSORT_MAX_N keys launch the kernel; above,
    torch.argsort(stable=True) sorts them, as vg_tpu hands large n to
    XLA's sort."""
    if not _cuda_or_cpu(keys, "argsort_i32"):
        return argsort_i32_ref(keys)
    n = keys.shape[0]
    if keys.dim() != 1:
        raise ValueError("argsort_i32 takes a 1-D tensor")
    if n > ARGSORT_MAX_N:
        return argsort_i32_ref(keys)
    perm = torch.empty(n, dtype=torch.int32, device=keys.device)
    if n == 0:
        return perm
    k = _contig(keys, torch.int32)
    index, stream = cuda_build.launch_args(k)
    err = library().seed_argsort(index, k.data_ptr(), n, perm.data_ptr(),
                                 stream)
    _raise_on(err, "seed_argsort")
    argsort_i32.launches += 1
    return perm


argsort_i32.launches = 0


def argsort_i32_ref(keys):
    """Plain PyTorch version: the stable ascending argsort."""
    return torch.argsort(keys.to(torch.int32), stable=True).to(torch.int32)


def argsort_work(n: int) -> tuple:
    """(bytes, operations): n int32 keys read, n int32 indices written;
    n * ceil(log2 n) compares."""
    return 8 * n, n * max((n - 1).bit_length(), 1)
