"""The long-read link engine's fill and walk, and the passes that feed and
drain them: CUDA kernels and their plain versions.

The counterpart of the two lax.scans of vg_tpu/ops/device_links.py (the
fill, :110-166, and the walk, :186-221), which XLA compiles into one
program; no Pallas kernel. Two kernels in csrc/link_engine.cu (CUDA C++
for sm_90a) replace them: `link_fill` (eight lanes a task, each holding
consecutive band columns in registers) and `link_walk` (four lanes a
task, stepping through tiles of the task's bits in shared memory); the
source note says what bounds each and why it is built as it is.
ops/device_links.link_engine runs the two in turn. Around them,
`link_pack` gathers and packs each task's oriented read slice from the
batch's forward codes on the card, and `link_runs` turns the walk's step
codes into forward-merged runs (a count pass, a scan, a write pass): the
counterparts of vg_tpu's numpy host passes (vg_tpu/ops/device_links.py:
300-307 and :333-377, vg_tpu/map/longread.py:656-676).

Each wrapper launches its kernel for CUDA tensors (counted in
`<wrapper>.launches`) and runs its plain PyTorch version (`<wrapper>_ref`)
for CPU tensors: the device of the tensors decides, nothing falls back.
The plain versions are the torch body the port ran before the kernels,
cut at the fill/walk seam; together they equal
vg_tpu.ops.device_links.link_engine()'s outputs bit for bit.

Everything is int32 with NEG = -(1 << 28) and wraps as JAX's int32 does;
the uint32 words (packed text, read nibbles, op words) ride in int64 and
are masked to 32 bits after each shift.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build
from .cuda_align import _check
from .cuda_seed import _cuda_or_cpu

_SRC = cuda_build.PKG / "csrc" / "link_engine.cu"
NEG = -(1 << 28)
U32 = 0xFFFFFFFF
MAX_WB = 96                # band columns a group holds (twelve a lane)
MAX_RMAX = 1024            # read rows a fill block's shared memory holds
# the kernels' layout, for ops/link_cases.py's traps and the CPU model of
# the designs: equal to kGroup, kFillTasks, ... in csrc/link_engine.cu
FILL_LANES = 8             # lanes a fill task
FILL_WARP_TASKS = 4
FILL_BLOCK_TASKS = 32      # tasks a fill block orders by rows
WALK_WARP_TASKS = 8        # 4 lanes a walk task
WALK_BLOCK_TASKS = 32      # tasks a walk block orders by rows
WALK_TILE_ROWS = 16        # rows of a walk tile in shared memory
SCORE_LIMIT = 1 << 16      # each scoring parameter lies in [0, this)
# int32 operations of the plain recurrence a band cell (link_fill_ref's
# row body, element by element): j 1, inb 4, the match bit 2, sub 1, diag
# 1, F 3, F-extend 3, hn 1, the open source 3, g 2, the cummax 1, E 3, H 1,
# E-selected 1, E-extend 5, the j = 1 column 2, diag-ok 1, the masks 2,
# the bits byte 9
FILL_OPS_PER_CELL = 46
# the same for a walk step of a task (link_walk_ref's body): j 2, the flat
# index 5 and its wrap 5, the load 1, the five bits 9, at_end 3, take_d 6,
# in_e 6, in_f 3, op 3, halt 1, its select 1, the next row 3, column 4 and
# state 8, the state selects 3, the op's place in its word 2
WALK_OPS_PER_STEP = 65

_lib = None
_lib_lock = threading.Lock()
build_info: dict = {}      # path, seconds, ptxas report of the last build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


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
        lib.link_fill.restype = _I
        lib.link_fill.argtypes = ([_I] + [_P] * 6 + [_L, _L] + [_I] * 7
                                  + [_P] * 3)
        lib.link_walk.restype = _I
        lib.link_walk.argtypes = [_I] + [_P] * 4 + [_I] * 4 + [_P] * 4
        lib.link_pack.restype = _I
        lib.link_pack.argtypes = [_I, _P, _P, _I, _P, _I, _I, _I, _P, _P]
        lib.link_runs_count.restype = _I
        lib.link_runs_count.argtypes = [_I] + [_P] * 3 + [_I] * 2 + [_P] * 2
        lib.link_runs_write.restype = _I
        lib.link_runs_write.argtypes = [_I] + [_P] * 4 + [_I] * 2 + [_P] * 2
        _lib = lib
        return _lib


def _round_up(x, m):
    return (x + m - 1) // m * m


def window_bytes(RMAX: int, WB: int) -> int:
    """KB: the text codes a task's fill reads, bdiag[0 .. KB)."""
    return _round_up(RMAX + WB + 8, 8)


def walk_steps(RMAX: int, WB: int) -> int:
    """STEPS, the walk's length. Certified paths satisfy total-gap-length
    <= 2*go/ge + |d| + 2B (from the escape bound), so steps = lb + #I <=
    (RMAX + 2B) + (2*go/ge + |d| + 2B + |d|)/2 — 64 slack covers any
    scoring in use; longer walks fail `complete` and fall back to the
    host."""
    return _round_up(RMAX + WB + 64, 8)


def _check_tasks(name, dev, N, **arrays) -> None:
    for key, t in arrays.items():
        _check(t, f"{name}: {key}", torch.int32, (N,), dev)


# ---------------------------------------------------------------- fill

def link_fill(a4, la, ta, base, lb, text_packed, *, RMAX: int, WB: int,
              T: int, match: int, mismatch: int, gap_open: int,
              gap_extend: int):
    """Banded affine fill of N padded link problems: a4 (N, RMAX/8) int32
    (read codes, 8 nibbles a uint32 word), la, ta, base, lb (N,) int32,
    text_packed the packed text (ops/cuda_align.pack_text) of T bases.
    Returns (score (N,) int32, bits (N, RMAX + 1, WB) uint8), the decision
    bits of rows 0..RMAX in vg_tpu's layout. CUDA tensors launch the kernel
    (counted in `link_fill.launches`); CPU tensors run link_fill_ref."""
    kw = dict(RMAX=RMAX, WB=WB, T=T, match=match, mismatch=mismatch,
              gap_open=gap_open, gap_extend=gap_extend)
    if not _cuda_or_cpu(a4, "link_fill"):
        return link_fill_ref(a4, la, ta, base, lb, text_packed, **kw)
    dev = a4.device
    N = a4.shape[0]
    if RMAX % 8 or not 8 <= RMAX <= MAX_RMAX:
        raise ValueError(f"link_fill: the kernel takes RMAX a multiple of "
                         f"8 in [8, {MAX_RMAX}], not {RMAX}")
    if not 1 <= WB <= MAX_WB:
        raise ValueError(f"link_fill: the kernel takes 1 <= WB <= {MAX_WB} "
                         f"band columns, not {WB}")
    for key in ("match", "mismatch", "gap_open", "gap_extend"):
        if not 0 <= kw[key] < SCORE_LIMIT:
            raise ValueError(f"link_fill: {key} = {kw[key]} is outside "
                             f"[0, {SCORE_LIMIT})")
    _check(a4, "link_fill: a4", torch.int32, (N, RMAX // 8), dev)
    _check_tasks("link_fill", dev, N, la=la, ta=ta, base=base, lb=lb)
    _check(text_packed, "link_fill: text_packed", torch.int32,
           text_packed.shape, dev)
    if text_packed.dim() != 1 or text_packed.shape[0] < 1:
        raise ValueError("link_fill: text_packed must be 1-D and not empty")
    score = torch.empty(N, dtype=torch.int32, device=dev)
    bits = torch.empty((N, RMAX + 1, WB), dtype=torch.uint8, device=dev)
    if N == 0:
        return score, bits
    index, stream = cuda_build.launch_args(a4)
    err = library().link_fill(
        index, a4.data_ptr(), la.data_ptr(), ta.data_ptr(), base.data_ptr(),
        lb.data_ptr(), text_packed.data_ptr(), text_packed.shape[0], T, N,
        RMAX, WB, match, mismatch, gap_open, gap_extend, score.data_ptr(),
        bits.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"link_fill launch failed: CUDA error {err}")
    link_fill.launches += 1
    return score, bits


link_fill.launches = 0


def link_fill_ref(a4, la, ta, base, lb, text_packed, *, RMAX: int, WB: int,
                  T: int, match: int, mismatch: int, gap_open: int,
                  gap_extend: int):
    """Plain PyTorch version of the fill: a Python loop over rows of
    elementwise ops on the (N, WB) band, the in-row E scan as one cummax
    (the lazy-E identity: opening from an H that equals E never beats
    extending while gap_open >= gap_extend)."""
    dev = a4.device
    i32 = torch.int32
    u8 = torch.uint8
    N = a4.shape[0]
    KB = window_bytes(RMAX, WB)

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
    return score, bits_all


def fill_work(la: torch.Tensor, N: int, RMAX: int, WB: int,
              text_words: int) -> tuple:
    """(bytes, operations) one link_fill call needs on these inputs: the
    read words, the four task arrays and the text words the windows cover
    (at most the whole text) read once, the scores and the bits written
    once; FILL_OPS_PER_CELL for each band cell of the rows each task runs
    (min(la, RMAX); rows past la hold no cell)."""
    KB = window_bytes(RMAX, WB)
    words = min(text_words, N * (KB // 8 + 1))
    nbytes = (N * (RMAX // 8) * 4 + 4 * 4 * N + 4 * words + 4 * N
              + N * (RMAX + 1) * WB)
    rows = int(la.to(torch.int64).clamp(0, RMAX).sum())
    return nbytes, FILL_OPS_PER_CELL * WB * rows


# ---------------------------------------------------------------- walk

def link_walk(bits, la, base, lb):
    """Traceback of the N problems whose decision bits link_fill wrote:
    bits (N, RMAX + 1, WB) uint8, la, base, lb (N,) int32. Returns (packed
    ops (N, STEPS/8) int32 holding uint32 bits, n_steps (N,) int32,
    complete (N,) bool): ops 0=M 1=X 2=I 3=D 4=halted, 4 bits each, in
    traceback order. CUDA tensors launch the kernel (counted in
    `link_walk.launches`); CPU tensors run link_walk_ref."""
    if not _cuda_or_cpu(bits, "link_walk"):
        return link_walk_ref(bits, la, base, lb)
    dev = bits.device
    if bits.dim() != 3:
        raise ValueError("link_walk: bits must be (N, RMAX + 1, WB)")
    N, R1, WB = bits.shape
    RMAX = R1 - 1
    if RMAX < 0 or not 1 <= WB <= MAX_WB:
        raise ValueError(f"link_walk: bits of shape {tuple(bits.shape)}")
    _check(bits, "link_walk: bits", torch.uint8, (N, R1, WB), dev)
    _check_tasks("link_walk", dev, N, la=la, base=base, lb=lb)
    STEPS = walk_steps(RMAX, WB)
    packed = torch.empty((N, STEPS // 8), dtype=torch.int32, device=dev)
    n_steps = torch.empty(N, dtype=torch.int32, device=dev)
    complete = torch.empty(N, dtype=torch.bool, device=dev)
    if N == 0:
        return packed, n_steps, complete
    index, stream = cuda_build.launch_args(bits)
    err = library().link_walk(
        index, bits.data_ptr(), la.data_ptr(), base.data_ptr(),
        lb.data_ptr(), N, RMAX, WB, STEPS, packed.data_ptr(),
        n_steps.data_ptr(), complete.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"link_walk launch failed: CUDA error {err}")
    link_walk.launches += 1
    return packed, n_steps, complete


link_walk.launches = 0


def link_walk_ref(bits, la, base, lb):
    """Plain PyTorch version of the walk: a lockstep loop of STEPS steps
    over all problems, one gather a step from the flattened bits."""
    N, R1, WB = bits.shape
    RMAX = R1 - 1
    dev = bits.device
    i32 = torch.int32
    u8 = torch.uint8
    bpf = bits.reshape(-1)
    size = bpf.shape[0]
    lane_base = torch.arange(N, dtype=torch.int64, device=dev) * (
        (RMAX + 1) * WB)
    STEPS = walk_steps(RMAX, WB)
    cfin = lb - la - base                           # final band column
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
    return packed, n_steps, complete


def walk_work(n_steps: torch.Tensor, N: int, RMAX: int, WB: int) -> tuple:
    """(bytes, operations) one link_walk call needs on these inputs: la,
    base and lb read once, one bits byte for each step a task takes, the
    packed ops, n_steps and complete written once; WALK_OPS_PER_STEP for
    each step taken and for each task's halting step."""
    SW = walk_steps(RMAX, WB) // 8
    taken = int(n_steps.to(torch.int64).sum())
    nbytes = 3 * 4 * N + taken + 4 * SW * N + 4 * N + N
    return nbytes, WALK_OPS_PER_STEP * (taken + N)


# ---------------------------------------------------------------- pack

# int64 operations of link_pack_ref a base (element by element): the
# forward position 4, its tests 6, the index 2, the load 1, the complement
# 4, the mask 1, the nibble's shift and sum 2
PACK_OPS_PER_BASE = 20


def _check_pack(blob, read_off, tasks, N, RMAX) -> None:
    dev = blob.device
    if RMAX % 8 or RMAX < 8:
        raise ValueError(f"link_pack: RMAX must be a positive multiple of "
                         f"8, not {RMAX}")
    if blob.dim() != 1 or read_off.dim() != 1 or read_off.shape[0] < 1:
        raise ValueError("link_pack: blob and read_off must be 1-D, "
                         "read_off not empty")
    if tasks.dim() != 2 or not 0 <= tasks.shape[0] <= N:
        raise ValueError(f"link_pack: tasks must be (n, 4) with n <= N = "
                         f"{N}, not {tuple(tasks.shape)}")
    _check(blob, "link_pack: blob", torch.uint8, blob.shape, dev)
    _check(read_off, "link_pack: read_off", torch.int64, read_off.shape, dev)
    _check(tasks, "link_pack: tasks", torch.int32, (tasks.shape[0], 4), dev)


def link_pack(blob, read_off, tasks, *, N: int, RMAX: int):
    """The (N, RMAX/8) int32 read words (uint32 bits, 8 nibbles a word:
    base p in nibble p % 8 of word p // 8) of n <= N link tasks, gathered
    from a batch's reads: blob (nb,) uint8 forward read codes (0-4),
    read_off (R + 1,) int64 (read r is blob[read_off[r] ..
    read_off[r + 1]), inside the blob), tasks (n, 4) int32 rows (read,
    reverse, ra, la). Base p of task t is base ra + p of the read, or on
    the reverse strand of its reverse complement (the complement, by
    dna._COMP, of forward base len - 1 - (ra + p)); it is 0 from la on and
    where that forward base lies outside the read, and tasks n .. N - 1
    are 0. CUDA tensors launch the kernel (counted in `link_pack.launches`);
    CPU tensors run link_pack_ref."""
    if not _cuda_or_cpu(blob, "link_pack"):
        return link_pack_ref(blob, read_off, tasks, N=N, RMAX=RMAX)
    _check_pack(blob, read_off, tasks, N, RMAX)
    dev = blob.device
    n = tasks.shape[0]
    a4 = torch.empty((N, RMAX // 8), dtype=torch.int32, device=dev)
    if N == 0:
        return a4
    index, stream = cuda_build.launch_args(blob)
    err = library().link_pack(
        index, blob.data_ptr(), read_off.data_ptr(), read_off.shape[0] - 1,
        tasks.data_ptr(), n, N, RMAX // 8, a4.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"link_pack launch failed: CUDA error {err}")
    link_pack.launches += 1
    return a4


link_pack.launches = 0


def link_pack_ref(blob, read_off, tasks, *, N: int, RMAX: int):
    """Plain PyTorch version of link_pack: one gather of the (n, RMAX)
    oriented bases, masked, then summed into words."""
    dev = blob.device
    n = tasks.shape[0]
    R = read_off.shape[0] - 1
    t = tasks.to(torch.int64)
    r, rev, ra, la = t[:, 0:1], t[:, 1:2] != 0, t[:, 2:3], t[:, 3:4]
    rr = r.clamp(0, max(R - 1, 0))
    off = read_off[rr]
    length = read_off[(rr + 1).clamp(max=R)] - off
    p = torch.arange(RMAX, device=dev)
    q = ra + p
    f = torch.where(rev, length - 1 - q, q)
    ok = (r >= 0) & (r < R) & (p < la) & (f >= 0) & (f < length)
    nb = blob.shape[0]
    code = (blob[(off + f).clamp(0, max(nb - 1, 0))].to(torch.int64) if nb
            else torch.zeros((n, RMAX), dtype=torch.int64, device=dev))
    code = torch.where(rev & (code < 4), 3 - code, code)
    code = torch.where(ok, code, 0)
    sh4 = torch.arange(8, device=dev) * 4
    words = (code.reshape(n, RMAX // 8, 8) << sh4).sum(dim=2)
    a4 = torch.zeros((N, RMAX // 8), dtype=torch.int32, device=dev)
    a4[:n] = torch.where(words >= 2 ** 31, words - 2 ** 32,
                         words).to(torch.int32)
    return a4


def pack_work(tasks: torch.Tensor, read_off: torch.Tensor, N: int,
              RMAX: int) -> tuple:
    """(bytes, operations) one link_pack call needs on these inputs: each
    task's row of the table and the reads' offsets read once, the
    min(la, RMAX) bases of each task's slice read once, the words written
    once; PACK_OPS_PER_BASE for each base of a slice."""
    bases = int(tasks[:, 3].to(torch.int64).clamp(0, RMAX).sum())
    nbytes = (16 * tasks.shape[0] + 8 * read_off.shape[0] + bases
              + 4 * N * (RMAX // 8))
    return nbytes, PACK_OPS_PER_BASE * bases


# ---------------------------------------------------------------- runs

# int64 operations of link_runs_ref a step (element by element): the
# nibble 2, the reversed index 3, the gather 1, the mask 1, the two
# boundary tests and their or 3, the start's place 1, its run's op and
# length 1
RUNS_OPS_PER_STEP = 12


def _check_runs(packed, n_steps, cert) -> tuple:
    dev = packed.device
    if packed.dim() != 2 or packed.shape[1] < 1:
        raise ValueError(f"link_runs: packed must be (N, SW), SW >= 1, not "
                         f"{tuple(packed.shape)}")
    N, SW = packed.shape
    _check(packed, "link_runs: packed", torch.int32, (N, SW), dev)
    _check(n_steps, "link_runs: n_steps", torch.int32, (N,), dev)
    _check(cert, "link_runs: cert", torch.bool, (N,), dev)
    return N, SW


def _count_runs(packed, n_steps, cert):
    """link_runs' count pass on the card: (N,) int64 runs a task."""
    N, SW = _check_runs(packed, n_steps, cert)
    counts = torch.empty(N, dtype=torch.int64, device=packed.device)
    index, stream = cuda_build.launch_args(packed)
    err = library().link_runs_count(
        index, packed.data_ptr(), n_steps.data_ptr(), cert.data_ptr(), N, SW,
        counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"link_runs count launch failed: CUDA error {err}")
    link_runs.launches += 1
    return counts


def _write_runs(packed, n_steps, cert, ends, total: int):
    """link_runs' write pass on the card: the (total, 3) int32 runs, task
    t's at rows ends[t] - counts[t] .. ends[t] - 1 (ends (N,) int64, the
    inclusive scan of the count pass, total = ends[N - 1])."""
    N, SW = _check_runs(packed, n_steps, cert)
    _check(ends, "link_runs: ends", torch.int64, (N,), packed.device)
    runs = torch.empty((total, 3), dtype=torch.int32, device=packed.device)
    if total == 0:
        return runs
    index, stream = cuda_build.launch_args(packed)
    err = library().link_runs_write(
        index, packed.data_ptr(), n_steps.data_ptr(), cert.data_ptr(),
        ends.data_ptr(), N, SW, runs.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"link_runs write launch failed: CUDA error {err}")
    link_runs.launches += 1
    return runs


def link_runs(packed, n_steps, cert):
    """The walk's step codes as runs: packed (N, SW) int32 holding the
    uint32 op words of link_walk (step s in nibble s % 8 of word s // 8, a
    task's steps last-first), n_steps (N,) int32, cert (N,) bool. Returns
    (runs (m, 3) int32, counts (N,) int64): the ops of each certified task
    in forward order (op[n_steps - 1 - i] for i = 0 .. n_steps - 1), merged
    into (op, length, 0) runs, task after task and never across tasks;
    counts[t] the runs of task t (0 where cert is False). On the card a
    count pass, the scan of the counts (torch.cumsum, int64), one
    synchronisation for m and a write pass (launched only where m > 0);
    each of the two kernels counts its launches in `link_runs.launches`.
    CPU tensors run link_runs_ref."""
    if not _cuda_or_cpu(packed, "link_runs"):
        return link_runs_ref(packed, n_steps, cert)
    N, _ = _check_runs(packed, n_steps, cert)
    if N == 0:
        return (torch.empty((0, 3), dtype=torch.int32, device=packed.device),
                torch.empty(0, dtype=torch.int64, device=packed.device))
    counts = _count_runs(packed, n_steps, cert)
    ends = torch.cumsum(counts, 0)
    runs = _write_runs(packed, n_steps, cert, ends, int(ends[-1]))
    return runs, counts


link_runs.launches = 0


def link_runs_ref(packed, n_steps, cert):
    """Plain PyTorch version of link_runs: vg_tpu's numpy decoding in torch
    ops (the certified tasks' codes reversed, masked, flattened, split
    where the op or the task changes)."""
    dev = packed.device
    N, SW = packed.shape
    SW8 = 8 * SW
    i64 = torch.int64
    counts = torch.zeros(N, dtype=i64, device=dev)
    ci = torch.nonzero(cert).flatten()
    if ci.numel() == 0:
        return torch.zeros((0, 3), dtype=torch.int32, device=dev), counts
    ns = n_steps[ci].to(i64).clamp(0, SW8)
    sh4 = torch.arange(8, device=dev) * 4
    codes = ((packed[ci].to(i64)[:, :, None] & U32) >> sh4 & 15).reshape(
        len(ci), SW8)
    col = torch.arange(SW8, device=dev)
    fwd = torch.gather(codes, 1, (ns[:, None] - 1 - col).clamp(0, SW8 - 1))
    flat = fwd[col[None, :] < ns[:, None]]
    tid = torch.repeat_interleave(torch.arange(len(ci), device=dev), ns)
    brk = torch.ones(len(flat), dtype=torch.bool, device=dev)
    brk[1:] = (flat[1:] != flat[:-1]) | (tid[1:] != tid[:-1])
    starts = torch.nonzero(brk).flatten()
    ends = torch.cat([starts[1:], starts.new_tensor([len(flat)])])[
        : len(starts)]
    runs = torch.zeros((len(starts), 3), dtype=torch.int32, device=dev)
    runs[:, 0] = flat[starts].to(torch.int32)
    runs[:, 1] = (ends - starts).to(torch.int32)
    counts[ci] = torch.bincount(tid[starts], minlength=len(ci))
    return runs, counts


def runs_work(n_steps, cert, m: int) -> tuple:
    """(bytes, operations) one link_runs call needs on these inputs: the
    words holding each certified task's steps, n_steps and cert read once,
    the counts and the m runs written once; RUNS_OPS_PER_STEP for each
    step of a certified task."""
    ns = torch.where(cert, n_steps.to(torch.int64).clamp_min(0), 0)
    N = n_steps.shape[0]
    nbytes = 4 * int(((ns + 7) // 8).sum()) + 5 * N + 8 * N + 12 * m
    return nbytes, RUNS_OPS_PER_STEP * int(ns.sum())
