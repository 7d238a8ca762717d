"""Banded DP over haplotype text: the CUDA kernel's three entries + plain
versions.

The counterpart of vg_tpu/ops/pallas_align.py on the H100. One kernel
body (csrc/banded_dp.cu, CUDA C++ for sm_90a) replaces the TPU kernel
pallas_align.make_kernel as reached through each of its three entries;
its source note says what bounds it (instruction issue) and how it runs
only the valid slots, two a thread in 16-bit halves where the scoring
allows (an int32 kernel otherwise), with a band cell in Hopper's DPX
instructions:

- `banded_scores_packed` (pallas_align.banded_scores_packed): windows
  gathered from the 4-bit packed text; plain version
  `banded_scores_packed_ref`;
- `banded_scores_bytes` (pallas_align.banded_scores_via_pallas): windows
  gathered from the byte text; plain version ops/align.banded_scores;
- `banded_scores_windows` (pallas_align.banded_scores_pallas): pre-gathered
  windows; plain version `banded_scores_windows_ref` (ops/align.banded_dp
  on the TPU kernel's padded rows);
- `banded_scores_qual_packed`: the quality-adjusted DP on the packed text,
  int32 cells with per-row scores from the phred tables, on one of two
  routes: the same kernel body, one slot a thread, or a slot's band split
  over a group of 4 lanes (`qual_lanes` picks the route from the batch
  and the card). It replaces no TPU kernel: vg_tpu runs it as an
  XLA scan (vg_tpu.ops.align.banded_scores_qual). Plain version
  `banded_scores_qual_packed_ref`.

Each launches the kernel for CUDA tensors and runs its plain version for
CPU tensors — the device of the tensors decides, nothing falls back. The
kernel library is built with nvcc into vg_tpu_torch/_build/ on first use
and bound with ctypes (plain C interface: pointers and the stream as
c_void_p).
"""
from __future__ import annotations

import ctypes
import logging
import threading

import numpy as np
import torch

from . import cuda_build
from .align import (SENTINEL, _score_windows, banded_dp, banded_scores,
                    score_windows_qual)
from .dp_cases import BLOCK_SLOTS

_SRC = cuda_build.PKG / "csrc" / "banded_dp.cu"
RADII = (8, 12, 16)        # band radii the kernel is instantiated for
# Instructions a band cell needs with Hopper's DPX instructions: 8.5 for
# two cells in 16-bit halves (csrc/banded_dp.cu), the route of every call
# whose values fit int16, the main path's among them (the int32 route's
# cell takes 7.5).
OPS_PER_CELL = 4.25
# The quality entry's work, the yardstick of its bound whatever its route
# (csrc/banded_dp.cu): the int32 cell's 7.5 instructions, and a row's
# scores from the tables: the oriented quality's index (2), its load (1),
# the clip to the tables (1), two table reads (2) and the two sums with the
# gap open (2).
OPS_PER_CELL_INT32 = 7.5
QUAL_OPS_PER_ROW = 8
MAX_QUAL_TAB = 128         # entries of a quality table the kernel holds
QUAL_LANES = (1, 4)        # the quality entry's routes: lanes a slot
QUAL_SPLIT_SLOTS = 96      # qual_lanes: split-route slots an SM (3 blocks)
QUAL_SPLIT_MAX_RL = 1024   # the split route's rows: its shared memory
LANES = 128                # banded_scores_windows: N is a multiple of this

_lib = None
_lib_lock = threading.Lock()
build_info: dict = {}      # path, seconds, ptxas report of the last build
_sms: dict = {}            # SM count by CUDA device index
_log = logging.getLogger(__name__)


def pack_text(text: np.ndarray) -> np.ndarray:
    """4-bit pack the haplotype text: 8 base codes per int32 word
    (little-endian within the word). Gathering words instead of bytes is
    ~4x faster on TPU (the wrapper's window gather is the hot memory op);
    codes 0-5 plus the sentinel 6 all fit in a nibble."""
    pad = (-len(text)) % 8 + 16
    tp = np.concatenate(
        [np.asarray(text, np.uint8),
         np.full(pad, 6, np.uint8)]).astype(np.uint32)
    packed = np.zeros(len(tp) // 8, np.uint32)
    for b in range(8):
        packed |= tp[b::8] << np.uint32(4 * b)
    return packed.view(np.int32)


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
        for fn in (lib.banded_dp_packed, lib.banded_dp_bytes):
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                           + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                           + [ctypes.c_void_p])
        fn = lib.banded_dp_windows
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_longlong] + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn = lib.banded_dp_qual_packed
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 12 + [ctypes.c_int]
                       + [ctypes.c_void_p] + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        for fn in (lib.banded_dp_launches, lib.banded_dp_qual_launches):
            fn.restype = ctypes.c_longlong
            fn.argtypes = [ctypes.c_int]
        lib.banded_dp_block_slots.restype = ctypes.c_int
        if lib.banded_dp_block_slots() != BLOCK_SLOTS:
            raise RuntimeError(
                f"banded_dp.cu gives a block {lib.banded_dp_block_slots()} "
                f"slots, dp_cases.BLOCK_SLOTS says {BLOCK_SLOTS}")
        _lib = lib
        return _lib


def launches_by_route() -> dict:
    """Launches of the DP kernels so far, all entries together: 16 for the
    16x2 kernel (two slots a thread), 32 for the int32 one. The C entry
    picks the route: int32 when a value of the call's DP could leave int16
    (csrc/banded_dp.cu, fits16)."""
    lib = library()
    return {bits: int(lib.banded_dp_launches(bits)) for bits in (16, 32)}


def qual_lanes(N: int, sms: int, RL: int) -> int:
    """The quality entry's route for N slots of RL rows on a card of `sms`
    SMs, as lanes a slot: 4 (banded_dp_qual_split_kernel, blocks of 32
    slots) up to QUAL_SPLIT_SLOTS slots an SM and QUAL_SPLIT_MAX_RL rows,
    else 1 (banded_dp_qual_kernel, one slot a thread). csrc/banded_dp.cu
    gives the measurements behind it (scripts/qual_route_sweep.py)."""
    return 4 if RL <= QUAL_SPLIT_MAX_RL and N <= QUAL_SPLIT_SLOTS * sms else 1


def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once a device)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sms[index]


def qual_launches_by_route() -> dict:
    """Launches of the quality entry's routes so far, as the library
    counts them: {G: launches} for G lanes a slot."""
    lib = library()
    return {G: int(lib.banded_dp_qual_launches(G)) for G in QUAL_LANES}


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_text(entry, text, T, reads, reads_rc, rlen, cand_start, cand_lo,
                 cand_hi, cand_rev, cand_valid, band_radius, match, mismatch,
                 gap_open, gap_extend, bonus) -> torch.Tensor:
    """Check the candidate-table inputs and launch one of the text entries
    (`banded_dp_packed`: int32 words, `banded_dp_bytes`: uint8 codes)."""
    dev = text.device
    if band_radius not in RADII:
        raise ValueError(f"the banded-DP kernel is instantiated for band "
                         f"radii {RADII}, not {band_radius}")
    R, RL = reads.shape
    C = cand_start.shape[1]
    if rlen.dim() != 1 or rlen.shape[0] < R:
        raise ValueError(f"rlen must be 1-D with at least {R} entries")
    rlen = rlen[:R]
    packed = entry == "banded_dp_packed"
    _check(text, "text", torch.int32 if packed else torch.uint8, text.shape,
           dev)
    if text.dim() != 1 or text.shape[0] * (8 if packed else 1) < T:
        raise ValueError("text must be 1-D and hold T bases")
    _check(reads, "reads", torch.uint8, (R, RL), dev)
    _check(reads_rc, "reads_rc", torch.uint8, (R, RL), dev)
    _check(rlen, "rlen", torch.int32, (R,), dev)
    for name, t in (("cand_start", cand_start), ("cand_lo", cand_lo),
                    ("cand_hi", cand_hi)):
        _check(t, name, torch.int32, (R, C), dev)
    _check(cand_rev, "cand_rev", torch.bool, (R, C), dev)
    _check(cand_valid, "cand_valid", torch.bool, (R, C), dev)
    out = torch.empty((R, C), dtype=torch.int32, device=dev)
    index, stream = cuda_build.launch_args(text)
    err = getattr(library(), entry)(
        index, text.data_ptr(), int(T), reads.data_ptr(),
        reads_rc.data_ptr(), rlen.data_ptr(), cand_start.data_ptr(),
        cand_lo.data_ptr(), cand_hi.data_ptr(), cand_rev.data_ptr(),
        cand_valid.data_ptr(), out.data_ptr(), R, C, RL, band_radius,
        match, mismatch, gap_open, gap_extend, bonus, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return out


def banded_scores_packed(
    text_packed: torch.Tensor,  # (ceil(T/8)+2,) int32, pack_text() output
    T: int,                     # true text length in bases
    reads: torch.Tensor, reads_rc: torch.Tensor, rlen: torch.Tensor,
    cand_start: torch.Tensor, cand_lo: torch.Tensor, cand_hi: torch.Tensor,
    cand_rev: torch.Tensor, cand_valid: torch.Tensor,
    *, band_radius: int = 16, match: int = 1, mismatch: int = 4,
    gap_open: int = 6, gap_extend: int = 1, bonus: int = 5) -> torch.Tensor:
    """Production DP entry, same contract as vg_tpu.ops.align.banded_scores
    but reading the text from its 4-bit packed form. Returns (R, C) int32
    scores, -1 on invalid slots. CUDA tensors launch the kernel (counted in
    `banded_scores_packed.launches`); CPU tensors run the plain version."""
    args = (reads, reads_rc, rlen, cand_start, cand_lo, cand_hi, cand_rev,
            cand_valid)
    kw = dict(band_radius=band_radius, match=match, mismatch=mismatch,
              gap_open=gap_open, gap_extend=gap_extend, bonus=bonus)
    dev = text_packed.device
    if dev.type == "cpu":
        return banded_scores_packed_ref(text_packed, T, *args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"banded_scores_packed: unsupported device {dev}")
    out = _launch_text("banded_dp_packed", text_packed, T, *args, **kw)
    banded_scores_packed.launches += 1
    return out


banded_scores_packed.launches = 0


def banded_scores_packed_ref(
    text_packed: torch.Tensor, T: int, reads: torch.Tensor,
    reads_rc: torch.Tensor, rlen: torch.Tensor, cand_start: torch.Tensor,
    cand_lo: torch.Tensor, cand_hi: torch.Tensor, cand_rev: torch.Tensor,
    cand_valid: torch.Tensor, *, band_radius: int = 16, match: int = 1,
    mismatch: int = 4, gap_open: int = 6, gap_extend: int = 1,
    bonus: int = 5) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same packed-word window
    gather (masked to [lo, hi) ∩ [0, T)) and the same banded DP
    (ops/align.banded_dp), on whatever device the tensors live."""
    R, RL = reads.shape
    win = packed_windows(text_packed, T, cand_start, cand_lo, cand_hi,
                         RL + 2 * band_radius)
    s = _score_windows(win, reads, reads_rc, rlen[:R], cand_rev, band_radius,
                       match, mismatch, gap_open, gap_extend, bonus)
    return torch.where(cand_valid, s, -1).to(torch.int32)


def packed_windows(text_packed: torch.Tensor, T: int,
                   cand_start: torch.Tensor, cand_lo: torch.Tensor,
                   cand_hi: torch.Tensor, TW: int) -> torch.Tensor:
    """(R, C, TW) uint8 windows read from the packed words, masked to
    [lo, hi) ∩ [0, T) with the sentinel, as the kernel reads them."""
    pos = (cand_start.to(torch.int64)[:, :, None]
           + torch.arange(TW, device=cand_start.device))
    ok = ((pos >= cand_lo[:, :, None]) & (pos < cand_hi[:, :, None])
          & (pos >= 0) & (pos < T))
    nw = text_packed.shape[0]
    words = text_packed[(pos >> 3).clamp(0, nw - 1)].to(torch.int64)
    nib = ((words & 0xFFFFFFFF) >> ((pos & 7) * 4)) & 15
    return torch.where(ok, nib, SENTINEL).to(torch.uint8)


def banded_scores_qual_packed(
    text_packed: torch.Tensor,  # (ceil(T/8)+2,) int32, pack_text() output
    T: int,                     # true text length in bases
    reads: torch.Tensor, reads_rc: torch.Tensor,
    quals: torch.Tensor,        # (R, RL) uint8 phred, forward orientation
    rlen: torch.Tensor,
    cand_start: torch.Tensor, cand_lo: torch.Tensor, cand_hi: torch.Tensor,
    cand_rev: torch.Tensor, cand_valid: torch.Tensor,
    match_tab: torch.Tensor, mism_tab: torch.Tensor, bonus_tab: torch.Tensor,
    *, band_radius: int = 16, gap_open: int = 6,
    gap_extend: int = 1) -> torch.Tensor:
    """The quality-adjusted DP on the packed text: the contract of
    vg_tpu.ops.align.banded_scores_qual (an XLA scan there; ops/align.py
    has its torch counterpart). The tables are (Q+1,) int32 vectors
    indexed by phred (ops/qualadj.qual_tables), the mismatch signed.
    Returns (R, C) int32 scores, -1 on invalid slots. CUDA tensors launch
    the kernel's quality entry, int32 cells with per-row scores
    (banded_dp_qual_packed), on the route qual_lanes(R C, the card's SM
    count, RL) gives; each launch counts in
    `banded_scores_qual_packed.launches` and, by route, in its `routes`
    dict. CPU tensors run the plain version
    `banded_scores_qual_packed_ref`."""
    args = (reads, reads_rc, quals, rlen, cand_start, cand_lo, cand_hi,
            cand_rev, cand_valid, match_tab, mism_tab, bonus_tab)
    kw = dict(band_radius=band_radius, gap_open=gap_open,
              gap_extend=gap_extend)
    dev = text_packed.device
    if dev.type == "cpu":
        return banded_scores_qual_packed_ref(text_packed, T, *args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"banded_scores_qual_packed: unsupported device "
                         f"{dev}")
    if band_radius not in RADII:
        raise ValueError(f"the banded-DP kernel is instantiated for band "
                         f"radii {RADII}, not {band_radius}")
    R, RL = reads.shape
    C = cand_start.shape[1]
    if rlen.dim() != 1 or rlen.shape[0] < R:
        raise ValueError(f"rlen must be 1-D with at least {R} entries")
    rlen = rlen[:R]
    _check(text_packed, "text", torch.int32, text_packed.shape, dev)
    if text_packed.dim() != 1 or text_packed.shape[0] * 8 < T:
        raise ValueError("text must be 1-D and hold T bases")
    _check(reads, "reads", torch.uint8, (R, RL), dev)
    _check(reads_rc, "reads_rc", torch.uint8, (R, RL), dev)
    _check(quals, "quals", torch.uint8, (R, RL), dev)
    _check(rlen, "rlen", torch.int32, (R,), dev)
    for name, t in (("cand_start", cand_start), ("cand_lo", cand_lo),
                    ("cand_hi", cand_hi)):
        _check(t, name, torch.int32, (R, C), dev)
    _check(cand_rev, "cand_rev", torch.bool, (R, C), dev)
    _check(cand_valid, "cand_valid", torch.bool, (R, C), dev)
    nq = match_tab.shape[0]
    if not 1 <= nq <= MAX_QUAL_TAB:
        raise ValueError(f"quality tables of {nq} entries; the kernel "
                         f"takes 1 to {MAX_QUAL_TAB}")
    for name, t in (("match_tab", match_tab), ("mism_tab", mism_tab),
                    ("bonus_tab", bonus_tab)):
        _check(t, name, torch.int32, (nq,), dev)
    lanes = qual_lanes(R * C, sm_count(dev), RL)
    out = torch.empty((R, C), dtype=torch.int32, device=dev)
    index, stream = cuda_build.launch_args(text_packed)
    err = library().banded_dp_qual_packed(
        index, text_packed.data_ptr(), int(T), reads.data_ptr(),
        reads_rc.data_ptr(), quals.data_ptr(), rlen.data_ptr(),
        cand_start.data_ptr(), cand_lo.data_ptr(), cand_hi.data_ptr(),
        cand_rev.data_ptr(), cand_valid.data_ptr(), match_tab.data_ptr(),
        mism_tab.data_ptr(), bonus_tab.data_ptr(), nq, out.data_ptr(), R, C,
        RL, band_radius, gap_open, gap_extend, lanes, stream)
    if err != 0:
        raise RuntimeError(f"banded_dp_qual_packed launch failed: CUDA error "
                           f"{err}")
    _log.debug("banded_dp_qual_packed: %d slots, %d lanes a slot", R * C,
               lanes)
    banded_scores_qual_packed.launches += 1
    banded_scores_qual_packed.routes[lanes] += 1
    return out


banded_scores_qual_packed.launches = 0
banded_scores_qual_packed.routes = dict.fromkeys(QUAL_LANES, 0)


def banded_scores_qual_packed_ref(
    text_packed: torch.Tensor, T: int, reads: torch.Tensor,
    reads_rc: torch.Tensor, quals: torch.Tensor, rlen: torch.Tensor,
    cand_start: torch.Tensor, cand_lo: torch.Tensor, cand_hi: torch.Tensor,
    cand_rev: torch.Tensor, cand_valid: torch.Tensor,
    match_tab: torch.Tensor, mism_tab: torch.Tensor, bonus_tab: torch.Tensor,
    *, band_radius: int = 16, gap_open: int = 6,
    gap_extend: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the quality entry: the packed-word window
    gather of banded_scores_packed_ref, then ops/align's quality-adjusted
    DP (score_windows_qual), on whatever device the tensors live."""
    R, RL = reads.shape
    win = packed_windows(text_packed, T, cand_start, cand_lo, cand_hi,
                         RL + 2 * band_radius)
    s = score_windows_qual(win, reads, reads_rc, quals, rlen, cand_rev,
                           match_tab, mism_tab, bonus_tab, band_radius,
                           gap_open, gap_extend)
    return torch.where(cand_valid, s, -1).to(torch.int32)


def banded_scores_bytes(
    text: torch.Tensor,         # (T,) uint8 haplotype text codes
    reads: torch.Tensor, reads_rc: torch.Tensor, rlen: torch.Tensor,
    cand_start: torch.Tensor, cand_lo: torch.Tensor, cand_hi: torch.Tensor,
    cand_rev: torch.Tensor, cand_valid: torch.Tensor,
    *, band_radius: int = 16, match: int = 1, mismatch: int = 4,
    gap_open: int = 6, gap_extend: int = 1, bonus: int = 5) -> torch.Tensor:
    """The DP with a byte-text window gather: the counterpart of
    vg_tpu.ops.pallas_align.banded_scores_via_pallas, a drop-in for
    ops/align.banded_scores (its plain version, run for CPU tensors).
    Returns (R, C) int32 scores, -1 on invalid slots. CUDA tensors launch
    the kernel, counted in `banded_scores_bytes.launches`."""
    args = (reads, reads_rc, rlen, cand_start, cand_lo, cand_hi, cand_rev,
            cand_valid)
    kw = dict(band_radius=band_radius, match=match, mismatch=mismatch,
              gap_open=gap_open, gap_extend=gap_extend, bonus=bonus)
    dev = text.device
    if dev.type == "cpu":
        return banded_scores(text, *args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"banded_scores_bytes: unsupported device {dev}")
    out = _launch_text("banded_dp_bytes", text, text.shape[0], *args, **kw)
    banded_scores_bytes.launches += 1
    return out


banded_scores_bytes.launches = 0


def banded_scores_windows(
    windows: torch.Tensor,      # (N, TW) uint8, N % 128 == 0
    reads: torch.Tensor,        # (N, RL) uint8, already oriented
    rlen: torch.Tensor,         # (N,) int32, 0 = invalid slot
    *, band_radius: int = 16, match: int = 1, mismatch: int = 4,
    gap_open: int = 6, gap_extend: int = 1, bonus: int = 5) -> torch.Tensor:
    """The DP on pre-gathered windows: the counterpart of
    vg_tpu.ops.pallas_align.banded_scores_pallas, with its contract (N a
    multiple of 128, (N,) int32 scores floored at 0, no -1: an invalid
    slot has rlen 0 and scores 0). CUDA tensors launch the kernel, counted
    in `banded_scores_windows.launches`; CPU tensors run the plain version
    `banded_scores_windows_ref`."""
    N, TW = windows.shape
    RL = reads.shape[1]
    assert N % LANES == 0, f"N = {N} is not a multiple of {LANES}"
    kw = dict(band_radius=band_radius, match=match, mismatch=mismatch,
              gap_open=gap_open, gap_extend=gap_extend, bonus=bonus)
    dev = windows.device
    if dev.type == "cpu":
        return banded_scores_windows_ref(windows, reads, rlen, **kw)
    if dev.type != "cuda":
        raise ValueError(f"banded_scores_windows: unsupported device {dev}")
    if band_radius not in RADII:
        raise ValueError(f"the banded-DP kernel is instantiated for band "
                         f"radii {RADII}, not {band_radius}")
    _check(windows, "windows", torch.uint8, (N, TW), dev)
    _check(reads, "reads", torch.uint8, (N, RL), dev)
    _check(rlen, "rlen", torch.int32, (N,), dev)
    out = torch.empty(N, dtype=torch.int32, device=dev)
    index, stream = cuda_build.launch_args(windows)
    err = library().banded_dp_windows(
        index, windows.data_ptr(), reads.data_ptr(), rlen.data_ptr(),
        out.data_ptr(), N, TW, RL, band_radius, match, mismatch, gap_open,
        gap_extend, bonus, stream)
    if err != 0:
        raise RuntimeError(f"banded_dp_windows launch failed: CUDA error "
                           f"{err}")
    banded_scores_windows.launches += 1
    return out


banded_scores_windows.launches = 0


def banded_scores_windows_ref(
    windows: torch.Tensor, reads: torch.Tensor, rlen: torch.Tensor, *,
    band_radius: int = 16, match: int = 1, mismatch: int = 4,
    gap_open: int = 6, gap_extend: int = 1, bonus: int = 5) -> torch.Tensor:
    """Plain version of the windows entry: ops/align.banded_dp on the rows
    the TPU kernel runs. It pads read rows to RLP = RL rounded up to 8 with
    code 5 and windows to RLP + 2B columns with the sentinel, so a slot
    with rlen > RL runs min(rlen, RLP) rows as banded_scores_pallas does
    (banded_dp alone stops at RL)."""
    N, TW = windows.shape
    RL = reads.shape[1]
    RLP = -(-RL // 8) * 8
    TWP = max(TW, RLP + 2 * band_radius)
    rd = torch.full((N, RLP), 5, dtype=torch.uint8, device=reads.device)
    rd[:, :RL] = reads
    win = torch.full((N, TWP), SENTINEL, dtype=torch.uint8,
                     device=windows.device)
    win[:, :TW] = windows
    return banded_dp(win, rd, rlen, band_radius=band_radius, match=match,
                     mismatch=mismatch, gap_open=gap_open,
                     gap_extend=gap_extend, bonus=bonus)


def dp_work(reads: torch.Tensor, rlen: torch.Tensor, cand_valid,
            text_entries: int, band_radius: int, *,
            source: str = "packed", tab_entries: int = 0) -> tuple:
    """(bytes, instructions) one call needs on these inputs: every input
    read once and the output written once; OPS_PER_CELL instructions (the
    16x2 DPX cell) for each band cell of each valid slot's rows.

    source "packed" / "bytes": candidate tables (R, C) over a text of
    `text_entries` int32 words / uint8 codes; each valid slot runs
    min(rlen, RL) rows. source "qual": the quality entry on packed words,
    which also reads the (R, RL) qualities and three tables of
    `tab_entries` int32 values, and counts int32 cells:
    OPS_PER_CELL_INT32 a cell and QUAL_OPS_PER_ROW a valid slot's row,
    whichever route runs them.
    source "windows": `reads` (N, RL) oriented, `text_entries` the
    windows' N * TW bytes, `cand_valid` None; each slot runs
    min(rlen, RLP) rows, RLP = RL rounded up to 8."""
    R, RL = reads.shape
    W = 2 * band_radius + 1
    if source == "windows":
        RLP = -(-RL // 8) * 8
        rows = rlen.to(torch.int64).clamp(0, RLP)
        nbytes = text_entries + R * RL + 4 * R + 4 * R
        return nbytes, round(OPS_PER_CELL * int(rows.sum()) * W)
    C = cand_valid.shape[1]
    rows = rlen[:R].to(torch.int64).clamp(0, RL)
    slot_rows = int((cand_valid.to(torch.int64) * rows[:, None]).sum())
    nbytes = ((1 if source == "bytes" else 4) * text_entries + 2 * R * RL
              + 4 * R + R * C * (3 * 4 + 2) + 4 * R * C)
    if source == "qual":
        return (nbytes + R * RL + 3 * 4 * tab_entries,
                round(OPS_PER_CELL_INT32 * slot_rows * W
                      + QUAL_OPS_PER_ROW * slot_rows))
    return nbytes, round(OPS_PER_CELL * slot_rows * W)
