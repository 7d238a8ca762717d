"""Build-on-demand loader of pair_emit.cpp, the short-read record writer.

`lib()` returns the library, loaded through ctypes.CDLL (each call
releases the interpreter lock), or None where it cannot be built or
VGTPU_NO_NATIVE is set; callers then encode Alignment objects. Built with
g++ without OpenMP, next to the host library (`VGTPU_TORCH_NATIVE_CACHE`,
else vg_tpu_torch/_build/), the file keyed by the source's hash. The
`EmitGraph` and `EmitMate` structures and the `NODE_REC` record mirror
the source's.

Port-only: modelled on native/__init__.py's loader.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

_HERE = pathlib.Path(__file__).parent
_SRC = _HERE / "pair_emit.cpp"
_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int64


# NodeRec: a node's id, length and first reference position, 32 bytes
NODE_REC = np.dtype([("id", "<i8"), ("len", "<i8"), ("ref_off", "<i8"),
                     ("ref_path", "<i4"), ("ref_rev", "u1"),
                     ("pad", "u1", 3)])
BUCKET_SHIFT = 12        # text positions a bucket of the step index


class EmitGraph(ctypes.Structure):
    _fields_ = [("text", _P), ("text_len", _I), ("step_text_pos", _P),
                ("steps", _P), ("n_steps", _I), ("nodes", _P),
                ("bucket_step", _P), ("bucket_shift", _I),
                ("refname_off", _P), ("refnames", _P), ("match", _I),
                ("mismatch", _I), ("bonus", _I)]


class EmitMate(ctypes.Structure):
    _fields_ = [("R", _I), ("diag", _P), ("lo", _P), ("hi", _P),
                ("rev", _P), ("best_s", _P), ("mapq", _P),
                ("any_valid", _P), ("best_j", _P), ("pay_mode", ctypes.c_int32),
                ("dev_j", _P), ("dev_mm", _P), ("pay", _P),
                ("pay_bytes", _I), ("name_off", _P), ("names", _P),
                ("seq_off", _P), ("seqs", _P), ("qual_off", _P),
                ("quals", _P), ("ext_off", _P), ("ext_len", _P), ("ext", _P),
                ("kind", _P), ("mm", _P)]


def _build() -> Optional[pathlib.Path]:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    cache = pathlib.Path(os.environ.get("VGTPU_TORCH_NATIVE_CACHE",
                                        str(_HERE.parent / "_build")))
    cache.mkdir(parents=True, exist_ok=True)
    so = cache / f"pair_emit_{tag}.so"
    if so.exists():
        return so
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception as e:  # no toolchain or a compile error
        sys.stderr.write(f"[vg_tpu_torch.native.pair_emit] build skipped: "
                         f"{e}\n")
        return None
    tmp.replace(so)
    return so


def lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("VGTPU_NO_NATIVE"):
            return None
        so = _build()
        if so is None:
            return None
        L = ctypes.CDLL(str(so))
        G, M = ctypes.POINTER(EmitGraph), ctypes.POINTER(EmitMate)
        L.emit_classify.restype = _I
        L.emit_classify.argtypes = [G, M]
        L.emit_records.restype = _I
        L.emit_records.argtypes = [G, M, M, _P, _P, _P, _I, _P]
        _lib = L
        return _lib


def write_records(L, graph, mates, cap: int, pair=None):
    """Every record of a batch by one emit_records call: mates holds one
    EmitMate (records in row order) or two (a paired batch: records
    interleaved, with the pair's fields; then pair = (use_pair uint8,
    frags int64), both (R,)). cap: the bytes the caller expects, doubled
    until the records fit. A list of memoryviews into one new buffer, or
    None where the call refuses a row."""
    R = mates[0].R
    rec_off = np.empty(len(mates) * R + 1, np.int64)
    use_pair, frags = pair if pair is not None else (None, None)
    while True:
        out = np.empty(cap, np.uint8)
        n = L.emit_records(
            graph, mates[0], mates[1] if len(mates) > 1 else None,
            None if use_pair is None else use_pair.ctypes.data,
            None if frags is None else frags.ctypes.data,
            out.ctypes.data, cap, rec_off.ctypes.data)
        if n != -1:
            break
        cap *= 2
    if n < 0:
        return None
    bl = rec_off.tolist()
    mv = memoryview(out)
    return [mv[a:b] for a, b in zip(bl, bl[1:])]
