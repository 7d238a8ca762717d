"""Native host-kernel library: build-on-demand C++ with ctypes bindings.

Provides `lib()` returning the loaded shared library or None when no
toolchain is available (callers fall back to numpy implementations).
The build is cached next to the source keyed by a content hash.

Copied from vg_tpu/native/__init__.py.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import sys
from typing import Optional

import numpy as np

_HERE = pathlib.Path(__file__).parent
_SRC = _HERE / "vgtpu_host.cpp"
_lib: Optional[ctypes.CDLL] = None
_tried = False
import threading as _threading  # noqa: E402

_build_lock = _threading.Lock()


def _build() -> Optional[pathlib.Path]:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    # the port builds inside its own package (vg_tpu_torch/_build/), so
    # its .so never shares a path with the JAX package's copy
    cache_dir = pathlib.Path(
        os.environ.get("VGTPU_TORCH_NATIVE_CACHE",
                       str(_HERE.parent / "_build")))
    cache_dir.mkdir(parents=True, exist_ok=True)
    so = cache_dir / f"vgtpu_host_{tag}.so"
    if so.exists():
        return so
    # per-process temporary: concurrent first builds (test workers) must
    # not write one file
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
           "-std=c++17", str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception as e:  # no toolchain / compile error: fall back
        sys.stderr.write(f"[vg_tpu.native] build skipped: {e}\n")
        return None
    tmp.replace(so)
    return so


def lib() -> Optional[ctypes.CDLL]:
    global _lib
    # lock-free fast path checks ONLY _lib: checking _tried here would
    # reopen the race this lock closes (a thread observing _tried=True
    # mid-build would silently fall back to the numpy twins — e.g. a
    # 131 Mbp prefix-doubling suffix array — for the whole process)
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None or _tried:
            return _lib
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    _tried = True
    if os.environ.get("VGTPU_NO_NATIVE"):
        return None
    # OpenMP workers must yield between batches: active spin-wait starves
    # the host pipeline threads and the device runtime on small machines
    os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
    os.environ.setdefault(
        "OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 4) - 1)))
    so = _build()
    if so is None:
        return None
    L = ctypes.CDLL(str(so))
    L.extract_minimizers.restype = ctypes.c_int64
    L.extract_minimizers.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    L.global_align.restype = ctypes.c_int64
    L.global_align.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    L.banded_traceback.restype = ctypes.c_int64
    L.banded_traceback.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
    _lib = L
    return _lib


def native_extract_minimizers(codes: np.ndarray, k: int, w: int):
    """C rolling-minimizer extraction; None if the native lib is absent."""
    L = lib()
    if L is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    n = len(codes)
    cap = max(n, 1)
    offs = np.empty(cap, np.int64)
    keys = np.empty(cap, np.uint64)
    rev = np.empty(cap, np.uint8)
    cnt = L.extract_minimizers(
        codes.ctypes.data, n, k, w, offs.ctypes.data, keys.ctypes.data,
        rev.ctypes.data)
    return offs[:cnt], keys[:cnt], rev[:cnt].astype(bool)


def native_banded_traceback(read: np.ndarray, window: np.ndarray,
                            B: int, scoring, x_drop: int = 0):
    """C banded DP traceback; returns a TextAlignment or None (no native
    lib / no alignment / edit overflow -> caller falls back). x_drop > 0
    enables the dozeu-style early exit (long-read tails)."""
    L_ = lib()
    if L_ is None:
        return None
    from ..ops.traceback import TextAlignment

    read = np.ascontiguousarray(read, np.uint8)
    window = np.ascontiguousarray(window, np.uint8)
    spans = np.zeros(4, np.int64)
    cap = 4 * (len(read) + 2 * B) + 16
    edits = np.zeros(cap * 3, np.int32)
    n_edits = np.zeros(1, np.int64)
    matches = np.zeros(1, np.int64)
    score = L_.banded_traceback(
        read.ctypes.data, len(read), window.ctypes.data, len(window), B,
        scoring.match, scoring.mismatch, scoring.gap_open,
        scoring.gap_extend, scoring.full_length_bonus,
        spans.ctypes.data, edits.ctypes.data, cap,
        n_edits.ctypes.data, matches.ctypes.data, int(x_drop))
    if score <= 0 or n_edits[0] < 0:
        return None if score <= 0 else False   # False = retry in python
    # edits arrive in reverse order as unit ops; merge into runs
    ops = edits[: n_edits[0] * 3].reshape(-1, 3)[::-1]
    merged = []
    for opc, ln, rp in ops:
        kind = "MXID"[opc]
        if merged and merged[-1][0] == kind and kind in ("M", "D"):
            merged[-1] = (kind, merged[-1][1] + 1)
        elif kind in ("M", "D"):
            merged.append((kind, 1))
        else:
            if merged and merged[-1][0] == kind:
                prev = merged[-1]
                merged[-1] = (kind, prev[1] + 1,
                              np.concatenate([prev[2], read[rp : rp + 1]]))
            else:
                merged.append((kind, 1, read[rp : rp + 1].copy()))
    return TextAlignment(
        score=int(score), read_start=int(spans[0]), read_end=int(spans[1]),
        text_start=int(spans[2]), text_end=int(spans[3]),
        edits=merged, matches=int(matches[0]))


def native_banded_tracebacks(reads: np.ndarray, rlen: np.ndarray,
                             wins: np.ndarray, B: int, scoring,
                             x_drop: int = 0):
    """Batched banded_traceback (one OpenMP call over n rows). reads
    (n, Lmax) oriented u8 padded with 5, rlen (n,), wins (n, TWmax) u8
    (row t's true window width = rlen[t] + 2B). Returns a list of
    TextAlignment | None per row (None also for rows whose edits
    overflowed — caller falls back per row), or None when the native
    lib is absent."""
    import ctypes

    L_ = lib()
    if L_ is None:
        return None
    if not hasattr(L_, "_btb_registered"):
        L_.banded_traceback_batch.restype = ctypes.c_int64
        L_.banded_traceback_batch.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32]
        L_._btb_registered = True
    from ..ops.traceback import TextAlignment

    reads = np.ascontiguousarray(reads, np.uint8)
    wins = np.ascontiguousarray(wins, np.uint8)
    rlen = np.ascontiguousarray(rlen, np.int64)
    n, Lmax = reads.shape
    TWmax = wins.shape[1]
    cap = 4 * (Lmax + 2 * B) + 16
    scores = np.zeros(n, np.int64)
    spans = np.zeros((n, 4), np.int64)
    edits = np.zeros((n, cap, 3), np.int32)
    n_edits = np.zeros(n, np.int64)
    matches = np.zeros(n, np.int64)
    L_.banded_traceback_batch(
        n, reads.ctypes.data, Lmax, rlen.ctypes.data,
        wins.ctypes.data, TWmax, B,
        scoring.match, scoring.mismatch, scoring.gap_open,
        scoring.gap_extend, scoring.full_length_bonus,
        scores.ctypes.data, spans.ctypes.data, edits.ctypes.data,
        cap, n_edits.ctypes.data, matches.ctypes.data, int(x_drop))
    out = []
    for t in range(n):
        if scores[t] <= 0 or n_edits[t] <= 0:
            out.append(None)
            continue
        ops = edits[t, : n_edits[t]][::-1]          # forward order
        opc = ops[:, 0]
        rp = ops[:, 2]
        brk = np.ones(len(opc), bool)
        brk[1:] = opc[1:] != opc[:-1]
        starts = np.nonzero(brk)[0]
        ends = np.append(starts[1:], len(opc))
        merged = []
        read_row = reads[t]
        for s0, e0 in zip(starts, ends):
            kind = "MXID"[opc[s0]]
            ln = int(e0 - s0)
            if kind in ("M", "D"):
                merged.append((kind, ln))
            else:
                r0 = int(rp[s0])
                merged.append((kind, ln, read_row[r0 : r0 + ln].copy()))
        out.append(TextAlignment(
            score=int(scores[t]), read_start=int(spans[t, 0]),
            read_end=int(spans[t, 1]), text_start=int(spans[t, 2]),
            text_end=int(spans[t, 3]), edits=merged,
            matches=int(matches[t])))
    return out


def native_global_align(a: np.ndarray, b: np.ndarray, scoring,
                        max_cells: int = 4_000_000):
    """C global alignment; None if native lib absent, False to fall back."""
    L_ = lib()
    if L_ is None:
        return None
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    cap = 2 * (len(a) + len(b)) + 16
    edits = np.zeros(cap * 3, np.int32)
    n_edits = np.zeros(1, np.int64)
    score = L_.global_align(
        a.ctypes.data, len(a), b.ctypes.data, len(b),
        scoring.match, scoring.mismatch, scoring.gap_open,
        scoring.gap_extend, max_cells, edits.ctypes.data, cap,
        n_edits.ctypes.data)
    if n_edits[0] < 0:
        return False
    ops = edits[: n_edits[0] * 3].reshape(-1, 3)[::-1]
    merged = []
    for opc, ln, rp in ops:
        kind = "MXID"[opc]
        if merged and merged[-1][0] == kind and kind in ("M", "D"):
            merged[-1] = (kind, merged[-1][1] + 1)
        elif kind in ("M", "D"):
            merged.append((kind, 1))
        else:
            if merged and merged[-1][0] == kind:
                prev = merged[-1]
                merged[-1] = (kind, prev[1] + 1,
                              np.concatenate([prev[2], a[rp : rp + 1]]))
            else:
                merged.append((kind, 1, a[rp : rp + 1].copy()))
    return int(score), merged


def _key_buckets(index):
    """(bucket_off int64, shift) over the sorted key array: bucket_off[b]
    = first index with key >= (b << shift). Narrows each key lookup's
    binary search from the full 8M-entry array (~23 DRAM misses) to one
    ~8-entry bucket. Built once per index, cached on the object."""
    kb = getattr(index, "_key_buckets", None)
    if kb is None:
        bits = 2 * index.k              # canonical kmer keys < 4^k
        shift = max(0, bits - 20)       # <= 2^20 buckets
        nb = 1 << (bits - shift)
        bounds = np.arange(1, nb + 1, dtype=np.uint64) << np.uint64(shift)
        off = np.zeros(nb + 1, np.int64)
        off[1:] = np.searchsorted(index.keys, bounds, side="left")
        kb = index._key_buckets = (off, shift)
    return kb


def _step_buckets(haps):
    """Same accelerator over step_text_pos[1..n] (the text-pos -> step
    refproj search): bucket width 1024 bp."""
    sb = getattr(haps, "_step_buckets", None)
    if sb is None:
        shift = 10
        T = len(haps.text)
        nb = (T >> shift) + 2
        sp = haps.step_text_pos[1 : 1 + len(haps.steps)]
        bounds = np.arange(1, nb + 1, dtype=np.int64) << shift
        off = np.zeros(nb + 1, np.int64)
        off[1:] = np.searchsorted(sp, bounds, side="left")
        sb = haps._step_buckets = (off, shift)
    return sb


def native_seed_prof():
    """(extract_s, lookup_s, cluster_s, refproj_s) thread-seconds when
    VGTPU_SEED_PROF=1; zeros otherwise."""
    L_ = lib()
    if L_ is None:
        return (0.0,) * 4
    if not hasattr(L_, "_seed_prof_registered"):
        L_.seed_prof.restype = None
        L_.seed_prof.argtypes = [ctypes.c_void_p]
        L_._seed_prof_registered = True
    out = np.zeros(4, np.int64)
    L_.seed_prof(out.ctypes.data)
    return tuple(float(x) / 1e9 for x in out)


def native_seed_batch(codes2d: np.ndarray, index, params, haps,
                      node_ref_path: np.ndarray, node_ref_off: np.ndarray):
    """Full batch seeding in C++ (minimizers -> lookup -> soft caps ->
    diagonal clustering -> top-C candidates), OpenMP over reads. Returns
    the same 7-tuple as GiraffeMapper._seed_batch, or None when the
    native lib is absent."""
    import ctypes

    L_ = lib()
    if L_ is None:
        return None
    if not hasattr(L_, "_seed_registered"):
        L_.seed_batch.restype = ctypes.c_int64
        L_.seed_batch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int32, ctypes.c_int32]
            + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
               ctypes.c_int32, ctypes.c_int32]
            + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_void_p, ctypes.c_int32,
               ctypes.c_void_p, ctypes.c_int32]
            + [ctypes.c_void_p] * 7)
        L_._seed_registered = True
    codes2d = np.ascontiguousarray(codes2d, np.uint8)
    R, L = codes2d.shape
    C = params.max_candidates
    cand_start = np.zeros((R, C), np.int32)
    cand_lo = np.zeros((R, C), np.int32)
    cand_hi = np.zeros((R, C), np.int32)
    cand_rev = np.zeros((R, C), np.uint8)
    cand_valid = np.zeros((R, C), np.uint8)
    cand_refpath = np.full((R, C), -1, np.int32)
    cand_refoff = np.zeros((R, C), np.int64)
    pos_rev = np.ascontiguousarray(index.pos_rev, np.uint8)
    kb_off, kb_shift = _key_buckets(index)
    sb_off, sb_shift = _step_buckets(haps)
    rc = L_.seed_batch(
        codes2d.ctypes.data, R, L, index.k, index.w,
        index.keys.ctypes.data, len(index.keys), index.offsets.ctypes.data,
        index.pos_text.ctypes.data, pos_rev.ctypes.data,
        params.hit_cap, params.hard_hit_cap,
        ctypes.c_double(params.score_fraction),
        C, params.band_radius,
        haps.text_start.ctypes.data, len(haps.text_start) - 1,
        haps.step_text_pos.ctypes.data, haps.steps.ctypes.data,
        len(haps.steps), haps.graph.seq_start.ctypes.data,
        node_ref_path.ctypes.data, node_ref_off.ctypes.data,
        len(haps.text),
        kb_off.ctypes.data, kb_shift, sb_off.ctypes.data, sb_shift,
        cand_start.ctypes.data, cand_lo.ctypes.data, cand_hi.ctypes.data,
        cand_rev.ctypes.data, cand_valid.ctypes.data,
        cand_refpath.ctypes.data, cand_refoff.ctypes.data)
    if rc != 0:
        return None
    return (cand_start, cand_lo, cand_hi, cand_rev.astype(bool),
            cand_valid.astype(bool), cand_refpath, cand_refoff)


def native_encode_pack_reads(seq_blob: bytes, R: int, L: int,
                             Rpad: int, RL: int, exc_cap: int,
                             want_packed: bool = True):
    """Fused ASCII->codes/revcomp/2-bit-wire for an equal-length read
    batch (see encode_pack_reads in vgtpu_host.cpp). Returns
    (codes2d (Rpad,RL) u8, rc2d, packed (Rpad,W) i32, exc (<=cap) i32,
    n_exc_total) or None when the native lib is absent. want_packed=
    False skips the 2-bit wire (packed comes back None) — single-end
    dispatch and 4-bit-wire mappers never consume it."""
    import ctypes

    L_ = lib()
    if L_ is None:
        return None
    if not hasattr(L_, "_epr_registered"):
        L_.encode_pack_reads.restype = ctypes.c_int64
        L_.encode_pack_reads.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64]
        L_._epr_registered = True
    W = -(-RL // 16)
    codes = np.empty((Rpad, RL), np.uint8)
    rc = np.empty((Rpad, RL), np.uint8)
    packed = np.zeros((Rpad, W), np.int32) if want_packed else None
    exc = np.empty(max(exc_cap, 1), np.int32)
    blob = np.frombuffer(seq_blob, np.uint8)
    if blob.size != R * L:
        return None
    n = L_.encode_pack_reads(
        blob.ctypes.data, R, L, Rpad, RL, W,
        codes.ctypes.data, rc.ctypes.data,
        packed.ctypes.data if packed is not None else None,
        exc.ctypes.data, exc_cap)
    if n < 0:
        return None
    return codes, rc, packed, exc[:min(int(n), exc_cap)], int(n)


def native_banded_scores_host(reads: np.ndarray, wins: np.ndarray,
                              rlen: np.ndarray, B: int, scoring):
    """Score-only banded DP on the host for small batches (rescue).
    reads (n, L) u8 oriented+padded, wins (n, TW) u8. Returns (n,) int32
    scores, or None when the native lib is absent."""
    import ctypes

    L_ = lib()
    if L_ is None:
        return None
    if not hasattr(L_, "_bsh_registered"):
        L_.banded_scores_host.restype = None
        L_.banded_scores_host.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
        L_._bsh_registered = True
    reads = np.ascontiguousarray(reads, np.uint8)
    wins = np.ascontiguousarray(wins, np.uint8)
    rlen = np.ascontiguousarray(rlen, np.int32)
    n, L = reads.shape
    TW = wins.shape[1]
    out = np.empty(n, np.int32)
    L_.banded_scores_host(
        reads.ctypes.data, wins.ctypes.data, n, L, TW, B,
        scoring.match, scoring.mismatch, scoring.gap_open,
        scoring.gap_extend, scoring.full_length_bonus,
        rlen.ctypes.data, out.ctypes.data)
    return out


def native_global_align_batch(a_parts, b_parts, scoring,
                              max_cells: int = 4_000_000):
    """Align many (a, b) sequence pairs globally in one native call.
    Returns (scores, ok, runs, runs_off) where runs is an (n, 3) int32
    array of merged (op, len, read_start) rows in forward order, or None
    when the lib is absent."""
    import ctypes

    L_ = lib()
    if L_ is None:
        return None
    if not hasattr(L_, "_gab_registered"):
        L_.global_align_batch.restype = ctypes.c_int64
        L_.global_align_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        L_._gab_registered = True
    n = len(a_parts)
    aoff = np.zeros(n + 1, np.int64)
    np.cumsum([len(x) for x in a_parts], out=aoff[1:])
    boff = np.zeros(n + 1, np.int64)
    np.cumsum([len(x) for x in b_parts], out=boff[1:])
    abuf = (np.concatenate(a_parts) if n and aoff[-1] else
            np.zeros(1, np.uint8)).astype(np.uint8)
    bbuf = (np.concatenate(b_parts) if n and boff[-1] else
            np.zeros(1, np.uint8)).astype(np.uint8)
    cap = int(aoff[-1] + boff[-1]) * 2 + 16 * n + 64
    while True:
        scores = np.zeros(n, np.int32)
        ok = np.zeros(n, np.int8)
        runs = np.zeros((cap, 3), np.int32)
        runs_off = np.zeros(n + 1, np.int64)
        rc = L_.global_align_batch(
            abuf.ctypes.data, aoff.ctypes.data, bbuf.ctypes.data,
            boff.ctypes.data, n, scoring.match, scoring.mismatch,
            scoring.gap_open, scoring.gap_extend, max_cells,
            scores.ctypes.data, ok.ctypes.data, runs.ctypes.data, cap,
            runs_off.ctypes.data)
        if rc >= 0:
            return scores, ok.astype(bool), runs, runs_off
        cap *= 2


def native_chain_anchors(roff: np.ndarray, tpos: np.ndarray,
                         ascore: np.ndarray, J: int, k: int,
                         max_lookback: int, max_indel: int,
                         gap_scale: float, gap_open: float):
    """Colinear chaining DP in C++; None when the lib is absent."""
    import ctypes

    L_ = lib()
    if L_ is None:
        return None
    if not hasattr(L_, "_chain_registered"):
        L_.chain_anchors_dp.restype = None
        L_.chain_anchors_dp.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
            ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p]
        L_._chain_registered = True
    roff = np.ascontiguousarray(roff, np.int64)
    tpos = np.ascontiguousarray(tpos, np.int64)
    ascore = np.ascontiguousarray(ascore, np.float64)
    n = len(roff)
    f = np.empty(n, np.float64)
    parent = np.empty(n, np.int64)
    L_.chain_anchors_dp(
        roff.ctypes.data, tpos.ctypes.data, ascore.ctypes.data, n, J, k,
        max_lookback, max_indel, ctypes.c_double(gap_scale),
        ctypes.c_double(gap_open), f.ctypes.data, parent.ctypes.data)
    return f, parent


def native_build_suffix_array(text: np.ndarray):
    """Suffix array of the haplotype text (prefix doubling, C++);
    None when the native lib is absent."""
    import ctypes

    L_ = lib()
    if L_ is None:
        return None
    if not hasattr(L_, "_sa_registered"):
        _register_sa(L_)
    text = np.ascontiguousarray(text, np.uint8)
    sa = np.empty(len(text), np.int32)
    L_.build_suffix_array(text.ctypes.data, len(text), sa.ctypes.data)
    return sa


def _register_sa(L_):
    """argtype registration shared by the SA/MEM wrappers (previously
    find_mems triggered it by running a pointless 1-element SA build)."""
    L_.build_suffix_array.restype = ctypes.c_int64
    L_.build_suffix_array.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_void_p]
    L_.find_mems.restype = ctypes.c_int64
    L_.find_mems.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
    L_._sa_registered = True


def native_find_mems(text: np.ndarray, sa: np.ndarray, read: np.ndarray,
                     min_len: int = 19, max_hits: int = 64,
                     cap: int = 4096, emit_over_cap: bool = False):
    """(read_start, length, text_pos) arrays of the read's MEMs. With
    emit_over_cap, a MEM whose count exceeds max_hits yields ONE
    sentinel row with text_pos = -count (the sharded merge needs every
    chunk's count to apply the repetitive filter globally)."""
    L_ = lib()
    if L_ is None:
        return None
    if not hasattr(L_, "_sa_registered"):
        _register_sa(L_)
    read = np.ascontiguousarray(read, np.uint8)
    rs = np.empty(cap, np.int32)
    ln = np.empty(cap, np.int32)
    tp = np.empty(cap, np.int64)
    n = L_.find_mems(
        np.ascontiguousarray(text, np.uint8).ctypes.data, len(text),
        np.ascontiguousarray(sa, np.int32).ctypes.data,
        read.ctypes.data, len(read), min_len, max_hits, cap,
        rs.ctypes.data, ln.ctypes.data, tp.ctypes.data,
        1 if emit_over_cap else 0)
    return rs[:n], ln[:n], tp[:n]


def native_find_mems_many(text: np.ndarray, sa: np.ndarray,
                          reads2d: np.ndarray, rlen: np.ndarray,
                          min_len: int = 19, max_hits: int = 64,
                          cap: int = 4096, emit_over_cap: bool = False,
                          bufs=None):
    """MEM queries for many oriented reads vs one SA in one OpenMP
    call. reads2d (n, Lmax) u8 padded with 5+. Returns a list of
    (read_start, length, text_pos) per read, or None if lib absent.
    emit_over_cap: see native_find_mems. bufs: optional (rs, ln, tp,
    nr) output buffers to reuse across calls — the sharded index
    queries every chunk with the same shapes, and re-allocating
    3 x (n, cap) buffers per chunk dominated the rescue path's memory
    traffic."""
    import ctypes

    L_ = lib()
    if L_ is None:
        return None
    if not hasattr(L_, "_fmm_registered"):
        L_.find_mems_many.restype = ctypes.c_int64
        L_.find_mems_many.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
        L_._fmm_registered = True
    reads2d = np.ascontiguousarray(reads2d, np.uint8)
    rlen = np.ascontiguousarray(rlen, np.int64)
    n_reads, Lmax = reads2d.shape
    if (bufs is not None and len(bufs) == 4 and bufs[0] is not None
            and bufs[0].shape == (n_reads, cap)):
        rs, ln, tp, nr = bufs
    else:
        rs = np.empty((n_reads, cap), np.int32)
        ln = np.empty((n_reads, cap), np.int32)
        tp = np.empty((n_reads, cap), np.int64)
        nr = np.empty(n_reads, np.int64)
        if bufs is not None:
            bufs[:] = [rs, ln, tp, nr]
    L_.find_mems_many(
        np.ascontiguousarray(text, np.uint8).ctypes.data, len(text),
        np.ascontiguousarray(sa, np.int32).ctypes.data,
        reads2d.ctypes.data, Lmax, rlen.ctypes.data, n_reads,
        min_len, max_hits, cap,
        rs.ctypes.data, ln.ctypes.data, tp.ctypes.data, nr.ctypes.data,
        1 if emit_over_cap else 0)
    return [(rs[r, : nr[r]].copy(), ln[r, : nr[r]].copy(),
             tp[r, : nr[r]].copy()) for r in range(n_reads)]


def native_extract_minimizers_batch(codes2d: np.ndarray, k: int, w: int):
    """Batch rolling-minimizer extraction in C; None if lib absent."""
    import ctypes

    L_ = lib()
    if L_ is None:
        return None
    if not hasattr(L_, "_batch_registered"):
        L_.extract_minimizers_batch.restype = ctypes.c_int64
        L_.extract_minimizers_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64]
        L_._batch_registered = True
    codes2d = np.ascontiguousarray(codes2d, np.uint8)
    R, L = codes2d.shape
    cap = R * L
    ridx = np.empty(cap, np.int64)
    offs = np.empty(cap, np.int64)
    keys = np.empty(cap, np.uint64)
    rev = np.empty(cap, np.uint8)
    n = L_.extract_minimizers_batch(
        codes2d.ctypes.data, R, L, k, w, ridx.ctypes.data,
        offs.ctypes.data, keys.ctypes.data, rev.ctypes.data, cap)
    if n < 0:
        return None
    return ridx[:n], offs[:n], keys[:n], rev[:n].astype(bool)


def native_longread_stitch(codes_list, chain_read, chain_rev, anc_roff,
                           anc_tpos, anc_off, k, text, hap_starts,
                           scoring, lr_params, max_cells: int = 4_000_000,
                           resolver=None):
    """Batch long-read chain stitching in C++ (merge blocks, align links,
    error-model guard, segment, banded tails) — the host loop that
    dominated long-read throughput. Returns per-chain
    (ok, score, matches, read_start, read_end, t0, t1, runs, runs_off)
    or None when the lib is absent.

    resolver = (scores i64, ok u8, runs (n,3) i32, runs_off i64,
    chain_task_off i64) pre-resolved slow-link DPs (the device link
    engine, ops/device_links.py) consumed in traversal order; None =
    solve links here."""
    import ctypes

    L_ = lib()
    if L_ is None:
        return None
    if not hasattr(L_, "_lrs_registered"):
        L_.longread_stitch_batch.restype = ctypes.c_int64
        L_.longread_stitch_batch.argtypes = (
            [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int32,
             ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_int32] * 5
            + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
               ctypes.c_int32]
            + [ctypes.c_double] * 6
            + [ctypes.c_int64]
            + [ctypes.c_void_p] * 5          # resolver (nullable)
            + [ctypes.c_void_p] * 7
            + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p])
        L_._lrs_registered = True
    n_reads = len(codes_list)
    read_off = np.zeros(n_reads + 1, np.int64)
    np.cumsum([len(c) for c in codes_list], out=read_off[1:])
    blob = (np.concatenate(codes_list) if n_reads else
            np.zeros(1, np.uint8)).astype(np.uint8)
    nc = len(chain_read)
    chain_read = np.ascontiguousarray(chain_read, np.int32)
    chain_rev = np.ascontiguousarray(chain_rev, np.uint8)
    anc_off = np.ascontiguousarray(anc_off, np.int64)
    anc_roff = np.ascontiguousarray(anc_roff, np.int64)
    anc_tpos = np.ascontiguousarray(anc_tpos, np.int64)
    text = np.ascontiguousarray(text, np.uint8)
    hap_starts = np.ascontiguousarray(hap_starts, np.int64)
    out_score = np.zeros(nc, np.int32)
    out_matches = np.zeros(nc, np.int64)
    out_rs = np.zeros(nc, np.int64)
    out_re = np.zeros(nc, np.int64)
    out_t0 = np.zeros(nc, np.int64)
    out_t1 = np.zeros(nc, np.int64)
    out_ok = np.zeros(nc, np.uint8)
    cap = int(anc_off[-1]) * 4 + int(read_off[-1]) // 4 + 64 * max(nc, 1)
    while True:
        runs = np.zeros((cap, 3), np.int32)
        runs_off = np.zeros(nc + 1, np.int64)
        rc = L_.longread_stitch_batch(
            n_reads, read_off.ctypes.data, blob.ctypes.data,
            nc, chain_read.ctypes.data, chain_rev.ctypes.data,
            anc_off.ctypes.data, anc_roff.ctypes.data,
            anc_tpos.ctypes.data, k,
            text.ctypes.data, len(text),
            hap_starts.ctypes.data, len(hap_starts) - 1,
            scoring.match, scoring.mismatch, scoring.gap_open,
            scoring.gap_extend, scoring.full_length_bonus,
            lr_params.max_link_len, lr_params.max_tail,
            lr_params.tail_band, getattr(lr_params, "x_drop", 0),
            lr_params.link_mismatch_base, lr_params.link_mismatch_per_base,
            float(lr_params.link_mismatch_cap),
            lr_params.link_gap_base, lr_params.link_gap_per_base,
            float(lr_params.link_gap_cap),
            max_cells,
            *(tuple(a.ctypes.data for a in resolver)
              if resolver is not None else (None,) * 5),
            out_score.ctypes.data, out_matches.ctypes.data,
            out_rs.ctypes.data, out_re.ctypes.data,
            out_t0.ctypes.data, out_t1.ctypes.data, out_ok.ctypes.data,
            runs.ctypes.data, cap, runs_off.ctypes.data)
        if rc == 0:
            return (out_ok.astype(bool), out_score, out_matches, out_rs,
                    out_re, out_t0, out_t1, runs, runs_off)
        cap *= 2


def native_longread_chains(codes_list, index, lr_params, chain_params,
                           chain_frac: float = 0.7):
    """Pass 1 of the device link offload: anchors -> chain DP -> kept
    chains, exported flat. Returns (chain_read i32, chain_rev u8,
    anc_off i64, roffs i64, tposs i64) or None when the lib is absent."""
    L_ = lib()
    if L_ is None:
        return None
    if not hasattr(L_, "_lrc_registered"):
        L_.longread_chains_batch.restype = ctypes.c_int64
        L_.longread_chains_batch.argtypes = (
            [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
               ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int32] * 2
            + [ctypes.c_int32] * 3
            + [ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
               ctypes.c_double, ctypes.c_double, ctypes.c_double,
               ctypes.c_int32, ctypes.c_double]
            + [ctypes.c_void_p, ctypes.c_int32]
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
               ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
               ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p])
        L_._lrc_registered = True
    n_reads = len(codes_list)
    read_off = np.zeros(n_reads + 1, np.int64)
    np.cumsum([len(c) for c in codes_list], out=read_off[1:])
    blob = (np.concatenate(codes_list) if n_reads else
            np.zeros(1, np.uint8)).astype(np.uint8)
    keys = np.ascontiguousarray(index.keys, np.uint64)
    offsets = np.ascontiguousarray(index.offsets, np.int64)
    pos_text = np.ascontiguousarray(index.pos_text, np.int64)
    pos_rev = np.ascontiguousarray(index.pos_rev, np.uint8)
    C = chain_params.max_chains
    chains_cap = max(n_reads * C, 8)
    anchors_cap = max(int(read_off[-1]) // 8, 1024)
    kb_off, kb_shift = _key_buckets(index)
    while True:
        chain_read = np.zeros(chains_cap, np.int32)
        chain_rev = np.zeros(chains_cap, np.uint8)
        anc_off = np.zeros(chains_cap + 1, np.int64)
        roffs = np.zeros(anchors_cap, np.int64)
        tposs = np.zeros(anchors_cap, np.int64)
        n_out = np.zeros(2, np.int64)
        rc = L_.longread_chains_batch(
            n_reads, read_off.ctypes.data, blob.ctypes.data,
            keys.ctypes.data, offsets.ctypes.data, len(keys),
            pos_text.ctypes.data, pos_rev.ctypes.data,
            index.k, index.w,
            lr_params.hard_hit_cap, lr_params.max_seeds_per_window,
            lr_params.downsample_window,
            chain_params.lookback_cands, chain_params.max_lookback,
            chain_params.max_indel, chain_params.gap_scale,
            chain_params.gap_open, chain_params.min_chain_score,
            C, chain_frac,
            kb_off.ctypes.data, kb_shift,
            chain_read.ctypes.data, chain_rev.ctypes.data, chains_cap,
            anc_off.ctypes.data, roffs.ctypes.data, tposs.ctypes.data,
            anchors_cap, n_out[:1].ctypes.data, n_out[1:].ctypes.data)
        if rc == 0:
            nc, na = int(n_out[0]), int(n_out[1])
            return (chain_read[:nc], chain_rev[:nc], anc_off[: nc + 1],
                    roffs[:na], tposs[:na])
        chains_cap *= 2
        anchors_cap *= 2


def native_longread_collect_links(codes_list, chain_read, chain_rev,
                                  anc_off, roffs, tposs, k, text,
                                  hap_starts, scoring, lr_params,
                                  max_cells: int = 4_000_000):
    """Slow-link task list for the device engine, in stitch traversal
    order: (chain_task_off i64 (n_chains+1), tasks (n,4) i64 =
    (ra, la, ta, lb)) or None when the lib is absent."""
    L_ = lib()
    if L_ is None:
        return None
    if not hasattr(L_, "_lrcl_registered"):
        L_.longread_collect_links.restype = ctypes.c_int64
        L_.longread_collect_links.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int32,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_int32] * 5
            + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
               ctypes.c_int32]
            + [ctypes.c_double] * 6
            + [ctypes.c_int64]
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
               ctypes.c_void_p])
        L_._lrcl_registered = True
    n_reads = len(codes_list)
    read_off = np.zeros(n_reads + 1, np.int64)
    np.cumsum([len(c) for c in codes_list], out=read_off[1:])
    blob = (np.concatenate(codes_list) if n_reads else
            np.zeros(1, np.uint8)).astype(np.uint8)
    nc = len(chain_read)
    text = np.ascontiguousarray(text, np.uint8)
    hap_starts = np.ascontiguousarray(hap_starts, np.int64)
    tasks_cap = max(64 * max(nc, 1), 1024)
    while True:
        chain_task_off = np.zeros(nc + 1, np.int64)
        tasks = np.zeros((tasks_cap, 4), np.int64)
        n_out = np.zeros(1, np.int64)
        rc = L_.longread_collect_links(
            read_off.ctypes.data, blob.ctypes.data,
            nc, np.ascontiguousarray(chain_read, np.int32).ctypes.data,
            np.ascontiguousarray(chain_rev, np.uint8).ctypes.data,
            np.ascontiguousarray(anc_off, np.int64).ctypes.data,
            np.ascontiguousarray(roffs, np.int64).ctypes.data,
            np.ascontiguousarray(tposs, np.int64).ctypes.data, k,
            text.ctypes.data, hap_starts.ctypes.data,
            len(hap_starts) - 1,
            scoring.match, scoring.mismatch, scoring.gap_open,
            scoring.gap_extend, scoring.full_length_bonus,
            lr_params.max_link_len, lr_params.max_tail,
            lr_params.tail_band, getattr(lr_params, "x_drop", 0),
            lr_params.link_mismatch_base, lr_params.link_mismatch_per_base,
            float(lr_params.link_mismatch_cap),
            lr_params.link_gap_base, lr_params.link_gap_per_base,
            float(lr_params.link_gap_cap),
            max_cells,
            chain_task_off.ctypes.data, tasks.ctypes.data, tasks_cap,
            n_out.ctypes.data)
        if rc == 0:
            return chain_task_off, tasks[: int(n_out[0])]
        tasks_cap *= 2


def native_emit_runs_gam(arrs, out_cap: int = 0):
    """Run-based GAM record encoder (indels included). arrs: see
    LongReadMapper.map_batch_encoded. Returns (buffer, rec_offsets) or None when the lib is absent."""
    import ctypes

    L_ = lib()
    if L_ is None:
        return None
    if not hasattr(L_, "_erg_registered"):
        L_.emit_runs_gam.restype = ctypes.c_int64
        L_.emit_runs_gam.argtypes = (
            [ctypes.c_int64]
            + [ctypes.c_void_p] * 15        # t0..runs_off
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_void_p] * 7
            + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p])
        L_._erg_registered = True
    N = int(arrs["N"])
    c = lambda a, dt: np.ascontiguousarray(a, dt)
    t0 = c(arrs["t0"], np.int64)
    rev = c(arrs["rev"], np.uint8)
    mapq = c(arrs["mapq"], np.int32)
    score = c(arrs["score"], np.int32)
    matches = c(arrs["matches"], np.int64)
    rs = c(arrs["read_start"], np.int64)
    re_ = c(arrs["read_end"], np.int64)
    runs = c(arrs["runs"], np.int32)
    runs_off = c(arrs["runs_off"], np.int64)
    if not out_cap:
        out_cap = int(arrs["read_off"][-1]) * 6 + N * 1024 \
            + int(runs_off[-1]) * 48 + 4096
    while True:
        out = np.empty(out_cap, np.uint8)   # encoder overwrites its span
        rec_off = np.zeros(N + 1, np.int64)
        rc = L_.emit_runs_gam(
            N, t0.ctypes.data, rev.ctypes.data, mapq.ctypes.data,
            score.ctypes.data, matches.ctypes.data, rs.ctypes.data,
            re_.ctypes.data,
            arrs["name_off"].ctypes.data, arrs["names"].ctypes.data,
            arrs["read_off"].ctypes.data, arrs["reads"].ctypes.data,
            arrs["qual_off"].ctypes.data, arrs["quals"].ctypes.data,
            runs.ctypes.data, runs_off.ctypes.data,
            arrs["step_text_pos"].ctypes.data, arrs["steps"].ctypes.data,
            ctypes.c_int64(int(arrs["n_steps"])),
            arrs["node_id"].ctypes.data, arrs["seq_start"].ctypes.data,
            arrs["ref_path"].ctypes.data, arrs["ref_off"].ctypes.data,
            arrs["ref_rev"].ctypes.data,
            arrs["refname_off"].ctypes.data, arrs["refnames"].ctypes.data,
            out.ctypes.data, out_cap, rec_off.ctypes.data)
        if rc == 0:
            return out, rec_off
        out_cap *= 2


def native_lr_prof():
    """(anchor_s, chain_s, stitch_s, link_s, link_cells, link_calls,
    tail_s) accumulated across threads when VGTPU_LR_PROF=1 was set
    before the batch calls; zeros otherwise. Times in seconds, counts
    raw."""
    L_ = lib()
    if L_ is None:
        return (0.0,) * 4 + (0, 0, 0.0)
    if not hasattr(L_, "_lr_prof_registered"):
        L_.lr_prof.restype = None
        L_.lr_prof.argtypes = [ctypes.c_void_p]
        L_._lr_prof_registered = True
    out = np.zeros(7, np.int64)
    L_.lr_prof(out.ctypes.data)
    return (float(out[0]) / 1e9, float(out[1]) / 1e9, float(out[2]) / 1e9,
            float(out[3]) / 1e9, int(out[4]), int(out[5]),
            float(out[6]) / 1e9)


def native_longread_map_batch(codes_list, index, lr_params, chain_params,
                              text, hap_starts, scoring,
                              max_cells: int = 4_000_000,
                              chain_frac: float = 0.7):
    """Fused long-read mapping in C++: minimizer anchors -> chain DP ->
    greedy chains -> stitch, OpenMP over reads. Returns
    (n_out, rev, score, matches, read_start, read_end, t0, t1, runs,
    runs_off) with max_chains slots per read, or None when absent."""
    import ctypes

    L_ = lib()
    if L_ is None:
        return None
    if not hasattr(L_, "_lrm_registered"):
        L_.longread_map_batch.restype = ctypes.c_int64
        L_.longread_map_batch.argtypes = (
            [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
               ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int32] * 2
            + [ctypes.c_int32] * 3
            + [ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
               ctypes.c_double, ctypes.c_double, ctypes.c_double,
               ctypes.c_int32, ctypes.c_double]
            + [ctypes.c_void_p, ctypes.c_int64,
               ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_int32] * 5
            + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
               ctypes.c_int32]
            + [ctypes.c_double] * 6
            + [ctypes.c_int64]
            + [ctypes.c_void_p, ctypes.c_int32]
            + [ctypes.c_void_p] * 8
            + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p])
        L_._lrm_registered = True
    n_reads = len(codes_list)
    read_off = np.zeros(n_reads + 1, np.int64)
    np.cumsum([len(c) for c in codes_list], out=read_off[1:])
    blob = (np.concatenate(codes_list) if n_reads else
            np.zeros(1, np.uint8)).astype(np.uint8)
    keys = np.ascontiguousarray(index.keys, np.uint64)
    offsets = np.ascontiguousarray(index.offsets, np.int64)
    pos_text = np.ascontiguousarray(index.pos_text, np.int64)
    pos_rev = np.ascontiguousarray(index.pos_rev, np.uint8)
    text = np.ascontiguousarray(text, np.uint8)
    hap_starts = np.ascontiguousarray(hap_starts, np.int64)
    C = chain_params.max_chains
    total = n_reads * C
    n_out = np.zeros(n_reads, np.int32)
    rev = np.zeros(total, np.uint8)
    score = np.zeros(total, np.int32)
    matches = np.zeros(total, np.int64)
    rs = np.zeros(total, np.int64)
    re_ = np.zeros(total, np.int64)
    t0 = np.zeros(total, np.int64)
    t1 = np.zeros(total, np.int64)
    cap = int(read_off[-1]) // 2 + 64 * max(total, 1)
    while True:
        runs = np.zeros((cap, 3), np.int32)
        runs_off = np.zeros(total + 1, np.int64)
        rc = L_.longread_map_batch(
            n_reads, read_off.ctypes.data, blob.ctypes.data,
            keys.ctypes.data, offsets.ctypes.data, len(keys),
            pos_text.ctypes.data, pos_rev.ctypes.data,
            index.k, index.w,
            lr_params.hard_hit_cap, lr_params.max_seeds_per_window,
            lr_params.downsample_window,
            chain_params.lookback_cands, chain_params.max_lookback,
            chain_params.max_indel, chain_params.gap_scale,
            chain_params.gap_open, chain_params.min_chain_score,
            C, chain_frac,
            text.ctypes.data, len(text),
            hap_starts.ctypes.data, len(hap_starts) - 1,
            scoring.match, scoring.mismatch, scoring.gap_open,
            scoring.gap_extend, scoring.full_length_bonus,
            lr_params.max_link_len, lr_params.max_tail,
            lr_params.tail_band, getattr(lr_params, "x_drop", 0),
            lr_params.link_mismatch_base, lr_params.link_mismatch_per_base,
            float(lr_params.link_mismatch_cap),
            lr_params.link_gap_base, lr_params.link_gap_per_base,
            float(lr_params.link_gap_cap),
            max_cells,
            _key_buckets(index)[0].ctypes.data, _key_buckets(index)[1],
            n_out.ctypes.data, rev.ctypes.data, score.ctypes.data,
            matches.ctypes.data, rs.ctypes.data, re_.ctypes.data,
            t0.ctypes.data, t1.ctypes.data,
            runs.ctypes.data, cap, runs_off.ctypes.data)
        if rc == 0:
            return (n_out, rev, score, matches, rs, re_, t0, t1,
                    runs, runs_off)
        cap *= 2


def native_dag_align(dag, read: np.ndarray, scoring, mode: str):
    """POA fill + traceback over a flattened base-level DAG in C++
    (ops/graph_align.py _align_dag twin; reference gssw role,
    src/aligner.cpp:30-300). Returns (score, matches, sv, sf, st, slo,
    shi) step arrays in reverse-traceback order, None for no alignment,
    or NotImplemented when the native lib is absent."""
    L_ = lib()
    if L_ is None:
        return NotImplemented
    if not hasattr(L_, "_dag_align_registered"):
        L_.dag_align.restype = ctypes.c_int64
        L_.dag_align.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,               # codes, V
            ctypes.c_void_p, ctypes.c_void_p,              # pred_off, preds
            ctypes.c_void_p,                               # is_sink
            ctypes.c_void_p, ctypes.c_int64,               # read, L
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,              # sv sf st slo shi
            ctypes.c_int64, ctypes.c_void_p,               # cap, n_steps
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        L_._dag_align_registered = True
    csr = getattr(dag, "_csr", None)
    if csr is None:
        V = len(dag.codes)
        pred_off = np.zeros(V + 1, np.int64)
        np.cumsum([len(p) for p in dag.preds], out=pred_off[1:])
        flat = np.fromiter((q for p in dag.preds for q in p),
                           np.int32, count=int(pred_off[-1]))
        csr = (pred_off, flat,
               np.ascontiguousarray(dag.is_sink, np.uint8),
               np.ascontiguousarray(dag.codes, np.uint8))
        dag._csr = csr
    pred_off, flat, sink_u8, codes_u8 = csr
    V = len(codes_u8)
    if not getattr(dag, "_topo_checked", False):
        # the C++ fill zero-initializes H/E (numpy twin uses NEG) and
        # seeds Fv[0]=NEG; that shortcut is only correct because every
        # predecessor index precedes its vertex (topological emission by
        # _flatten/_flatten_dagified). A producer violating that would
        # silently diverge from the numpy twin — fail loudly instead.
        if len(flat) and not bool(
                np.all(flat < np.repeat(np.arange(V), np.diff(pred_off)))):
            raise ValueError("dag_align: preds must be topologically "
                             "ordered (pred index < vertex index)")
        dag._topo_checked = True
    read = np.ascontiguousarray(read, np.uint8)
    L = len(read)
    cap = V + 2 * L + 8
    sv = np.empty(cap, np.int32)
    sf = np.empty(cap, np.int32)
    st = np.empty(cap, np.int32)
    slo = np.empty(cap, np.int32)
    shi = np.empty(cap, np.int32)
    n_steps = np.zeros(1, np.int64)
    matches = np.zeros(1, np.int64)
    best_v = np.zeros(1, np.int32)
    best_i = np.zeros(1, np.int32)
    NEG = -100000000
    score = L_.dag_align(
        codes_u8.ctypes.data, V,
        pred_off.ctypes.data, flat.ctypes.data, sink_u8.ctypes.data,
        read.ctypes.data, L,
        scoring.match, scoring.mismatch, scoring.gap_open,
        scoring.gap_extend, scoring.full_length_bonus,
        1 if mode == "local" else 0,
        sv.ctypes.data, sf.ctypes.data, st.ctypes.data,
        slo.ctypes.data, shi.ctypes.data,
        cap, n_steps.ctypes.data, matches.ctypes.data,
        best_v.ctypes.data, best_i.ctypes.data)
    if score == NEG:
        return None
    if score == NEG - 1:   # steps overflow: impossible by construction,
        return NotImplemented   # but fall back rather than truncate
    n = int(n_steps[0])
    return (int(score), int(matches[0]),
            sv[:n], sf[:n], st[:n], slo[:n], shi[:n])
