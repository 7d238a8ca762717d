"""Build a CUDA C++ source of the port into a shared library, once.

Each kernel source under vg_tpu_torch/csrc/ has a plain C interface
(device pointers and the stream as void*, an int error code back) and is
compiled by nvcc for sm_90a into vg_tpu_torch/_build/ (or the directory
VGTPU_TORCH_KERNEL_CACHE names) on first use, under a name keyed on a
hash of the source and the flags, then loaded with ctypes. Nothing is
built when a module is imported: the CPU tests import every module and
this machine may have no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

PKG = pathlib.Path(__file__).resolve().parent.parent
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "vg_tpu_torch/csrc/ on first use and need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def build(src: pathlib.Path, info: dict, defines=()) -> ctypes.CDLL:
    """Compile `src` (unless a library of the same source and flags is
    already built), load it and fill `info` with its path, the seconds
    the build and load took and the ptxas report. `defines` are extra
    nvcc -D definitions ("NAME=VALUE"). Raises on any build or load
    failure. Callers serialise builds of one source themselves, so that
    different sources build in parallel."""
    text = src.read_bytes()
    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    tag = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    build_dir = pathlib.Path(os.environ.get(
        "VGTPU_TORCH_KERNEL_CACHE", str(PKG / "_build")))
    build_dir.mkdir(parents=True, exist_ok=True)
    so = build_dir / f"{src.stem}_{tag}.so"
    report = build_dir / f"{src.stem}_{tag}.ptxas.txt"
    t0 = time.perf_counter()
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc(), *flags, str(src), "-o", str(tmp)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"({res.returncode}):\n{res.stderr[-4000:]}")
        report.write_text(res.stdout + res.stderr)
        tmp.replace(so)
    lib = ctypes.CDLL(str(so))
    info.update(path=str(so), seconds=time.perf_counter() - t0,
                ptxas=report.read_text() if report.exists() else "")
    return lib


def launch_args(t) -> tuple:
    """(device index, stream handle) of a CUDA tensor, for a C entry."""
    dev = t.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream
