#!/usr/bin/env python3
"""Device time of the MAPQ cap kernel (ops/cuda_mapqcap.mapq_cap) over
batch sizes, with its phases apart, and of layout variants of its source,
on one NVIDIA GPU: the measurements behind csrc/mapq_cap.cu's layout.

    python3 scripts/cap_batch_sweep.py [--reads 96,384,...] [--iters 50]

The batch: 150-base reads from a random 1 Mbp genome (both strands, 1%
substitutions), qualities phred 2-40, and the genome's minimizers (k = 29,
w = 11) as the index's keys, about as many as the paired path's 1 Mbp
fixture holds. For each batch size R: the kernel's device time whole and
stopped after phase (a) and after (b) (cuda_mapqcap.stopped_library's
timing builds), timed with chip_smoke.device_ms (the host ahead of the
card). Then, at the largest R,
each variant of (reads a block, pieces and columns a sweep batch, the
launch bounds' minimum blocks) built from a copy of the source under
vg_tpu_torch/_build/: its registers and spills from ptxas, its caps
checked bit-equal to the kernel's, its time in turns. Prints a line a
measurement and, last, one JSON object with the card's name and power
limit. Imports no JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

READS = (96, 384, 768, 1536, 3072, 6144, 12288)
# (reads a block, pieces a batch, columns a batch, min blocks an SM); the
# first is the kernel as it stands
VARIANTS = ((4, 32, 128, 6), (4, 32, 128, 8), (4, 32, 64, 8),
            (4, 16, 64, 6), (4, 16, 64, 9), (2, 16, 64, 18), (8, 16, 64, 4))
K, W, L = 29, 11, 150


def batch(R, dev):
    """mapq_cap's inputs for R reads on dev (module docstring)."""
    from vg_tpu_torch.map.mapqcap import minimizer_agglomerations
    from vg_tpu_torch.utils.dna import revcomp_codes

    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 1_000_000).astype(np.uint8)
    keys = np.unique(minimizer_agglomerations(genome, K, W)[4].astype(
        np.uint64))
    codes = np.empty((R, L), np.uint8)
    for i in range(R):
        s = int(rng.integers(0, len(genome) - L))
        c = genome[s : s + L].copy()
        hit = rng.random(L) < 0.01
        c[hit] = (c[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
        codes[i] = revcomp_codes(c) if i % 2 else c
    quals = (rng.integers(2, 41, R * L) + 33).astype(np.uint8)
    put = lambda a: torch.as_tensor(a, device=dev)
    return (put(codes), put(np.full(R, L, np.int32)), put(quals),
            put(np.arange(R + 1, dtype=np.int64) * L),
            put(keys.view(np.int64)))


def cut(args, R):
    """The first R reads of a batch."""
    return (args[0][:R].contiguous(), args[1][:R].contiguous(), args[2],
            args[3][: R + 1].contiguous(), args[4])


def variant_libraries(cuda_build, cuda_mapqcap) -> dict:
    """Each VARIANTS layout built from a copy of csrc/mapq_cap.cu (all
    nvcc runs at once): {variant: (ctypes library, ptxas registers,
    spill bytes)}."""
    src = (cuda_build.PKG / "csrc" / "mapq_cap.cu").read_text()
    out = cuda_build.PKG / "_build" / "cap_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for v in VARIANTS:
        reads, pieces, cols, blocks = v
        s = src
        for name, val in (("kReads", reads), ("kPieces", pieces),
                          ("kCols", cols)):
            s = re.sub(rf"constexpr int {name} = \d+;",
                       f"constexpr int {name} = {val};", s)
        s = re.sub(r"static_assert\(sizeof\(WarpBuf\).*\n", "", s)
        s = re.sub(r"__launch_bounds__\(kReads \* 32, \d+\)",
                   f"__launch_bounds__(kReads * 32, {blocks})", s)
        f = out / ("mapq_cap_" + "_".join(map(str, v)) + ".cu")
        f.write_text(s)
        so = f.with_suffix(".so")
        procs[v] = (subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, str(f), "-o",
             str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    argtypes = cuda_mapqcap.library().mapq_cap.argtypes
    libs = {}
    for v, (proc, so) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {v}:\n{report}")
        lib = ctypes.CDLL(str(so))
        lib.mapq_cap.restype = ctypes.c_int
        lib.mapq_cap.argtypes = argtypes
        libs[v] = (lib, re.findall(r"Used (\d+) registers", report),
                   re.findall(r"(\d+) bytes spill stores", report))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", default=",".join(map(str, READS)))
    ap.add_argument("--iters", type=int, default=50)
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cap_batch_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from vg_tpu_torch.ops import cuda_build, cuda_mapqcap

    sizes = [int(x) for x in opts.reads.split(",")]
    full = batch(max(sizes), torch.device("cuda"))
    run = lambda lib, a: cuda_mapqcap.run_kernel(lib, *a, k=K, w=W)
    kernel = {1: cuda_mapqcap.stopped_library(1),
              2: cuda_mapqcap.stopped_library(2),
              3: cuda_mapqcap.library()}
    res = {"keys": int(full[4].shape[0]), "reads": {}, "variants": {}}
    for R in sizes:
        args = cut(full, R)
        t = {s: chip_smoke.device_ms(lambda: run(kernel[s], args),
                                     opts.iters)[0] for s in (1, 2, 3)}
        res["reads"][R] = dict(ms=t[3], a=t[1], b=t[2] - t[1],
                               c=t[3] - t[2])
        print(f"R = {R}: {t[3]:.4f} ms; (a) {t[1]:.4f}, (b) "
              f"{t[2] - t[1]:.4f}, (c) {t[3] - t[2]:.4f}", flush=True)
    args = cut(full, max(sizes))
    want = run(kernel[3], args).cpu().numpy()
    libs = variant_libraries(cuda_build, cuda_mapqcap)
    times = {v: [] for v in VARIANTS}
    for v in VARIANTS:
        same = np.array_equal(run(libs[v][0], args).cpu().numpy(), want,
                              equal_nan=True)
        assert same, f"variant {v}: caps differ from the kernel's"
    for order in (VARIANTS, VARIANTS[::-1]) * 2:
        for v in order:
            times[v].append(chip_smoke.device_ms(
                lambda: run(libs[v][0], args), opts.iters)[0])
    for v in VARIANTS:
        name = "reads {} pieces {} cols {} min blocks {}".format(*v)
        res["variants"][name] = dict(ms=min(times[v]), runs=times[v],
                                     registers=libs[v][1],
                                     spill_bytes=libs[v][2])
        print(f"{name}: {min(times[v]):.4f} ms (runs {times[v]}), "
              f"registers {libs[v][1]}, spills {libs[v][2]}", flush=True)
    res["card"] = chip_smoke.smi()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
