#!/usr/bin/env python3
"""Smoke run of vg_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py [--ref-mbp 1.0] [--seed 42] [--profile]
                          [--compare-parent DIR]

Builds the port's kernels (vg_tpu_torch/csrc/banded_dp.cu,
csrc/seed_kernels.cu, csrc/link_engine.cu, csrc/mapq_cap.cu and
csrc/int_pipes.cu, nvcc) and the native host library
(vg_tpu_torch/native/vgtpu_host.cpp, g++) from the sources in the checkout,
all at once, and holds every kernel against its plain PyTorch version on
the card: the banded DP through its three entries (packed text, byte
text, pre-gathered windows) and the three seeding kernels. The byte-text
entry also runs under make_paired_step's default score function, against
the packed step. Then it drives the port's mapping paths, each with the
kernels' launch counts set to 0 just before it and read just after:

- the sharded steps (parallel/mesh.py's multi-device half, the byte-text
  entry on every score) on the main path's first batch: on an NCCL mesh
  of one rank, sharded_paired_step and sharded_map_step against the
  replicated step; in this process, the text-sharded paired step on 4
  text shards; rescue candidates from _rescue_begin scored on the mesh
  and on 4 shards against the host scores; then the 4-shard step's and
  the shard launches' device times against the replicated ones;

- the host-seeded main path, paired 150 bp giraffe mapping: bench.py's
  pangenome (1 Mbp reference, 5 haplotypes), PairedGiraffeMapper warmed up
  until its fragment model is finalized, and 8 batches of 6144 simulated
  pairs streamed through map_pairs_encoded_mt; then one single-end batch,
  and the device step against the port's own CPU path;
- the device-seeded path (GiraffeParams(device_seed=True), the seeding
  kernels), the same way: 8 batches of 6144 pairs, one single-end batch,
  and the seeded step against the port's CPU path;
- long-read mapping, bench.py's long-read sidecar at its size: 512 reads
  of 10 kb (0.5% substitutions) on the same pangenome and minimizer
  index, LongReadMapper with engine="native" and then engine="device"
  (the link engine, ops/device_links.py: the link_pack, link_fill,
  link_walk and link_runs kernels, csrc/link_engine.cu); 16 reads warm the
  native engine, the device engine warms on the 496 timed reads. The two
  engines' 496 records must be byte-identical, on the timed pass and on
  the pass under the profiler, each with one launch of link_pack,
  link_fill and link_walk a bucket and link_runs' two (count and write) a
  bucket with a certified task. Then the four link kernels against their plain versions
  on the card: both buckets' inputs of the batch, ops/link_cases.py (the
  fill and walk), and a bucket-768 batch of 43,008 tasks;
- `vg map -A` (MEMMapper, qual_adjusted=True): 150 bp reads with
  qualities from ReadSimulator, one warmup batch and 8 timed batches of
  512 through map_batch, the DP's quality entry (banded_dp_qual_packed) on
  the card, one launch a timed batch on the route the rule
  (cuda_align.qual_lanes) gives; placement against the simulator's truth
  and the first timed batch against a CPU twin. The quality entry is then
  held against its plain version on both routes (1 and 4 lanes a slot):
  on ops/dp_cases.qual_case, on qual_case and dp_cases.split_case sized
  so that the rule picks each route, and on the warmup batch;
- surject: the host-seeded path's first 8,192 records to SAM records
  (Surjector.surject_batch), through BAM and back, as bench.py's surject
  sidecar;
- pack and call: sample s1's reads at 30x diploid depth mapped on the
  card (host seeding), Packer, SnarlCaller, genotype concordance against
  the fixture's VCF;
- the command line (vg_tpu_torch.cli.main.main, in-process, the card as
  VGTPU_PLATFORM unset gives it) on the fixture's bundle written into a
  temporary directory and reads written as FASTQ: giraffe -2 on the
  paired path's 9 x 6144 pairs (records equal to map_pairs_encoded_mt on
  a fresh mapper, placement, reads/s beside the library path's; the
  explored-minimizer MAPQ cap launched once for each mate of each batch,
  csrc/mapq_cap.cu, and the Python explored_cap never called, in the CLI
  run and the library's; the cap's call timed in parts, begun in the
  rescue stage and waited for at emit), map -A
  on the vg map reads (records equal to MEMMapper's), mpmap single-end,
  -2 and -A on 1,024 reads or pairs (the card against the CPU on 64),
  then surject -b (against Surjector), pack, call, sim, giraffe -G,
  gamcompare and mapeval -n 2000 on the files they made; then the MAPQ
  cap kernel against its plain version on ops/cap_cases.py's cases and
  on both mates of a batch captured from the giraffe -2 run (caps
  bit-equal), and timed on that batch: whole, its phases apart, and the
  call's input build, upload and wait replayed right after the CLI run.

It checks the records (count, placement against the simulated truth, the
card against the CPU, the long-read engines against each other).
Imports nothing of JAX or vg_tpu.

Kernel times are device times: a spin kernel holds the stream while the
host enqueues the timed calls (device_ms); the enqueue-inclusive reading
of back-to-back calls (cuda_ms) is printed beside it. The build phase
prints each kernel's ptxas line (registers, spills) and, from cuobjdump
-sass, the DPX instructions of each banded-DP kernel and the largest
loop of each link kernel (the fill's row loop, the walk's step loop);
then csrc/int_pipes.cu measures the issue rate and latency of the DP's
instruction kinds. --compare-parent DIR
loads the vg_tpu_torch package of another checkout (DIR, e.g. a
`git archive` of the parent commit), builds its kernels, and times its
softcap_compact, cluster_topc, argsort_i32 and packed banded DP against
this tree's on the main path's inputs, its link_fill and link_walk on
the long-read batch's two buckets, its quality entry on the vg map
batch, and its MAPQ cap on the giraffe -2 batch, in turns, after
checking that both give the same outputs.

Output: one line per phase, then a JSON line with the kernels' numbers,
the card's name and power limit, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure ends the run with a traceback and a non-zero exit; without
CUDA it exits with 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

BAND = 16                 # GiraffeParams.band_radius, the main path's
BATCH = 6144              # bench.py's pairs a batch (BENCH_BATCH default)
N_BATCHES = 8             # batches streamed through the pipeline
LR_READS, LR_WARM, LR_LEN = 512, 16, 10_000   # bench.py's long-read sidecar
VGMAP_BATCH, VGMAP_BATCHES = 512, 8   # vg map: the CLI's --batch-size
SURJECT_N = 8192          # bench.py's surject sidecar: GAM records surjected
CALL_DEPTH = 30           # pack + call: sample s1's diploid read depth
PLACE_EVERY = 4           # CLI giraffe -2: placement on every 4th record
# H100 SXM peaks. No instruction mix issues more than one warp
# instruction per scheduler per clock: 132 SMs x 4 schedulers x 32 lanes
# x 1.98 GHz = 33.4 T lane-operations/s is the integer DP's ceiling (the
# INT32 pipe alone gives half; the FMA pipe runs IMAD and its moves)
INT32_OPS_PER_S = 132 * 4 * 32 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
SM_HZ = 1.98e9            # H100 SXM boost clock: torch.cuda._sleep cycles/s
COMP = np.array([3, 2, 1, 0, 4, 5], np.uint8)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ fixture
# bench.py's make_pangenome / make_sample_texts / simulate_pairs, built
# with the port's own copies of construct, index and io

def make_pangenome(rng, ref_len=1_000_000, snp_rate=0.001,
                   indel_rate=0.0001):
    from vg_tpu_torch.construct.constructor import (Constructor,
                                                    ConstructorParams)
    from vg_tpu_torch.io.vcf import VcfFile, VcfRecord
    from vg_tpu_torch.utils import dna

    ref_codes = rng.integers(0, 4, size=ref_len).astype(np.uint8)
    ref_seq = dna.decode(ref_codes)
    n_var = int(ref_len * (snp_rate + indel_rate))
    pos = np.sort(rng.choice(np.arange(100, ref_len - 100), size=n_var,
                             replace=False))
    pos = pos[np.concatenate([[True], np.diff(pos) > 40])]
    records = []
    bases = "ACGT"
    for p in pos:
        p = int(p)
        r = ref_seq[p]
        if rng.random() < snp_rate / (snp_rate + indel_rate):
            alt = bases[(bases.index(r) + 1 + int(rng.integers(0, 3))) % 4]
            ref_a, alt_a = r, alt
        else:
            n = int(rng.integers(1, 6))
            if rng.random() < 0.5:
                ins = "".join(bases[int(b)] for b in rng.integers(0, 4, n))
                ref_a, alt_a = r, r + ins
            else:
                ref_a, alt_a = ref_seq[p : p + 1 + n], r
        gts = [((int(rng.integers(0, 2)), int(rng.integers(0, 2))), True)
               for _ in range(2)]
        records.append(VcfRecord(
            chrom="ref", pos=p + 1, id=".", ref=ref_a, alts=[alt_a],
            qual=".", filter=".", info={}, genotypes=gts))
    vcf = VcfFile(samples=["s1", "s2"], records=records)
    g, results = Constructor(ConstructorParams(max_node_size=32)
                             ).construct_graph({"ref": ref_seq}, vcf)
    return g, results, vcf


def make_sample_texts(rng, haps, novel_snp=0.0005, novel_indel=0.00005):
    """Held-out diploid: two mutated copies of the indexed text with SNPs
    and small indels the index has never seen, with sample -> original
    coordinate anchors for the truth."""
    out = []
    for _ in range(2):
        t = haps.text.copy()
        n_snp = rng.binomial(len(t), novel_snp)
        ps = rng.integers(0, len(t), n_snp)
        t[ps] = (t[ps] + 1 + rng.integers(0, 3, n_snp)) % 4
        parts, anchors_s, anchors_o = [], [0], [0]
        cur = built = 0
        for p in np.sort(rng.integers(100, len(t) - 100,
                                      rng.binomial(len(t), novel_indel))):
            p = int(p)
            if p <= cur:
                continue
            parts.append(t[cur:p])
            built += p - cur
            if rng.random() < 0.5:
                ins = rng.integers(0, 4, int(rng.integers(1, 6)))
                parts.append(ins.astype(np.uint8))
                built += len(ins)
                cur = p
            else:
                cur = p + int(rng.integers(1, 6))
            anchors_s.append(built)
            anchors_o.append(cur)
        parts.append(t[cur:])
        out.append((np.concatenate(parts), np.array(anchors_s, np.int64),
                    np.array(anchors_o, np.int64)))
    return out


def _original(x, anc_s, anc_o):
    """Original-text coordinate of sample-text position x."""
    a = int(np.searchsorted(anc_s, x, side="right")) - 1
    return x - int(anc_s[a]) + int(anc_o[a])


def simulate_pairs(rng, texts, n_pairs, read_len=150, err=0.01,
                   frag_mean=450, frag_sd=50):
    """Pairs (mate 2 reverse-complemented) and each mate's truth: the
    original-text coordinate of its leftmost base."""
    from vg_tpu_torch.io.fastq import Read
    from vg_tpu_torch.utils import dna

    out, truth = [], []
    for i in range(n_pairs):
        t, anc_s, anc_o = texts[int(rng.integers(0, len(texts)))]
        frag = max(int(rng.normal(frag_mean, frag_sd)), read_len + 10)
        s = int(rng.integers(0, len(t) - frag))
        c1 = t[s : s + read_len].copy()
        c2 = t[s + frag - read_len : s + frag].copy()
        for c in (c1, c2):
            for _ in range(rng.binomial(read_len, err)):
                p = int(rng.integers(0, read_len))
                c[p] = (c[p] + 1 + rng.integers(0, 3)) % 4
        truth.append((_original(s, anc_s, anc_o),
                      _original(s + frag - read_len, anc_s, anc_o)))
        out.append((Read(f"p{i}/1", dna.decode(c1), None),
                    Read(f"p{i}/2", dna.decode(dna.revcomp_codes(c2)),
                         None)))
    return out, np.array(truth, np.int64)


def build_fixture(seed, ref_mbp, n_pairs):
    from vg_tpu_torch.index.haplotypes import thread_haplotypes
    from vg_tpu_torch.index.minimizer import MinimizerIndex
    from vg_tpu_torch.map.memmapper import MEMIndex

    rng = np.random.default_rng(seed)
    t0 = time.time()
    g, results, vcf = make_pangenome(rng, ref_len=int(ref_mbp * 1e6))
    haps = thread_haplotypes(g, results, vcf)
    idx = MinimizerIndex.build(haps)
    mem = MEMIndex(haps)
    texts = make_sample_texts(rng, haps)
    pairs, truth = simulate_pairs(rng, texts, n_pairs)
    log(f"fixture: {g.node_count} nodes, {haps.count} haplotypes, text "
        f"{haps.total_len} bp, {idx.unique_count} minimizers, "
        f"{n_pairs} pairs ({time.time() - t0:.1f} s)")
    return haps, idx, mem, vcf, pairs, truth


# -------------------------------------------------------------- phases

def kernel_launches() -> dict:
    """Each kernel's launch count (the wrappers count their launches)."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def kernel_wrappers() -> dict:
    from vg_tpu_torch.ops import cuda_align, cuda_links, cuda_mapqcap, cuda_seed

    return {"banded_dp": cuda_align.banded_scores_packed,
            "banded_dp_bytes": cuda_align.banded_scores_bytes,
            "banded_dp_windows": cuda_align.banded_scores_windows,
            "banded_dp_qual": cuda_align.banded_scores_qual_packed,
            "softcap_compact": cuda_seed.softcap_compact,
            "cluster_topc": cuda_seed.cluster_topc,
            "argsort_i32": cuda_seed.argsort_i32,
            "link_fill": cuda_links.link_fill,
            "link_walk": cuda_links.link_walk,
            "link_pack": cuda_links.link_pack,
            "link_runs": cuda_links.link_runs,
            "mapq_cap": cuda_mapqcap.mapq_cap}


def reset_launches() -> None:
    """Launch counts (the quality entry's by route too) and the card's
    count of block-path cluster rows to 0."""
    from vg_tpu_torch.ops import cuda_align, cuda_seed

    for fn in kernel_wrappers().values():
        fn.launches = 0
    cuda_align.banded_scores_qual_packed.routes = dict.fromkeys(
        cuda_align.QUAL_LANES, 0)
    cuda_seed.block_rows_reset()


def timing_text(k) -> str:
    """One kernel's times beside its bound, for the log."""
    lib = "" if k.get("library_ms") is None else \
        f", library {k['library_ms']:.4f} ms (runs {k['library_runs_ms']})"
    return (f"kernel {k['ms']:.4f} ms on the device (runs "
            f"{k['kernel_runs_ms']}, host ahead {k['host_ahead']}), "
            f"{k['enqueue_ms']:.4f} ms enqueue-inclusive (runs "
            f"{k['enqueue_runs_ms']}), plain {k['plain_ms']:.3f} ms, bound "
            f"{k['bound_ms']:.5f} ms ({k['bound_by']}; {k['ops']:.3e} ops, "
            f"{k['bytes']} bytes; {100 * k['bound_ms'] / k['ms']:.1f}% of "
            f"bound speed){lib}")


def phase_environment():
    from vg_tpu_torch.ops import cuda_build

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([cuda_build.nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    log("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: not installed")
    card = smi()
    log(f"card: {card}; torch sees {torch.cuda.device_count()} "
        f"({torch.cuda.get_device_name(0)})")
    return card


def phase_build():
    """All libraries at once: nvcc for each kernel source, g++ for the
    host library. Any failing ends the run."""
    from vg_tpu_torch import native
    from vg_tpu_torch.ops import cuda_align, cuda_links, cuda_mapqcap, cuda_seed

    took, errors = {}, []

    def run(name, fn):
        t0 = time.time()
        try:
            if fn() is None:
                raise RuntimeError(f"{name}: build produced no library")
        except BaseException as e:        # re-raised below
            errors.append(e)
        took[name] = time.time() - t0

    threads = [threading.Thread(target=run, args=a) for a in
               (("banded_dp.cu (nvcc)", cuda_align.library),
                ("seed_kernels.cu (nvcc)", cuda_seed.library),
                ("link_engine.cu (nvcc)", cuda_links.library),
                ("mapq_cap.cu (nvcc)", cuda_mapqcap.library),
                ("mapq_cap.cu, stopped after (a) (nvcc)",
                 lambda: cuda_mapqcap.stopped_library(1)),
                ("mapq_cap.cu, stopped after (b) (nvcc)",
                 lambda: cuda_mapqcap.stopped_library(2)),
                ("int_pipes.cu (nvcc)", pipes_library),
                ("vgtpu_host.cpp (g++)", native.lib))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name, s in took.items():
        log(f"build {name}: {s:.1f} s")
    for info in (cuda_align.build_info, cuda_seed.build_info,
                 cuda_links.build_info, cuda_mapqcap.build_info):
        for line in info.get("ptxas", "").splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                log("  ptxas: " + line.strip())
    sass_check(cuda_align.build_info["path"])
    for name, loop in sass_loops(cuda_align.build_info["path"],
                                 QUAL_KERNELS, rows=True).items():
        log(f"  sass {name}: {loop_text(loop)}")
    for name, loop in link_loops(cuda_links.build_info["path"]).items():
        log(f"  sass {name}: {loop_text(loop)}")


DPX_OPS = ("VIADDMNMX", "VIMNMX3")     # Hopper's fused DP instructions
# the quality entry's kernels: one slot a thread, and the split route
QUAL_KERNELS = "banded_dp_qual_split_kernel|banded_dp_qual_kernel"
_pipes = {}


def pipes_library():
    """csrc/int_pipes.cu (the integer pipes' rate and latency), built and
    bound once."""
    import ctypes

    from vg_tpu_torch.ops import cuda_build

    if "lib" not in _pipes:
        lib = cuda_build.build(cuda_build.PKG / "csrc" / "int_pipes.cu", {})
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pipe_rate.argtypes = [I, I, P, P, I]
        lib.pipe_latency.argtypes = [I, P, P, I]
        _pipes["lib"] = lib
    return _pipes["lib"]


def phase_int_pipes(card):
    """The issue rate (warp-instructions a cycle an SM, 8 and 16 warps an
    SM) and the dependent-chain latency (cycles) of the DP's instruction
    kinds, from SM clock counters."""
    lib = pipes_library()
    out = torch.zeros(132 * 32 * 16, dtype=torch.int32, device="cuda")
    cyc = torch.zeros(132, dtype=torch.int64, device="cuda")
    n = lib.pipe_instructions()
    res = {}
    for kind, name in enumerate(("VIADDMNMX (s32)", "VIADDMNMX.S16x2",
                                 "IMAD", "VIMNMX3.S16x2")):
        rates = []
        for warps in (8, 16):
            for _ in range(2):            # the second run is timed
                assert lib.pipe_rate(kind, warps, out.data_ptr(),
                                     cyc.data_ptr(), -5) == 0
                torch.cuda.synchronize()
            rates.append(warps * n / float(cyc.double().median()))
        for _ in range(2):
            assert lib.pipe_latency(kind, out.data_ptr(), cyc.data_ptr(),
                                    -5) == 0
            torch.cuda.synchronize()
        lat = float(cyc[0]) / 1024
        res[name] = dict(rate_8_warps=rates[0], rate_16_warps=rates[1],
                         latency_cycles=lat)
        log(f"int pipes, {name}: {rates[0]:.3f} / {rates[1]:.3f} "
            f"warp-instructions a cycle an SM (8 / 16 warps), latency "
            f"{lat:.2f} cycles, on {card}")
    return res


def sass_lines(lib_path):
    """(function, address, opcode, operands) of each instruction in
    cuobjdump -sass of a library."""
    from vg_tpu_torch.ops import cuda_build

    tool = pathlib.Path(cuda_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    name = None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            continue
        ins = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if name and ins:
            yield name, int(ins.group(1), 16), ins.group(2), ins.group(3)


def link_loops(lib_path) -> dict:
    """The largest loop of each link kernel in the library's SASS (the
    fill's row loop, the walk's step loop)."""
    return sass_loops(lib_path, "link_fill_kernel|link_walk_kernel")


def sass_loops(lib_path, names, rows=False) -> dict:
    """The largest loop of each kernel whose name matches `names` (a
    regex alternation), by instantiation (name<template ints>): the span
    from a backward branch's target to the branch, its instructions and,
    among them, its shuffles, votes, shared and global loads and stores.
    With `rows`, the DP's row loop instead: the loop with the most
    VIADDMNMX."""
    funcs = {}
    for fn, addr, op, rest in sass_lines(lib_path):
        m = re.search(rf"({names})(?:I((?:Li\d+E)+)E)?", fn)
        if m:
            ints = re.findall(r"Li(\d+)E", m.group(2) or "")
            key = m.group(1) + (f"<{', '.join(ints)}>" if ints else "")
            funcs.setdefault(key, []).append((addr, op, rest))
    loops = {}
    for key, ins in sorted(funcs.items()):
        best = None
        size = (lambda b: sum(o.startswith("VIADDMNMX") for o in b)) \
            if rows else len
        for addr, op, rest in ins:
            tgt = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and tgt and int(tgt.group(1), 16) < addr:
                body = [o for a, o, _ in ins
                        if int(tgt.group(1), 16) <= a <= addr]
                if best is None or size(body) > size(best):
                    best = body
        kinds = {}
        for o in best or []:
            k = o.split(".")[0]
            if k in ("SHFL", "VOTE", "REDUX", "LDS", "STS", "LDG", "STG",
                     "VIADDMNMX", "VIMNMX3",
                     "BAR", "WARPSYNC"):
                kinds[k] = kinds.get(k, 0) + 1
        loops[key] = dict(instructions=len(ins),
                          loop_instructions=len(best or []),
                          loop_kinds=kinds)
    return loops


def loop_text(loop) -> str:
    return (f"{loop['instructions']} instructions; loop "
            f"{loop['loop_instructions']} "
            f"({json.dumps(loop['loop_kinds'])})")


def sass_check(lib_path):
    """cuobjdump -sass of the banded-DP library: for each kernel, its
    instruction count and its DPX and other integer min/max instructions.
    Fails unless every instantiation of each DP kernel (the 16x2, the
    int32 and the quality entry's one slot a thread) issues both DPX
    forms, and each of the quality entry's split route VIADDMNMX (its row
    maxima over 2 to 9 columns a lane may take no VIMNMX3)."""
    funcs = {}
    for name, _, op, _ in sass_lines(lib_path):
        ops = funcs.setdefault(name, {})
        ops[op] = ops.get(op, 0) + 1
    for fn, ops in sorted(funcs.items()):
        if not re.search(r"banded_dp(16|_qual|_qual_split)?_kernel", fn):
            continue
        short = re.sub(r"^_ZN\w*?banded_dp", "banded_dp", fn)
        mnmx = {op: n for op, n in sorted(ops.items()) if "MNMX" in op}
        log(f"  sass {short[:60]}: {sum(ops.values())} instructions; "
            f"min/max {json.dumps(mnmx)}")
        need = DPX_OPS[:1] if "qual_split" in fn else DPX_OPS
        missing = [d for d in need
                   if not any(op.split(".")[0] == d for op in ops)]
        assert not missing, f"{fn} issues no {missing}"


def adversarial_batch(rng, text, R, C=8, RL=160, B=BAND, L=150):
    """Candidate tables of the main path's shape with the rows the kernel
    must get right: starts below 0 and windows past the text end, lo/hi
    cutting the window, reverse strands mixed, rlen = 0 and short reads,
    N bases (code 4), pad 5 past rlen, invalid slots."""
    T = len(text)
    TW = RL + 2 * B
    s = rng.integers(0, T - L, R)
    s[:8] = rng.integers(0, B, 8)                  # window starts < 0
    s[8:16] = T - L - rng.integers(0, B, 8)        # windows past the end
    r = text[s[:, None] + np.arange(L)]
    mut = rng.random((R, L)) < 0.01
    r = np.where(mut, (r + 1 + rng.integers(0, 3, (R, L))) % 4, r)
    r[rng.random((R, L)) < 0.002] = 4              # N bases
    r = r.astype(np.uint8)
    rlen = np.full(R, L, np.int32)
    short = rng.random(R) < 0.05
    rlen[short] = rng.integers(1, L, int(short.sum()))
    rlen[::97] = 0
    strand = rng.random(R) < 0.5
    r = np.where(strand[:, None], COMP[r][:, ::-1], r)
    col = np.arange(RL)[None, :]
    reads = np.full((R, RL), 5, np.uint8)
    reads[:, :L] = r
    reads[col >= rlen[:, None]] = 5
    idx = np.clip(rlen[:, None] - 1 - col, 0, RL - 1)
    rc = np.take_along_axis(reads, idx, 1)
    reads_rc = np.where(col < rlen[:, None], COMP[rc], 5).astype(np.uint8)
    start = rng.integers(-TW, T, (R, C)).astype(np.int32)
    start[:, 0] = s - B + rng.integers(-3, 4, R)
    rev = rng.random((R, C)) < 0.5
    rev[:, 0] = strand
    lo = np.zeros((R, C), np.int32)
    hi = np.full((R, C), T, np.int32)
    cut = rng.random(R) < 0.1
    lo[cut, 0] = start[cut, 0] + rng.integers(0, TW // 3, int(cut.sum()))
    hi[cut, 0] = start[cut, 0] + TW - rng.integers(0, TW // 3,
                                                   int(cut.sum()))
    valid = rng.random((R, C)) < 0.9
    return reads, reads_rc, rlen, start, lo, hi, rev, valid


def cuda_ms(fn, iters):
    """Mean milliseconds of fn on the card, enqueue included: CUDA events
    around `iters` back-to-back calls after one warm call. Where one call
    takes the host longer to enqueue than the card to run, this is the
    host's time."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters):
    """Mean device milliseconds of fn, with the host ahead of the card:
    after a warm call, a spin kernel (torch.cuda._sleep) holds the stream
    for twice the host's enqueue time of the iterations while the host
    enqueues the start event, `iters` calls and the end event, so the
    events see the card's work back to back. Returns (ms, ahead): ahead
    is False when the start event had already run once the host was done
    (a spin still too short after two doublings, or a call that waits
    for the card), and then ms includes the host's gaps as cuda_ms
    does."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    for attempt in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(SM_HZ * (2 * iters * host + 1e-3) * 2**attempt))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        ahead = not a.query()
        b.synchronize()
        if ahead:
            break
    return a.elapsed_time(b) / iters, ahead


def timed_turns(kern, plain, iters, plain_iters, library=None):
    """Device times in turns (plain, kernel, kernel, plain; the library
    call after the first plain run and before the second) and the
    kernel's enqueue-inclusive time between its two device runs."""
    p1 = device_ms(plain, plain_iters)
    l1 = device_ms(library, iters) if library else None
    k1 = device_ms(kern, iters)
    e1 = cuda_ms(kern, iters)
    e2 = cuda_ms(kern, iters)
    k2 = device_ms(kern, iters)
    l2 = device_ms(library, iters) if library else None
    p2 = device_ms(plain, plain_iters)
    return dict(
        ms=min(k1[0], k2[0]), enqueue_ms=min(e1, e2),
        plain_ms=min(p1[0], p2[0]),
        library_ms=min(l1[0], l2[0]) if library else None,
        kernel_runs_ms=[k1[0], k2[0]], enqueue_runs_ms=[e1, e2],
        plain_runs_ms=[p1[0], p2[0]],
        library_runs_ms=[l1[0], l2[0]] if library else None,
        host_ahead=all(x[1] for x in (k1, k2) + ((l1, l2) if library
                                                 else ())))


def time_kernel(packed, T, t):
    """Kernel and plain-version milliseconds on one batch (plain, kernel,
    kernel, plain: the card's clock state is shared) and the bound from
    the work this batch needs."""
    from vg_tpu_torch.ops import cuda_align

    run_k = lambda: cuda_align.banded_scores_packed(packed, T, *t,
                                                    band_radius=BAND)
    run_p = lambda: cuda_align.banded_scores_packed_ref(packed, T, *t,
                                                        band_radius=BAND)
    nbytes, ops = cuda_align.dp_work(t[0], t[2], t[-1], packed.numel(), BAND)
    R, RL = t[0].shape
    return dict(time_entry(run_k, run_p, nbytes, ops),
                shape=f"R={R} C={t[3].shape[1]} RL={RL} B={BAND}",
                valid=int(t[-1].sum()), slots=t[-1].numel())


def phase_kernel(text, real_batches):
    """The kernel against its plain version on the same inputs: the
    adversarial batch at the main path's shape (B = 16) and at B = 8, 12,
    dp_cases' valid-slot patterns (blocks with every slot valid, none,
    one, every other one) at B = 8, 12, 16, and the main path's own
    candidate tables. Exact equality. Times and bounds on the main path's
    first batch (its own inputs) and on the adversarial B = 16 batch (90%
    of slots valid)."""
    from vg_tpu_torch.ops import cuda_align, dp_cases

    dev = torch.device("cuda")
    T = len(text)
    packed = torch.as_tensor(cuda_align.pack_text(text), device=dev)
    rng = np.random.default_rng(3)
    adv = f"adversarial R={BATCH} B={BAND}"
    cases = [(adv, BAND, adversarial_batch(rng, text, BATCH))]
    for b in (8, 12):
        cases.append((f"adversarial R=1024 B={b}", b,
                      adversarial_batch(rng, text, 1024, B=b)))
    for b in (8, 12, BAND):
        cases.append((f"valid-slot patterns R=2048 B={b}", b,
                      dp_cases.block_case(rng, R=2048, B=b, text=text)[1:]))
    cases += [(f"main path batch {k}", BAND, a)
              for k, a in enumerate(real_batches)]
    mism = 0
    err = 0
    inputs = {}
    for name, b, arrs in cases:
        t = [torch.as_tensor(np.ascontiguousarray(x), device=dev)
             for x in arrs]
        got = cuda_align.banded_scores_packed(packed, T, *t, band_radius=b)
        torch.cuda.synchronize()
        want = cuda_align.banded_scores_packed_ref(packed, T, *t,
                                                   band_radius=b)
        n_bad = int((got != want).sum())
        e = int((got.to(torch.int64) - want).abs().max())
        log(f"kernel vs plain, {name}: {tuple(got.shape)} "
            f"{n_bad} mismatches, max |err| {e}, "
            f"{int(arrs[-1].sum())} valid slots")
        mism += n_bad
        err = max(err, e)
        inputs[name] = t
    if mism:
        raise AssertionError(f"banded_dp disagrees with its plain version "
                             f"on {mism} slots")
    inputs["main path batch 0, first 768 reads"] = [
        x[: BATCH // 8] for x in inputs["main path batch 0"]]
    log(f"banded_dp routes so far: {json.dumps(cuda_align.launches_by_route())}"
        f" (16: two slots a thread in 16-bit halves, 32: int32)")
    return dict(max_abs_err=err, mismatches=mism,
                timed={name: time_kernel(packed, T, inputs[name])
                       for name in ("main path batch 0", adv,
                                    "main path batch 0, first 768 reads")},
                main_inputs=(packed, T, inputs["main path batch 0"]))


def placed(mapper, recs, truth, tol=100):
    """Fraction of records whose first refpos lies within tol bp of its
    mate's truth (recs interleave mate 1, mate 2 per pair)."""
    from vg_tpu_torch.io.gam import Alignment

    return placed_alns(mapper, [Alignment.decode(bytes(r)) for r in recs],
                       truth.reshape(-1), tol)


def placed_alns(mapper, alns, want, tol=100):
    """Fraction of alignments whose first refpos lies within tol bp of
    their truth `want` (original-text coordinates). A reverse-strand
    refpos names the read's first base, one read length to the right of
    its leftmost one."""
    _, ro = mapper._diag_refproj(
        (want - mapper.params.band_radius)[:, None].astype(np.int64),
        np.ones((len(want), 1), bool))
    ok = 0
    for k, aln in enumerate(alns):
        if not aln.refpos:
            continue
        rp = aln.refpos[0]
        want_k = int(ro[k, 0]) + (len(aln.sequence) if rp.is_reverse else 0)
        ok += abs(int(rp.offset) - want_k) <= tol
    return ok / max(len(alns), 1)


def phase_main_path(haps, idx, mem, pairs, truth, bs, n_batches,
                    device_seed=False, device="cuda"):
    """A paired mapping path on the card (host seeding, or device seeding
    with device_seed): warmup, then n_batches through the three-stage
    pipeline. Returns the mapper, the records and the numbers. Host
    seeding counts the launches from the warmup on, device seeding over
    the stream (its warmup runs the host path while the fragment model
    learns)."""
    from vg_tpu_torch.map.giraffe import GiraffeMapper, GiraffeParams
    from vg_tpu_torch.map.paired import PairedGiraffeMapper
    from vg_tpu_torch.ops import cuda_seed
    from vg_tpu_torch.parallel.pipeline import map_pairs_encoded_mt

    mapper = GiraffeMapper(haps, idx, GiraffeParams(
        batch_reads=bs, device_seed=device_seed), device=device)
    mapper._mem_fallback_index = mem
    pm = PairedGiraffeMapper(mapper)
    if not device_seed:
        reset_launches()
    t0 = time.time()
    warm = []
    for k in range(len(pairs) // bs):
        warm += pm.map_pairs(pairs[k * bs : (k + 1) * bs])
        if pm.fragdist.finalized:
            break
    warm += pm.finish()
    assert pm.fragdist.finalized
    log(f"warmup: {len(warm)} pairs mapped on the host path, fragment "
        f"model mean {pm.fragdist.mean:.1f} sd {pm.fragdist.stdev:.1f} "
        f"({time.time() - t0:.1f} s, {kernel_launches()['banded_dp']} DP "
        f"launches)")
    stream = pairs[bs : bs * (n_batches + 1)]
    want_truth = truth[bs : bs * (n_batches + 1)]
    if device_seed:
        reset_launches()
    before = kernel_launches()
    rows0 = cuda_seed.block_rows_read()
    recs = []
    t0 = time.time()
    ticks = [t0]
    for out in map_pairs_encoded_mt(
            pm, (stream[i : i + bs] for i in range(0, len(stream), bs))):
        recs.extend(out)
        ticks.append(time.time())
    dt = time.time() - t0
    after = kernel_launches()
    torch.cuda.synchronize()
    block_rows = cuda_seed.block_rows_read() - rows0
    steady = (len(recs) - 2 * bs) / (ticks[-1] - ticks[1]) \
        if len(ticks) > 2 and ticks[-1] > ticks[1] else len(recs) / dt
    assert len(recs) == 2 * len(stream), (len(recs), len(stream))
    frac = placed(mapper, recs, want_truth)
    return pm, recs, dict(
        records=len(recs), seconds=dt, reads_per_s=len(recs) / dt,
        steady_reads_per_s=steady, placed=frac, launches=after,
        stream_launches={k: after[k] - before[k] for k in after},
        block_rows=block_rows, stage_seconds=dict(pm.stage_seconds))


def log_path(name, res, card):
    log(f"{name}: {res['records']} records in {res['seconds']:.2f} s "
        f"= {res['reads_per_s']:.0f} reads/s (steady "
        f"{res['steady_reads_per_s']:.0f}), {100 * res['placed']:.2f}% "
        f"within 100 bp of truth, launches {json.dumps(res['launches'])} "
        f"({json.dumps(res['stream_launches'])} while streaming; "
        f"{res['block_rows']} cluster rows on the block path), stage "
        f"seconds {json.dumps(res['stage_seconds'])} on {card}")


def compare_buffers(name, gpu_buf, cpu_buf, mapq):
    """Whole int16 buffers equal; MAPQ entries (the `mapq` mask) counted
    apart, since they pass through float32 log/exp."""
    assert gpu_buf.shape == cpu_buf.shape, (gpu_buf.shape, cpu_buf.shape)
    n_other = int((gpu_buf[~mapq] != cpu_buf[~mapq]).sum())
    d_mq = np.abs(gpu_buf[mapq].astype(np.int32) - cpu_buf[mapq])
    log(f"card vs CPU {name}: {n_other} differing non-MAPQ entries, "
        f"{int((d_mq > 0).sum())} MAPQs differ (max {int(d_mq.max())})")
    assert n_other == 0, f"{name} differs from the CPU path"
    assert int(d_mq.max()) == 0, f"{name}: MAPQs differ from the CPU path"


def cpu_twin(haps, idx, pm, bs, device_seed=False):
    from vg_tpu_torch.map.giraffe import GiraffeMapper, GiraffeParams
    from vg_tpu_torch.map.paired import PairedGiraffeMapper

    cpu = PairedGiraffeMapper(GiraffeMapper(
        haps, idx, GiraffeParams(batch_reads=bs, device_seed=device_seed),
        device="cpu"))
    cpu.fragdist = pm.fragdist
    cpu.mapper._mem_fallback_index = pm.mapper._mem_fallback_index
    return cpu


def phase_reference(haps, idx, pm, pairs):
    """The device step on the card against the port's own CPU path (the
    plain versions) on one batch: the whole int16 buffer equal, MAPQs
    included."""
    bs = len(pairs)
    bufs = []
    for m in (pm, cpu_twin(haps, idx, pm, bs)):
        _, _, sel = m.score_pairs_device(pairs)
        bufs.append(sel[1].cpu().numpy())
        Rpad, C = sel[2], sel[3]
    n = Rpad * C // 2 if sel[6] else Rpad * C
    mq = np.zeros(len(bufs[0]), bool)
    mq[2 * n + 2 * Rpad : 2 * n + 4 * Rpad] = True
    compare_buffers(f"device step ({bs} pairs)", *bufs, mq)


def phase_reference_seeded(haps, idx, pm, pairs):
    """The device-seeded step on the card against the port's CPU path
    (every seeding kernel's plain version): the whole winner-only int16
    buffer equal, MAPQs included."""
    bs = len(pairs)
    bufs = []
    for m in (pm, cpu_twin(haps, idx, pm, bs, device_seed=True)):
        _, _, sel = m.score_pairs_device_seeded(pairs)
        assert sel[0] == "seeded"
        bufs.append(sel[1].cpu().numpy())
        Rpad = sel[2]
    mq = np.zeros(len(bufs[0]), bool)
    for off in (0, 10 * Rpad):            # per mate: ws, start, flags, mq
        mq[off + 4 * Rpad : off + 5 * Rpad] = True
    compare_buffers(f"seeded step ({bs} pairs)", *bufs, mq)


def phase_single_end(pm, pairs, bs, kernels):
    """One batch through map_stream_encoded; each kernel in `kernels`
    must have launched in it."""
    reads = [a for a, _ in pairs[:bs]]
    reset_launches()
    t0 = time.time()
    out = [r for recs in pm.mapper.map_stream_encoded(iter([reads]))
           for r in recs]
    dt = time.time() - t0
    n = kernel_launches()
    assert len(out) == len(reads), (len(out), len(reads))
    for k in kernels:
        assert n[k] > 0, f"single-end path never launched {k}"
    seeding = "device" if pm.mapper.params.device_seed else "host"
    log(f"single-end, {seeding} seeding: {len(out)} records in {dt:.2f} s, "
        f"launches {json.dumps(n)}")


def phase_score_split(pm, spm, pairs):
    """One batch's score stage on each path, run alone (no other pipeline
    thread running): the host's preparation of both mates (prepare_batch,
    native, with host seeding; prepare_light, Python, with device
    seeding), the whole score call (preparation, packing, and enqueueing
    the device step) and the wait for the device after it."""
    for label, m, score, prep in (
            ("host seeding", pm, pm.score_pairs_device,
             lambda r: pm.mapper.prepare_batch(r, want_packed2=False)),
            ("device seeding", spm, spm.score_pairs_device_seeded,
             spm.mapper.prepare_light)):
        t0 = time.perf_counter()
        for mate in (0, 1):
            prep([p[mate] for p in pairs])
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        score(pairs)
        t3 = time.perf_counter()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        log(f"score stage alone, {label}, {len(pairs)} pairs: preparation "
            f"of both mates {t1 - t0:.4f} s; score call {t3 - t2:.4f} s, "
            f"then the device {t4 - t3:.4f} s")


def seed_kernel_inputs(mapper, reads):
    """The seeding kernels' inputs on one batch of the main path (mate 1
    of the first streamed batch), made on the card by the seeded step's
    own stages: rolling minimizers and lookup for softcap_compact, hit
    expansion for cluster_topc, the locality-sort key and its
    permutation for argsort_i32."""
    from vg_tpu_torch.ops import cuda_seed, devseed
    from vg_tpu_torch.ops.xfer import pack_reads4, unpack_reads4_dev

    p = mapper.params
    dev = mapper.device
    prep = mapper.prepare_light(reads)
    r = unpack_reads4_dev(torch.as_tensor(pack_reads4(prep["reads_arr"]),
                                          device=dev))
    rl = torch.as_tensor(prep["rlens"], device=dev)
    ih, il, ioff, ipos, irev, stab = mapper._resident_seed_arrays()
    mins = devseed.rolling_minimizers(r, rl, mapper.index.k,
                                      mapper.index.w)
    sc_in = devseed.softcap_inputs(*mins, ih, il, ioff, stab,
                                   hit_cap=p.hit_cap,
                                   hard_hit_cap=p.hard_hit_cap)
    selected = cuda_seed.softcap_compact(*sc_in,
                                         score_fraction=p.score_fraction)
    cl_in = devseed.expand_hits(selected, rl, ipos, irev,
                                k=mapper.index.k)
    cdiag, _, cvalid = cuda_seed.cluster_topc(
        *cl_in, band_radius=p.band_radius, max_candidates=p.max_candidates)
    key = torch.where(cvalid[:, 0], cdiag[:, 0] - p.band_radius,
                      cuda_seed.I32MAX)
    perm = cuda_seed.argsort_i32(key)
    return sc_in, cl_in, key, perm


def max_err(got, want) -> tuple:
    """(differing elements, max |difference|) over tuples of tensors."""
    bad, err = 0, 0.0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        bad += int((g != w).sum())
        d = (g.to(torch.float64) - w.to(torch.float64)).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return bad, err


def seed_counts(strandk) -> dict:
    """Valid seeds per row of a cluster_topc input: mean, p99, max, and
    the rows over the warp path's limit."""
    from vg_tpu_torch.ops import cuda_seed

    n = (strandk < 2).sum(dim=1)
    return dict(rows=int(n.numel()), mean=float(n.double().mean()),
                p99=float(torch.quantile(n.double(), 0.99)),
                max=int(n.max()),
                over_t=int((n > cuda_seed.CLUSTER_WARP_T).sum()))


def kept_counts(sc_in) -> dict:
    """Kept and nonzero-score columns a row of a softcap_compact input
    (mean, p99, max); the kernel sorts the nonzero ones."""
    out = {}
    for name, x in (("kept", sc_in[1]), ("nonzero", sc_in[0] != 0)):
        n = x.sum(dim=1).double()
        out[name] = dict(mean=float(n.mean()),
                         p99=float(torch.quantile(n, 0.99)),
                         max=int(n.max()))
    return out


def phase_seed_kernels(mapper, reads):
    """Each seeding kernel against its plain version on the card, exact:
    on the main path's own inputs and on the adversarial cases of
    vg_tpu_torch.ops.seed_cases (among them soft-cap rows of every width
    m = 1 to 1024, of 31-33 and 63-65 kept columns, zeros of either sign,
    negative scores and exclusive sums equal to the budget; cluster rows of
    1, 31, 32, 33, T - 1, T, T + 1 and 4096 valid seeds, non-quantized
    scores; argsort sizes around the warp and block widths). The soft-cap
    entry must take the instantiation of mpad / 32 columns a lane, and
    cluster_topc's block path exactly the rows over T of each input.
    Device times and bounds on the main path's inputs (plain, kernel,
    kernel, plain). Returns the numbers and the main path's inputs."""
    from vg_tpu_torch.ops import cuda_seed, seed_cases

    dev = mapper.device
    p = mapper.params
    sf, B, C = p.score_fraction, p.band_radius, p.max_candidates
    sc_in, cl_in, key, perm = seed_kernel_inputs(mapper, reads)
    kept = kept_counts(sc_in)
    log(f"softcap_compact main path batch: {sc_in[0].shape[0]} rows of "
        f"{sc_in[0].shape[1]} columns; kept columns a row mean "
        f"{kept['kept']['mean']:.2f}, p99 {kept['kept']['p99']:.1f}, max "
        f"{kept['kept']['max']}; nonzero scores a row mean "
        f"{kept['nonzero']['mean']:.2f}, p99 {kept['nonzero']['p99']:.1f}, "
        f"max {kept['nonzero']['max']}")
    dist = seed_counts(cl_in[0])
    before = cuda_seed.block_rows_read()
    cuda_seed.cluster_topc(*cl_in, band_radius=B, max_candidates=C)
    torch.cuda.synchronize()
    dist["block_rows"] = cuda_seed.block_rows_read() - before
    log(f"cluster_topc main path batch: {dist['rows']} rows, valid seeds a "
        f"row mean {dist['mean']:.2f}, p99 {dist['p99']:.1f}, max "
        f"{dist['max']}; {dist['over_t']} rows over T = "
        f"{cuda_seed.CLUSTER_WARP_T}, {dist['block_rows']} took the block "
        f"path")
    assert dist["block_rows"] == dist["over_t"], dist
    rng = np.random.default_rng(5)
    put = lambda arrs: [torch.as_tensor(a, device=dev) for a in arrs]
    # soft-cap cases off the path's score_fraction carry their own
    frac = lambda a: a[6] if len(a) > 6 else sf
    run = {
        "softcap_compact": (
            lambda a: cuda_seed.softcap_compact(*a[:6],
                                                score_fraction=frac(a)),
            lambda a: cuda_seed.softcap_compact_ref(
                *a[:6], score_fraction=frac(a))),
        "cluster_topc": (
            lambda a: cuda_seed.cluster_topc(*a, band_radius=B,
                                             max_candidates=C),
            lambda a: cuda_seed.cluster_topc_ref(*a, band_radius=B,
                                                 max_candidates=C)),
        "argsort_i32": (lambda a: (cuda_seed.argsort_i32(*a),),
                        lambda a: (cuda_seed.argsort_i32_ref(*a),)),
    }
    cases = {
        "softcap_compact": [("main path", sc_in), (
            f"adversarial R={BATCH}",
            put(seed_cases.softcap_case(rng, BATCH)))] + [
            (f"width m={m}", put(seed_cases.softcap_case(rng, 1024, m)))
            for m in seed_cases.SOFTCAP_WIDTHS] + [
            (f"kept columns {seed_cases.SOFTCAP_KEPT}",
             put(seed_cases.softcap_kept_case(rng, copies=64))),
            ("signed zeros and negative scores R=1024",
             put(seed_cases.softcap_sign_case(rng, 1024))),
            ("signed zeros and negative scores R=512 m=600, fraction 0.7",
             put(seed_cases.softcap_sign_case(rng, 512, 600)) + [0.7]),
            ("exclusive sum at the budget R=1024, fraction 0.5",
             put(seed_cases.softcap_budget_case(rng, 1024)) + [0.5])],
        "cluster_topc": [("main path", cl_in)] + [
            (f"adversarial R={R} S={S}",
             put(seed_cases.cluster_case(rng, R, S, B)))
            for R, S in ((BATCH, 4096), (1024, 1024), (1024, 256))] + [
            (f"seed counts {seed_cases.CLUSTER_COUNTS} S={S}",
             put(seed_cases.cluster_count_case(rng, S, B, copies=8)))
            for S in (4096, 1024)] + [
            (f"non-quantized R=1024 S={S}",
             put(seed_cases.cluster_float_case(rng, 1024, S, B)))
            for S in (4096, 1024, 256)],
        "argsort_i32": [("main path key", (key,)),
                        ("main path perm", (perm,))] + [
            (f"adversarial n={n}",
             (torch.as_tensor(seed_cases.argsort_case(rng, n), device=dev),))
            for n in seed_cases.ARGSORT_SIZES],
    }
    out = {}
    for name, items in cases.items():
        kern, plain = run[name]
        bad_all, err_all = 0, 0.0
        for label, args in items:
            rows0 = cuda_seed.block_rows_read()
            items0 = cuda_seed.softcap_launches_by_items()
            got = kern(args)
            torch.cuda.synchronize()
            bad, err = max_err(got, plain(args))
            extra = ""
            if name == "softcap_compact":
                items1 = cuda_seed.softcap_launches_by_items()
                took = [e for e in items1 if items1[e] != items0[e]]
                want = got[0].shape[1] // 32
                extra = f"; {want} columns a lane"
                assert took == [want], (label, took, want)
            if name == "cluster_topc":
                took = cuda_seed.block_rows_read() - rows0
                over = seed_counts(args[0])["over_t"]
                extra = f"; {took} rows on the block path, {over} over T"
                assert took == over, (label, took, over)
            log(f"{name} vs plain, {label}: {bad} mismatches, max |err| "
                f"{err}{extra}")
            bad_all += bad
            err_all = max(err_all, err)
        if bad_all:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {bad_all} elements")
        args = items[0][1]
        if name == "softcap_compact":
            nbytes, ops = cuda_seed.softcap_work(*args[0].shape)
        elif name == "cluster_topc":
            nbytes, ops = cuda_seed.cluster_work(args[0], C)
        else:
            nbytes, ops = cuda_seed.argsort_work(args[0].shape[0])
        lib = (lambda: torch.argsort(args[0], stable=True)) \
            if name == "argsort_i32" else None
        out[name] = dict(
            timed_turns(lambda: kern(args), lambda: plain(args), 20, 3,
                        library=lib),
            **bound(nbytes, ops), mismatches=bad_all, max_abs_err=err_all,
            shape="x".join(str(d) for d in args[0].shape))
    out["cluster_topc"]["seed_counts"] = dist
    out["softcap_compact"]["kept_counts"] = kept
    return out, (sc_in, cl_in, key)


def load_parent(root, module):
    """The ops.<module> module of the vg_tpu_torch package under `root`,
    imported (once) as the package parent_vg_tpu_torch: it builds its own
    kernels from its own sources."""
    import importlib
    import importlib.util

    if "parent_vg_tpu_torch" not in sys.modules:
        pkg = pathlib.Path(root).resolve() / "vg_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            "parent_vg_tpu_torch", pkg / "__init__.py",
            submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules["parent_vg_tpu_torch"] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"parent_vg_tpu_torch.ops.{module}")


def turns(name, fns, mods, card, iters=20) -> dict:
    """Device and enqueue ms of fns(mod) for the parent and this tree in
    turns (parent, this, this, parent)."""
    runs = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        m = mods[who]
        dev_ms, ahead = device_ms(lambda: fns(m), iters)
        runs[who].append(dict(ms=dev_ms, ahead=ahead,
                              enqueue_ms=cuda_ms(lambda: fns(m), iters)))
    log(f"{name}, parent vs this tree (same outputs): device ms parent "
        f"{[r['ms'] for r in runs['parent']]}, this "
        f"{[r['ms'] for r in runs['this']]}; enqueue ms parent "
        f"{[r['enqueue_ms'] for r in runs['parent']]}, this "
        f"{[r['enqueue_ms'] for r in runs['this']]} on {card}")
    return runs


def phase_compare_parent(root, seed_inputs, dp_inputs, sf, B, C, card):
    """The parent tree's softcap_compact, cluster_topc, argsort_i32 and
    packed banded DP against this tree's on the main path's inputs: the
    same outputs, then device and enqueue times in turns (parent, this,
    this, parent). The parent's link kernels (compare_parent_links) and
    quality entry (compare_parent_qual) meet theirs where their inputs
    are made, in the long-read and vg map phases."""
    from vg_tpu_torch.ops import cuda_align, cuda_seed

    sc_in, cl_in, key = seed_inputs
    packed, T, t = dp_inputs
    par_seed = load_parent(root, "cuda_seed")
    par_align = load_parent(root, "cuda_align")
    t0 = time.time()
    par_seed.library()
    par_align.library()
    log(f"parent seed_kernels.cu and banded_dp.cu built in "
        f"{time.time() - t0:.1f} s from {root}")
    for info in (par_align.build_info, par_seed.build_info):
        for line in info.get("ptxas", "").splitlines():
            if "registers" in line or "Compiling entry" in line:
                log("  parent ptxas: " + line.strip())
    mods = {"parent": (par_seed, par_align), "this": (cuda_seed, cuda_align)}
    fns = {"softcap_compact": lambda m: m[0].softcap_compact(
               *sc_in, score_fraction=sf),
           "cluster_topc": lambda m: m[0].cluster_topc(
               *cl_in, band_radius=B, max_candidates=C),
           "argsort_i32": lambda m: (m[0].argsort_i32(key),),
           "banded_dp": lambda m: (m[1].banded_scores_packed(
               packed, T, *t, band_radius=B),)}
    res = {}
    for name, fn in fns.items():
        bad, _ = max_err(fn(mods["parent"]), fn(mods["this"]))
        assert bad == 0, f"{name}: parent and this tree differ on {bad}"
        res[name] = turns(f"{name} on the main path's inputs", fn, mods,
                          card)
    print(json.dumps({"compare_parent": res}), flush=True)
    return res


def compare_parent_links(root, captured, text_packed, kw0, card) -> dict:
    """The parent tree's link_fill and link_walk against this tree's on
    the long-read batch's captured bucket inputs: the same outputs (every
    entry), then device and enqueue times in turns; and the SASS of the
    parent's link kernels."""
    from vg_tpu_torch.ops import cuda_links

    par = load_parent(root, "cuda_links")
    t0 = time.time()
    par.library()
    log(f"parent link_engine.cu built in {time.time() - t0:.1f} s from "
        f"{root}")
    for name, loop in link_loops(par.build_info["path"]).items():
        log(f"  parent sass {name}: {loop_text(loop)}")
    mods = {"parent": par, "this": cuda_links}
    res = {}
    for RMAX in sorted(captured):
        args = link_args(captured[RMAX], text_packed, "cuda")
        kw = dict(kw0, RMAX=RMAX)
        fill = lambda m: m.link_fill(*args, **kw)
        got, want = fill(cuda_links), fill(par)
        bits = want[1]
        walk = lambda m: m.link_walk(bits, args[1], args[3], args[4])
        got += walk(cuda_links)
        want += walk(par)
        torch.cuda.synchronize()
        bad = sum(int((g.to(torch.int64) != w.to(torch.int64)).sum())
                  for g, w in zip(got, want))
        assert bad == 0, f"bucket {RMAX}: parent and this tree differ on " \
            f"{bad} link outputs"
        del got, want
        for name, fn in (("link_fill", fill), ("link_walk", walk)):
            res[f"{name} {RMAX}"] = turns(
                f"{name} on the long-read batch's bucket {RMAX} (N = "
                f"{args[0].shape[0]})", fn, mods, card)
        del args, bits
    print(json.dumps({"compare_parent_links": res}), flush=True)
    return res


def profiled(fn):
    """Run fn under torch.profiler: (its device events as (name, µs),
    wall seconds). Reads the profiler's raw events: building its event
    tree (`events()`) costs tens of µs an event, and a streamed paired
    path records tens of thousands of them. The profiler records the
    kernels that the port's own libraries launch only once a torch
    kernel has run in the profiled region, so one short spin kernel runs
    first, before the wall clock starts, and its event is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100)
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and "spin_kernel" not in e.name()], wall


def phase_profile(pm, pairs, bs, n_batches, label, top=12):
    """One more pass of a paired stream under torch.profiler: device time
    by kernel (the `top` largest, then each hand-written kernel of the
    port), and the device's busy share of the wall time (kernels and
    copies on the card, summed; the pipeline uses one stream)."""
    from vg_tpu_torch.parallel.pipeline import map_pairs_encoded_mt

    stream = pairs[bs : bs * (n_batches + 1)]
    out = []
    events, wall = profiled(lambda: out.extend(map_pairs_encoded_mt(
        pm, (stream[i : i + bs] for i in range(0, len(stream), bs)))))
    n = sum(len(o) for o in out)
    by_name, calls = {}, {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us / 1e3
        calls[name] = calls.get(name, 0) + 1
    busy = sum(by_name.values())
    log(f"profile, {label}: {n} records in {wall:.3f} s wall, device busy "
        f"{busy:.2f} ms ({100 * busy / (1e3 * wall):.2f}% of wall, idle "
        f"{100 - 100 * busy / (1e3 * wall):.2f}%), {len(by_name)} kernels")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {ms:9.3f} ms  {calls[name]:5d}x  {name[:100]}")
    for name, ms in sorted(by_name.items()):    # the port's own kernels
        if "(anonymous namespace)::" in name and "at::native" not in name:
            short = name.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            log(f"  hand-written: {ms:9.3f} ms  {calls[name]:5d}x  {short}")
    sorts = {n: ms for n, ms in by_name.items() if "sort" in n.lower()}
    log(f"  device sorts: {len(sorts)} kernels, "
        f"{sum(sorts.values()):.3f} ms ({', '.join(sorted(sorts))[:300]})")


def gather_windows(text_t, t, B):
    """The (N, TW) windows, oriented reads and lengths of a candidate
    table, as banded_scores_via_pallas hands them to the TPU kernel
    (banded_scores_pallas): windows masked to [lo, hi) with sentinel 6,
    invalid slots rlen 0. N = R * C, a multiple of 128 on these tables."""
    reads, reads_rc, rlen, start, lo, hi, rev, valid = t
    R, RL = reads.shape
    C = start.shape[1]
    T = text_t.shape[0]
    pos = (start.reshape(-1).to(torch.int64)[:, None]
           + torch.arange(RL + 2 * B, device=text_t.device))
    ok = ((pos >= lo.reshape(-1)[:, None]) & (pos < hi.reshape(-1)[:, None])
          & (pos >= 0) & (pos < T))
    win = torch.where(ok, text_t[pos.clamp(0, T - 1)], 6).to(torch.uint8)
    rd = torch.where(rev.reshape(-1)[:, None],
                     reads_rc.repeat_interleave(C, 0),
                     reads.repeat_interleave(C, 0)).contiguous()
    rl = torch.where(valid.reshape(-1), rlen[:R].repeat_interleave(C),
                     0).to(torch.int32)
    return win, rd, rl


def bound(nbytes, ops) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    int32 operations over the issue rate, whichever is longer."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return dict(bound_ms=max(t_b, t_o) * 1e3,
                bound_by="operations" if t_o >= t_b else "bytes",
                bytes=nbytes, ops=ops)


def time_entry(kern, plain, nbytes, ops):
    """Kernel and plain-version device milliseconds in turns, the
    kernel's enqueue-inclusive time, and the bound of the work."""
    return dict(timed_turns(kern, plain, 50, 3), **bound(nbytes, ops))


def phase_dp_entries(text, real_batches):
    """Kernels 1c (banded_dp_bytes) and 1b (banded_dp_windows) against
    their plain versions on the card, exact: on the main path's first
    batch (1c on the byte text and its candidate tables, 1b on the windows
    gathered from them: N = 49,152 slots, TW = 192), on adversarial
    batches at B = 8, 12 and 16, and for 1b on a batch with rlen > RL at
    RL = 157 (pad rows up to RLP = 160). On every batch with rlen <= RL
    each also equals the packed kernel's scores on the same slots. Times
    and bounds on the main path's first batch. Returns each entry's
    numbers and the launches of its checks (the timing runs apart)."""
    from vg_tpu_torch.ops import align, cuda_align, dp_cases

    dev = torch.device("cuda")
    T = len(text)
    text_t = torch.as_tensor(text, device=dev)
    packed = torch.as_tensor(cuda_align.pack_text(text), device=dev)
    rng = np.random.default_rng(4)
    cases = [("main path batch 0", BAND, real_batches[0])] + [
        (f"adversarial R=1024 B={b}", b, adversarial_batch(rng, text, 1024,
                                                           B=b))
        for b in (8, 12, BAND)] + [
        (f"valid-slot patterns R=1024 B={b}", b,
         dp_cases.block_case(rng, R=1024, B=b, text=text)[1:])
        for b in (8, 12, BAND)]
    put = lambda arrs: [torch.as_tensor(np.ascontiguousarray(x), device=dev)
                        for x in arrs]
    out = {name: dict(mismatches=0, max_abs_err=0, vs_packed=0)
           for name in ("banded_dp_bytes", "banded_dp_windows")}
    reset_launches()
    for label, b, arrs in cases:
        t = put(arrs)
        pk = cuda_align.banded_scores_packed(packed, T, *t, band_radius=b)
        got_b = cuda_align.banded_scores_bytes(text_t, *t, band_radius=b)
        win, rd, rl = gather_windows(text_t, t, b)
        got_w = cuda_align.banded_scores_windows(win, rd, rl, band_radius=b)
        torch.cuda.synchronize()
        want_b = align.banded_scores(text_t, *t, band_radius=b)
        want_w = cuda_align.banded_scores_windows_ref(win, rd, rl,
                                                      band_radius=b)
        for name, got, want, same in (
                ("banded_dp_bytes", got_b, want_b, pk),
                ("banded_dp_windows", got_w, want_w,
                 pk.reshape(-1).clamp_min(0))):
            bad, err = max_err((got,), (want,))
            n_pk = int((got != same).sum())
            log(f"{name} vs plain, {label}: {tuple(got.shape)} {bad} "
                f"mismatches, max |err| {err}; {n_pk} differ from the "
                f"packed kernel")
            o = out[name]
            o["mismatches"] += bad
            o["max_abs_err"] = max(o["max_abs_err"], err)
            o["vs_packed"] += n_pk
        if label == "main path batch 0":
            main = (t, win, rd, rl)
    # 1b past RL: 157-column read rows, a fifth of the slots longer
    t = put(adversarial_batch(rng, text, 1024, RL=157))
    win, rd, rl = gather_windows(text_t, t, BAND)
    over = torch.as_tensor(rng.random(rl.shape[0]) < 0.2, device=dev)
    rl = torch.where(over & (rl > 0), rl + torch.as_tensor(
        rng.integers(1, 13, rl.shape[0]), device=dev), rl).to(torch.int32)
    got = cuda_align.banded_scores_windows(win, rd, rl, band_radius=BAND)
    torch.cuda.synchronize()
    bad, err = max_err((got,), (cuda_align.banded_scores_windows_ref(
        win, rd, rl, band_radius=BAND),))
    log(f"banded_dp_windows vs plain, rlen > RL (RL=157, "
        f"{int((rl > 157).sum())} slots past RL, {int((rl > 160).sum())} "
        f"past RLP): {bad} mismatches, max |err| {err}")
    out["banded_dp_windows"]["mismatches"] += bad
    out["banded_dp_windows"]["max_abs_err"] = max(
        out["banded_dp_windows"]["max_abs_err"], err)
    launches = kernel_launches()
    for name, o in out.items():
        if o["mismatches"] or o["vs_packed"]:
            raise AssertionError(f"{name}: {o['mismatches']} mismatches "
                                 f"with its plain version, {o['vs_packed']} "
                                 f"with the packed kernel")
        o["check_launches"] = launches[name]
    t, win, rd, rl = main
    nbytes, ops = cuda_align.dp_work(t[0], t[2], t[-1], T, BAND,
                                     source="bytes")
    out["banded_dp_bytes"].update(time_entry(
        lambda: cuda_align.banded_scores_bytes(text_t, *t, band_radius=BAND),
        lambda: align.banded_scores(text_t, *t, band_radius=BAND),
        nbytes, ops), shape=f"R={t[0].shape[0]} C={t[3].shape[1]} "
                            f"RL={t[0].shape[1]} B={BAND} T={T}")
    nbytes, ops = cuda_align.dp_work(rd, rl, None, win.numel(), BAND,
                                     source="windows")
    out["banded_dp_windows"].update(time_entry(
        lambda: cuda_align.banded_scores_windows(win, rd, rl,
                                                 band_radius=BAND),
        lambda: cuda_align.banded_scores_windows_ref(win, rd, rl,
                                                     band_radius=BAND),
        nbytes, ops), shape=f"N={win.shape[0]} TW={win.shape[1]} "
                            f"RL={rd.shape[1]} B={BAND}")
    return out


FRAG_MU, FRAG_SD = 450.0, 50.0   # the fixture's fragment model


def step_mates(mates) -> list:
    """The two mates of a prepared batch as the paired steps take them:
    (reads, reads_rc, rlen, (start, lo, hi, rev, valid, refpath, refoff)),
    numpy, the batch's own rows."""
    out = []
    for m in mates:
        R = len(m["cand_refpath"])
        a = [np.ascontiguousarray(m[k][:R])
             for k in ("reads_arr", "reads_rc_arr", "rlens", "cand_start",
                       "cand_lo", "cand_hi", "cand_rev", "cand_valid",
                       "cand_refpath")]
        out.append((a[0], a[1], a[2],
                    (*a[3:], m["cand_refoff"][:R].astype(np.int32))))
    return out


def phase_byte_step(haps, mates):
    """make_paired_step() with its default score function, the byte-text
    DP (kernel 1c for CUDA tensors), against the step the mapper builds
    on the packed text (kernel 1) on the main path's first batch: every
    output equal, MAPQs included. Returns 1c's launches in it and the
    step's outputs."""
    from vg_tpu_torch.ops import cuda_align
    from vg_tpu_torch.parallel.mesh import make_paired_step

    dev = torch.device("cuda")
    text = haps.text
    T = len(text)
    put = lambda a: torch.as_tensor(a, device=dev)
    args = []
    for reads, reads_rc, rlen, cand in step_mates(mates):
        args += [put(reads), put(reads_rc), put(rlen),
                 tuple(put(a) for a in cand)]
    mu = torch.tensor(FRAG_MU, device=dev)
    sd = torch.tensor(FRAG_SD, device=dev)

    def packed_fn(tp, reads, rc, rlen, cand):
        return cuda_align.banded_scores_packed(tp, T, reads, rc, rlen,
                                               *cand[:5], band_radius=BAND)

    packed_step = make_paired_step(band_radius=BAND, score_fn=packed_fn,
                                   text_packed=True, text_len=T)
    want = packed_step(torch.as_tensor(cuda_align.pack_text(text),
                                       device=dev), *args, mu, sd)
    before = cuda_align.banded_scores_bytes.launches
    got = make_paired_step(band_radius=BAND)(
        torch.as_tensor(text, device=dev), *args, mu, sd)
    torch.cuda.synchronize()
    n = cuda_align.banded_scores_bytes.launches - before
    bad = {k: int((g != w).sum()) for k, g, w in zip(STEP_NAMES, got, want)}
    log(f"byte-text paired step (default score function) vs packed step, "
        f"{args[0].shape[0]} pairs: {sum(bad.values())} differing entries "
        f"({json.dumps(bad)}), {int(got[6].sum())} pairs chosen, "
        f"banded_dp_bytes launched {n} times")
    assert sum(bad.values()) == 0, f"byte-text step differs: {bad}"
    assert n == 2, f"the byte-text step launched banded_dp_bytes {n} times"
    return n, got


STEP_NAMES = ["s1", "s2", "j1", "j2", "mq1", "mq2", "use_pair", "frags",
              "mm1", "mm2", "bits1", "bits2", "stats", "cov"]
N_SHARDS = 4              # text shards of the in-process sharded steps


def differing(got, want) -> dict:
    """Entries that differ, output by output (on the host)."""
    return {k: int((g.cpu() != w.cpu()).sum())
            for k, g, w in zip(STEP_NAMES, got, want)}


def rescue_inputs(haps, idx, mem, batch, device):
    """Real rescue candidates, as tests/test_mesh.py builds them: the
    batch scored by a PairedGiraffeMapper with a finalized fragment model,
    mate 2's candidates wiped so every mapped pair needs rescue, then
    _rescue_begin (the host seed scan and the native host DP). Returns
    the oriented reads, their lengths, the candidates and the host
    scores."""
    from vg_tpu_torch.map.giraffe import GiraffeMapper, GiraffeParams
    from vg_tpu_torch.map.paired import PairedGiraffeMapper

    m = GiraffeMapper(haps, idx, GiraffeParams(batch_reads=len(batch)),
                      device=device)
    m._mem_fallback_index = mem
    pm = PairedGiraffeMapper(m)
    for _ in range(64):
        pm.fragdist.add(FRAG_MU)
    pm.fragdist.finalize()
    sb1, sb2 = pm.score_pairs(batch)
    _ = sb1.scores, sb2.scores
    sb2.cand_valid[:] = False
    state = pm._rescue_begin(sb1, sb2)
    assert state is not None, "rescue did not fire"
    todo, r_start, r_lo, r_hi, r_rev, r_valid, host = state
    R = len(sb2.codes)
    reads = np.full((R, max(len(c) for c in sb2.codes)), 5, np.uint8)
    rlen = np.zeros(R, np.int32)
    row_rev = r_rev.any(axis=1)
    for i in range(R):
        c = sb2.codes_rc[i] if row_rev[i] else sb2.codes[i]
        reads[i, : len(c)] = c
        rlen[i] = len(c)
    return (reads, rlen, r_start, r_lo, r_hi, r_valid), \
        np.where(r_valid, np.asarray(host), -1), len(todo), m.params


def phase_sharded(haps, idx, mem, batch, mates, replicated, card,
                  device="cuda"):
    """The multi-device half of parallel/mesh.py on the main path's first
    batch at full width (6,144 pairs, C = 8, RL = 160, B = 16, the 5 Mbp
    text): on a mesh of one rank (NCCL; gloo for device="cpu"),
    sharded_paired_step against the replicated byte-text step
    (phase_byte_step's output, `replicated`) and sharded_map_step's
    coverage against the rows with a positive score; in this process, the
    text-sharded paired step holding all N_SHARDS text shards against the
    replicated step; rescue candidates from _rescue_begin scored by
    sharded_rescue_scores on the mesh and by the N_SHARDS-shard scorer,
    against the host scores and 1c's plain version. Every entry must be
    equal. The launch counts are reset before the steps and read after
    them. Then the device time of the N_SHARDS-shard step against the
    replicated one, and of 1c's owner-masked shard launches against one
    launch on the whole text. Returns 1c's launches in the steps."""
    import datetime
    import os
    import tempfile

    import torch.distributed as dist

    from vg_tpu_torch.ops import align, cuda_align
    from vg_tpu_torch.parallel import mesh as pmesh

    t0 = time.time()
    dev = torch.device(device)
    text = haps.text
    m1, m2 = step_mates(mates)
    (reads, rlen, r_start, r_lo, r_hi, r_valid), host, n_todo, p = \
        rescue_inputs(haps, idx, mem, batch, device)
    kw = dict(band_radius=p.band_radius, match=p.match, mismatch=p.mismatch,
              gap_open=p.gap_open, gap_extend=p.gap_extend,
              bonus=p.full_length_bonus)
    t_host = time.time() - t0
    # the in-process text-sharded forms: shards and localized tables
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    halo = m1[0].shape[1] + 2 * BAND + 16
    own, shards = pmesh.split_text_shards(text, N_SHARDS, halo)
    loc = [pmesh.localize_candidates(m[3], own, N_SHARDS, halo)
           for m in (m1, m2)]
    rhalo = reads.shape[1] + 2 * BAND + 16
    rown, rshards = pmesh.split_text_shards(text, N_SHARDS, rhalo)
    zeros = np.zeros_like(r_valid)
    rloc = pmesh.localize_candidates(
        (r_start, r_lo, r_hi, zeros, r_valid, np.full(r_valid.shape, -1),
         np.zeros(r_valid.shape, np.int64)), rown, N_SHARDS, rhalo)
    args4 = (put(shards), put(pmesh.basediff_table(own, N_SHARDS)),
             *(put(a) for a in m1[:3]), tuple(put(a) for a in loc[0]),
             *(put(a) for a in m2[:3]), tuple(put(a) for a in loc[1]),
             FRAG_MU, FRAG_SD)
    step4 = pmesh.make_sharded_text_paired_step(N_SHARDS, own, halo,
                                                band_radius=BAND)
    rargs4 = (put(rshards), put(reads), put(rlen),
              *(put(a) for a in rloc[:4]), put(rloc[6]))
    rescue4 = pmesh.make_sharded_rescue_scorer(N_SHARDS, **kw)

    edges = shard_edges(dev)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")   # one host
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group(
            pmesh.BACKENDS[device], init_method=f"file://{d}/store", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=60))
        try:
            mesh = pmesh.make_mesh(device=device)
            reset_launches()
            out_dp = pmesh.sharded_paired_step(
                mesh, text, m1, m2, FRAG_MU, FRAG_SD, band_radius=BAND)
            scores, cov = pmesh.sharded_map_step(
                mesh, text, *m1[:3], *m1[3][:5], band_radius=BAND)
            out4 = step4(*args4)
            s_mesh = pmesh.sharded_rescue_scores(
                mesh, text, reads, rlen, r_start, r_lo, r_hi, r_valid, **kw)
            s4 = rescue4(*rargs4)
            if device == "cuda":
                torch.cuda.synchronize()
            n = kernel_launches()["banded_dp_bytes"]
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    plain = align.banded_scores(
        put(text), put(reads), put(reads), put(rlen), put(r_start),
        put(r_lo), put(r_hi), put(zeros), put(r_valid), **kw)
    bad_dp = differing(out_dp, replicated)
    bad4 = differing(out4, replicated)
    hostt = torch.as_tensor(host)
    bad_rescue = {k: int((v.cpu() != hostt).sum()) for k, v in (
        ("mesh", s_mesh), (f"{N_SHARDS} shards", s4), ("plain", plain))}
    rows_hit = int((scores.max(dim=1).values > 0).sum())
    owners = np.bincount(np.concatenate([c[1][c[6]] for c in loc]),
                         minlength=N_SHARDS).tolist()
    log(f"sharded steps, {len(m1[0])} pairs on a mesh of 1 rank "
        f"({backend}): sharded_paired_step vs the replicated byte-text "
        f"step {sum(bad_dp.values())} differing entries "
        f"({json.dumps(bad_dp)}); sharded_map_step coverage {int(cov.sum())}"
        f" = {rows_hit} rows with a positive score; {N_SHARDS}-shard text "
        f"step (valid candidates a shard {owners}) vs the replicated "
        f"{sum(bad4.values())} differing ({json.dumps(bad4)}), "
        f"{int(out4[6].sum())} pairs chosen; rescue, {int(r_valid.sum())} "
        f"candidates of {n_todo} pairs ({int((host > 0).sum())} positive): "
        f"differing from the host scores {json.dumps(bad_rescue)}; "
        f"banded_dp_bytes launched {n} times ({t_host:.1f} s on the host "
        f"for the rescue candidates)")
    assert sum(bad_dp.values()) == 0, f"sharded_paired_step: {bad_dp}"
    assert torch.equal(scores.cpu(), replicated[0].cpu()), "map step scores"
    assert int(cov.sum()) == rows_hit, "map step coverage"
    assert sum(bad4.values()) == 0, f"{N_SHARDS}-shard step: {bad4}"
    assert sum(bad_rescue.values()) == 0, f"rescue: {bad_rescue}"
    assert (host > 0).any(), "no rescue succeeded"
    assert sum(edges.values()) == 0, f"shard-edge batch: {edges}"
    if device == "cuda":
        # 2 (paired) + 1 (map) + 2 x N_SHARDS (text step) + 1 (rescue on
        # the one-rank mesh) + N_SHARDS (rescue scorer)
        assert n == 4 + 3 * N_SHARDS, f"banded_dp_bytes launched {n} times"
        time_sharded(text, m1, m2, args4, step4, card)
    log(f"sharded phase {time.time() - t0:.1f} s")
    return n


def shard_edges(dev) -> dict:
    """parallel/shard_cases.shard_case (windows before the text, in the
    halo, past the text; lo and hi clipped; masked slots) through the
    text-sharded paired step and the rescue scorer on 2 and 4 shards on
    dev, against the same steps on the CPU (1c's plain version). Returns
    the differing entries by shard count."""
    from vg_tpu_torch.parallel import mesh as pmesh
    from vg_tpu_torch.parallel.shard_cases import B, sharded_inputs

    bad = {}
    for D in (2, 4):
        own, halo, step, rescue = sharded_inputs(D, dev)
        _, _, step_c, rescue_c = sharded_inputs(D, torch.device("cpu"))
        tstep = pmesh.make_sharded_text_paired_step(D, own, halo,
                                                    band_radius=B)
        scorer = pmesh.make_sharded_rescue_scorer(D, band_radius=B)
        bad[D] = (sum(differing(tstep(*step), tstep(*step_c)).values())
                  + int((scorer(*rescue).cpu() != scorer(*rescue_c)).sum()))
    log(f"shard-edge batch (shard_case) on {dev.type} vs the CPU, by "
        f"shard count: {json.dumps(bad)} differing entries")
    return bad


def time_sharded(text, m1, m2, args4, step4, card):
    """Device ms, in turns, of the N_SHARDS-shard step against the
    replicated byte-text step, and of 1c's owner-masked shard launches
    (mate 1's, as the step makes them) against one launch on the whole
    text."""
    from vg_tpu_torch.ops import cuda_align
    from vg_tpu_torch.parallel.mesh import make_paired_step

    dev = torch.device("cuda")
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    text_t = put(text)
    g1, g2 = ((*(put(a) for a in m[:3]), tuple(put(a) for a in m[3]))
              for m in (m1, m2))
    repl = make_paired_step(band_radius=BAND)
    reads, rc, rlen, cand = g1
    sl, ow, lo, hi, _hap, rev, valid, _rp, _ro = args4[5]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    masked = []
    for d in range(N_SHARDS):
        v = valid & (ow == d)
        masked.append((args4[0][d], torch.where(v, sl, zero),
                       torch.where(v, lo, zero), torch.where(v, hi, zero),
                       rev, v))
    run4 = lambda: step4(*args4)
    run_repl = lambda: repl(text_t, *g1, *g2, FRAG_MU, FRAG_SD)
    step = timed_turns(run4, run_repl, 20, 20)
    # one call of each under the profiler: the card's busy time (the
    # steps launch hundreds of small kernels, so the events above can
    # include the host's enqueue), and how much of it is the DP
    busy = {}
    for label, fn in ((f"{N_SHARDS}-shard", run4), ("replicated", run_repl)):
        events, wall = profiled(fn)
        by_name = {}
        for name, us in events:
            by_name[name] = by_name.get(name, 0.0) + us / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        busy[label] = dict(
            busy_ms=sum(by_name.values()), kernels=len(events),
            dp_ms=sum(ms for n, ms in by_name.items() if "banded_dp" in n),
            wall_ms=1e3 * wall)
        log(f"  {label} step under the profiler: device busy "
            f"{busy[label]['busy_ms']:.4f} ms in {len(events)} kernels "
            f"({busy[label]['dp_ms']:.4f} ms banded_dp), wall "
            f"{1e3 * wall:.2f} ms; largest: " + "; ".join(
                f"{ms:.4f} ms {n[:60]}" for n, ms in top))
    dp = timed_turns(
        lambda: [cuda_align.banded_scores_bytes(
            t, reads, rc, rlen, s, l, h, r, v, band_radius=BAND)
            for t, s, l, h, r, v in masked],
        lambda: cuda_align.banded_scores_bytes(
            text_t, reads, rc, rlen, *cand[:5], band_radius=BAND), 50, 50)
    log(f"{N_SHARDS}-shard text step {step['ms']:.4f} ms on the device "
        f"(runs {step['kernel_runs_ms']}, host ahead {step['host_ahead']}) "
        f"vs the replicated step {step['plain_ms']:.4f} ms (runs "
        f"{step['plain_runs_ms']}); banded_dp_bytes, mate 1: "
        f"{N_SHARDS} owner-masked shard launches {dp['ms']:.4f} ms (runs "
        f"{dp['kernel_runs_ms']}) vs one launch on the whole text "
        f"{dp['plain_ms']:.4f} ms (runs {dp['plain_runs_ms']}), on {card}")
    return dict(step_ms=step["ms"], replicated_ms=step["plain_ms"],
                shard_launches_ms=dp["ms"], whole_launch_ms=dp["plain_ms"],
                profiled=busy)


def longread_reads(rng, haps):
    """bench.py's long-read sidecar reads: LR_READS reads of LR_LEN bp from
    the haplotype text, 0.5% substitutions; with their start positions."""
    from vg_tpu_torch.io.fastq import Read
    from vg_tpu_torch.utils import dna

    T = len(haps.text)
    reads, starts = [], []
    for i in range(LR_READS):
        s = int(rng.integers(0, T - LR_LEN - 100))
        c = haps.text[s : s + LR_LEN].copy()
        err = rng.random(len(c)) < 0.005
        c[err] = (c[err] + rng.integers(1, 4, int(err.sum()))) % 4
        reads.append(Read(name=f"lr{i}", sequence=dna.decode(c), quality=""))
        starts.append(s)
    return reads, starts


def longread_placed(lrm, recs, reads, starts) -> float:
    """Share of records placed as tests/test_longread.py requires: the
    first refpos within 1000 bp of the read start's reference position
    (or within 1050 bp of its end, for a reverse placement)."""
    from vg_tpu_torch.io.gam import Alignment

    ok = 0
    for rec, read, s in zip(recs, reads, starts):
        aln = Alignment.decode(bytes(rec))
        if not aln.refpos:
            continue
        got = aln.refpos[0].offset
        node, off, _ = lrm.haps.text_pos_to_graph(int(s))
        fwd = lrm.path_pos.positions_of(node, off, False)
        w = fwd[0].offset if fwd else -1
        ok += (abs(got - w) <= 1000
               or abs(got - (w + len(read.sequence))) <= 1050)
    return ok / max(len(recs), 1)


LINK_BIG_N = 43_008        # bucket-768 tasks past vg_tpu's int32 index
LINK_KERNELS = ("link_pack", "link_fill", "link_walk", "link_runs")
LINK_HOST_PASSES = (       # (module, function) the device engine calls
    ("vg_tpu_torch.map.longread", "LongReadMapper._device_batch"),
    ("vg_tpu_torch.native", "native_longread_chains"),
    ("vg_tpu_torch.native", "native_longread_collect_links"),
    ("vg_tpu_torch.ops.device_links", "DeviceLinkAligner.align_runs_blob"),
    ("vg_tpu_torch.ops.device_links", "splice_runs"),
    ("vg_tpu_torch.native", "native_global_align_batch"),
    ("vg_tpu_torch.native", "native_longread_stitch"),
    ("vg_tpu_torch.native", "native_emit_runs_gam"))


@contextlib.contextmanager
def timed_passes(acc):
    """Seconds of each of LINK_HOST_PASSES, summed into acc[name]."""
    import importlib

    with contextlib.ExitStack() as stack:
        for mod, name in LINK_HOST_PASSES:
            owner = importlib.import_module(mod)
            for part in name.split(".")[:-1]:
                owner = getattr(owner, part)
            box = stack.enter_context(timed_method(
                owner, name.split(".")[-1], [0.0]))
            acc[name.split(".")[-1]] = box
        yield acc


def link_args(arrs, text_packed, dev):
    """link_fill's task tensors on `dev` from numpy arrays in
    DeviceLinkAligner's layout (a4 uint32 words; la, ta, base, lb int32)
    or from the tensors it hands its engine."""
    a4, la, ta, ba, lb = arrs[:5]
    if isinstance(a4, np.ndarray):
        a4 = a4.view(np.int32)
    put = lambda x: torch.as_tensor(
        np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x,
        device=dev)
    return (put(a4), put(la), put(ta), put(ba), put(lb),
            text_packed.to(dev))


def check_links(args, kw) -> dict:
    """link_fill and link_walk on the card against their plain versions on
    the card, on the same inputs (the walk on the plain fill's bits):
    differing entries and the largest absolute difference of each output.
    Returns the plain outputs too, for timing."""
    from vg_tpu_torch.ops import cuda_links

    got_f = cuda_links.link_fill(*args, **kw)
    want_f = cuda_links.link_fill_ref(*args, **kw)
    walk_in = (want_f[1], args[1], args[3], args[4])
    got_w = cuda_links.link_walk(*walk_in)
    want_w = cuda_links.link_walk_ref(*walk_in)
    torch.cuda.synchronize()
    res = dict(output_diff("link_fill", ("score", "bits"), got_f, want_f),
               **output_diff("link_walk", ("packed", "n_steps", "complete"),
                             got_w, want_w))
    return dict(diff=res, bits=want_f[1], score=want_f[0], packed=want_w[0],
                n_steps=want_w[1], complete=want_w[2])


def output_diff(kernel, names, got, want) -> dict:
    """{kernel.name: (differing entries, largest absolute difference)} of
    a kernel's outputs against its plain version's (of the same shape)."""
    res = {}
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, (kernel, name, g.shape, w.shape)
        g64, w64 = g.to(torch.int64), w.to(torch.int64)
        res[f"{kernel}.{name}"] = (int((g64 != w64).sum()),
                                   int((g64 - w64).abs().max())
                                   if g.numel() else 0)
    return res


def capture_link_passes(store):
    """Context: the arguments of each bucket's first link_pack (by RMAX)
    and link_runs call (by its words a task) in store[name]."""
    from vg_tpu_torch.ops import cuda_links

    wrappers = {name: getattr(cuda_links, name) for name in store}

    def capturing(name):
        def call(*a, **kw):
            key = kw["RMAX"] if name == "link_pack" else a[0].shape[1]
            store[name].setdefault(key, (a, kw))
            return wrappers[name](*a, **kw)
        call.launches = 0              # the wrapper counts itself here
        return call

    @contextlib.contextmanager
    def ctx():
        for name in store:
            setattr(cuda_links, name, capturing(name))
        try:
            yield store
        finally:
            for name, fn in wrappers.items():
                setattr(cuda_links, name, fn)
    return ctx()



def link_mismatches(diff, kernel) -> tuple:
    """(differing entries, max abs difference) of one kernel's outputs."""
    rows = [v for k, v in diff.items() if k.startswith(kernel + ".")]
    return sum(r[0] for r in rows), max((r[1] for r in rows), default=0)


def walk_tile_bytes(la, RMAX, WB) -> int:
    """Bytes the walk's tiles read when every walk goes from row la to row
    0: rows 0..min(la, RMAX) of each task with la >= 0."""
    rows = la.to(torch.int64).clamp(-1, RMAX) + 1
    return int(rows.sum()) * WB


def phase_longread(haps, idx, card, seed, parent=None):
    """Long-read mapping at bench.py's sidecar size with each engine; the
    device engine's 496 records byte-identical to the native engine's,
    placement >= 95%, the link kernels' launches on the timed batch
    (counts reset just before it), its pack / fill / walk / runs / fetch
    and host passes' seconds, a profiled batch (kernels, idle share); then
    link_pack, link_fill, link_walk and link_runs against their plain
    versions on the card, with 0 differing entries, on both buckets'
    captured inputs and on a bucket-768 batch of LINK_BIG_N tasks (the
    fill and walk also on ops/link_cases.py), and their device times;
    with `parent` (a checkout), the parent's link_fill and link_walk
    against these on both buckets' inputs."""
    from vg_tpu_torch.map.longread import LongReadMapper, LongReadParams
    from vg_tpu_torch.ops import cuda_links, device_links, link_cases
    from vg_tpu_torch.ops import pass_cases
    from vg_tpu_torch.ops.cuda_align import pack_text

    t_phase = time.time()
    reads, starts = longread_reads(np.random.default_rng(seed + 7), haps)
    warm, timed = reads[:LR_WARM], reads[LR_WARM:]
    n_timed = len(timed)
    nat = LongReadMapper(haps, idx)
    nat.map_batch_encoded(warm)
    t0 = time.time()
    recs_n = nat.map_batch_encoded(timed)
    dt_n = time.time() - t0
    dv = LongReadMapper(haps, idx, LongReadParams(engine="device"))
    dla = dv._device_aligner()
    captured = {}
    passes_in = {"link_pack": {}, "link_runs": {}}
    engine = dla._engine

    def capture(*a, **kw):                # the warm pass's engine inputs
        captured.setdefault(a[5], a[:6])
        return engine(*a, **kw)

    dla._engine = capture
    try:
        with capture_link_passes(passes_in):
            t0 = time.time()
            dv.map_batch_encoded(timed)   # warm at the full batch
            dt_warm = time.time() - t0
    finally:
        dla._engine = engine
    dla.stats = {}
    passes = {}
    reset_launches()
    with timed_passes(passes):
        t0 = time.time()
        recs_d = dv.map_batch_encoded(timed)
        dt_d = time.time() - t0
    launches = kernel_launches()
    st, dla.stats = dla.stats, None
    assert len(recs_n) == len(recs_d) == n_timed, (len(recs_n), len(recs_d))
    n_diff = sum(1 for a, b in zip(recs_n, recs_d) if bytes(a) != bytes(b))
    frac = longread_placed(nat, recs_n, timed, starts[LR_WARM:])
    buckets = st.get("buckets", {})
    on_card = sum(b["certified"] for b in buckets.values())
    log(f"long reads: {n_timed} x {LR_LEN} bp; native engine {dt_n:.3f} s "
        f"= {n_timed / dt_n:.1f} reads/s; device engine {dt_d:.3f} s = "
        f"{n_timed / dt_d:.1f} reads/s (warm pass {dt_warm:.3f} s); "
        f"{n_diff} of {n_timed} records differ; {100 * frac:.2f}% placed "
        f"within 1000 bp on {card}")
    device_passes = ("pack", "fill", "walk", "runs", "fetch")
    log(f"long-read slow links: {st.get('tasks', 0)} tasks, {on_card} "
        f"resolved on the card, {st.get('tasks', 0) - on_card} on the host; "
        f"per bucket {json.dumps(buckets)}; link engine "
        + ", ".join(f"{k} {st.get(k, 0):.4f} s" for k in device_passes)
        + "; launches on the timed batch: " + ", ".join(
            f"{k} {launches[k]}" for k in LINK_KERNELS))
    engine_s = sum(st.get(k, 0.0) for k in device_passes)
    host = {name: box[0] for name, box in passes.items()}
    two_pass = host.pop("_device_batch")
    host["align_runs_blob"] -= engine_s      # its own host work
    inner = sum(v for k, v in host.items() if k != "native_emit_runs_gam")
    rest = two_pass - inner - engine_s
    log(f"long-read device engine, where the {dt_d:.3f} s go: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in host.items())
        + f", link engine ({' + '.join(device_passes)}) {engine_s:.4f} s; "
        f"the rest of _device_batch (task table, forward blob, fallback "
        f"slices, per-chain dicts) {rest:.4f} s; map_batch_encoded's own "
        f"Python (encoding, winners, MAPQ, refpos) "
        f"{dt_d - two_pass - host['native_emit_runs_gam']:.4f} s")
    # the profiled pass: its own launches (counts reset) and records
    reset_launches()
    recs_p = []
    events, wall = profiled(lambda: recs_p.extend(
        dv.map_batch_encoded(timed)))
    launches_p = kernel_launches()
    n_diff_p = sum(1 for a, b in zip(recs_n, recs_p) if bytes(a) != bytes(b))
    copies = sum(1 for name, _ in events
                 if "memcpy" in name.lower() or "memset" in name.lower())
    busy = sum(us for _, us in events) / 1e3
    ours = {}
    for name, us in events:
        for k in ("link_pack_kernel", "link_fill_kernel", "link_walk_kernel",
                  "link_runs_kernel"):
            if k in name:
                n, ms = ours.get(k, (0, 0.0))
                ours[k] = (n + 1, ms + us / 1e3)
    log(f"long-read device engine under the profiler: {len(events)} device "
        f"events ({len(events) - copies} kernels, {copies} copies/sets) in "
        f"{wall:.3f} s wall, device busy {busy:.2f} ms (idle "
        f"{100 - 100 * busy / (1e3 * wall):.2f}%); "
        + ", ".join(f"{k} {n}x {ms:.3f} ms" for k, (n, ms) in ours.items())
        + "; launches counted in the pass: " + ", ".join(
            f"{k} {launches_p[k]}" for k in LINK_KERNELS)
        + f"; {n_diff_p} of {len(recs_p)} records differ from the native "
        f"engine's")

    # each kernel against its plain version on the card
    sc = dv.scoring
    WB = 4 * dla.B + 1
    kw0 = dict(WB=WB, T=dla.T, match=sc.match, mismatch=sc.mismatch,
               gap_open=sc.gap_open, gap_extend=sc.gap_extend)
    diffs = {}
    timed_k = {}
    for RMAX in sorted(captured):
        args = link_args(captured[RMAX], dla.text_packed, "cuda")
        kw = dict(kw0, RMAX=RMAX)
        chk = check_links(args, kw)
        diffs[f"bucket {RMAX}"] = chk["diff"]
        N = args[0].shape[0]
        walk_in = (chk["bits"], args[1], args[3], args[4])
        fill_t = dict(timed_turns(
            lambda: cuda_links.link_fill(*args, **kw),
            lambda: cuda_links.link_fill_ref(*args, **kw), 20, 1),
            **bound(*cuda_links.fill_work(
                args[1], N, RMAX, WB, dla.text_packed.shape[0])))
        walk_t = dict(timed_turns(
            lambda: cuda_links.link_walk(*walk_in),
            lambda: cuda_links.link_walk_ref(*walk_in), 20, 1),
            **bound(*cuda_links.walk_work(chk["n_steps"], N, RMAX, WB)))
        walk_t["tile_bytes"] = walk_tile_bytes(args[1], RMAX, WB)
        for name, t in (("link_fill", fill_t), ("link_walk", walk_t)):
            t.update(shape=f"N = {N}, RMAX = {RMAX}, WB = {WB}")
            timed_k.setdefault(name, {})[RMAX] = t
            tiles = "" if "tile_bytes" not in t else \
                f"; the tiles read {t['tile_bytes']} bytes"
            log(f"{name}, bucket {RMAX} ({t['shape']}, "
                f"{int((args[1] > 0).sum())} tasks): {timing_text(t)}"
                f"{tiles} on {card}")
        del chk, walk_in, args
    # the passes around the engine, on the same batch's buckets
    for RMAX in sorted(passes_in["link_pack"]):
        a, kw = passes_in["link_pack"][RMAX]
        diffs[f"bucket {RMAX}"].update(output_diff(
            "link_pack", ("a4",), (cuda_links.link_pack(*a, **kw),),
            (cuda_links.link_pack_ref(*a, **kw),)))
        timed_k.setdefault("link_pack", {})[RMAX] = dict(
            timed_turns(lambda: cuda_links.link_pack(*a, **kw),
                        lambda: cuda_links.link_pack_ref(*a, **kw), 50, 3),
            shape=f"N = {kw['N']}, RMAX = {RMAX}, {a[2].shape[0]} tasks",
            **bound(*cuda_links.pack_work(a[2], a[1], kw["N"], RMAX)))
    for RMAX in sorted(captured):
        a = passes_in["link_runs"][cuda_links.walk_steps(RMAX, WB) // 8][0]
        got = cuda_links.link_runs(*a)
        diffs[f"bucket {RMAX}"].update(output_diff(
            "link_runs", ("runs", "counts"), got,
            cuda_links.link_runs_ref(*a)))
        m = got[0].shape[0]
        # the count pass, the scan and the write pass, without the
        # wrapper's one synchronisation (m is known)
        kern = lambda: cuda_links._write_runs(
            *a, torch.cumsum(cuda_links._count_runs(*a), 0), m)
        timed_k.setdefault("link_runs", {})[RMAX] = dict(
            timed_turns(kern, lambda: cuda_links.link_runs_ref(*a), 50, 3),
            shape=f"N = {a[0].shape[0]}, SW = {a[0].shape[1]}, "
                  f"{int(a[2].sum())} certified, {m} runs",
            **bound(*cuda_links.runs_work(a[1], a[2], m)))
        del got
    for name in ("link_pack", "link_runs"):
        for RMAX, t in sorted(timed_k[name].items()):
            log(f"{name}, bucket {RMAX} ({t['shape']}): {timing_text(t)} "
                f"on {card}")
    if parent:
        compare_parent_links(parent, captured, dla.text_packed, kw0, card)
    for name in link_cases.CASES:
        for RMAX in (256, 768):
            c = link_cases.link_case(name, RMAX=RMAX)
            tp = torch.as_tensor(pack_text(c["text"]), device="cuda")
            m, mm, go, ge = c["scoring"]
            kw = dict(RMAX=RMAX, WB=4 * c["B"] + 1, T=len(c["text"]),
                      match=m, mismatch=mm, gap_open=go, gap_extend=ge)
            diffs[f"{name} {RMAX}"] = check_links(
                link_args(c["arrays"], tp, "cuda"), kw)["diff"]
    # a bucket-768 batch past vg_tpu's int32 flat index: the real tasks
    # last, so that the highest flat indices belong to them
    text, arrs = link_cases.synthetic_links(seed, N=LINK_BIG_N, RMAX=768,
                                            B=dla.B)
    arrs = tuple(np.ascontiguousarray(x[::-1]) for x in arrs)
    big = link_args(arrs, torch.as_tensor(pack_text(text)), "cuda")
    kw = dict(kw0, RMAX=768, T=len(text))
    assert (LINK_BIG_N - 1) * 769 * WB >= 2**31, "the batch fits int32"
    chk = check_links(big, kw)
    big_diff = diffs[f"bucket 768, {LINK_BIG_N} tasks"] = chk["diff"]
    ms_big = cuda_ms(lambda: cuda_links.link_fill(*big, **kw), 3)
    bits_big = cuda_links.link_fill(*big, **kw)[1]
    ms_big_w = cuda_ms(lambda: cuda_links.link_walk(
        bits_big, big[1], big[3], big[4]), 3)
    del bits_big
    # link_runs on that batch's walk, link_pack on as many tasks
    runs_in = (chk["packed"], chk["n_steps"], device_links.certified(
        chk["score"], chk["complete"], big[1], big[4], sc, dla.B))
    del chk
    big_diff.update(output_diff("link_runs", ("runs", "counts"),
                                cuda_links.link_runs(*runs_in),
                                cuda_links.link_runs_ref(*runs_in)))
    ms_big_r = cuda_ms(lambda: cuda_links.link_runs(*runs_in), 3)
    blob, read_off, tasks = (torch.as_tensor(x, device="cuda")
                             for x in pass_cases.big_tasks(seed))
    pkw = dict(N=LINK_BIG_N, RMAX=768)
    big_diff.update(output_diff(
        "link_pack", ("a4",), (cuda_links.link_pack(blob, read_off, tasks,
                                                    **pkw),),
        (cuda_links.link_pack_ref(blob, read_off, tasks, **pkw),)))
    ms_big_p = cuda_ms(lambda: cuda_links.link_pack(blob, read_off, tasks,
                                                    **pkw), 3)
    log(f"link kernels on {LINK_BIG_N} bucket-768 tasks (flat indices to "
        f"{LINK_BIG_N * 769 * WB - 1}): link_fill {ms_big:.4f} ms, "
        f"link_walk {ms_big_w:.4f} ms, link_runs {ms_big_r:.4f} ms "
        f"({int(runs_in[2].sum())} certified), link_pack {ms_big_p:.4f} ms "
        f"(enqueue-inclusive) on {card}")
    del big, runs_in, blob, read_off, tasks
    torch.cuda.empty_cache()
    bad = {}
    for where, d in diffs.items():
        for k, (n, _) in d.items():
            if n:
                bad[f"{where}: {k}"] = n
    log(f"link kernels vs their plain versions on the card: "
        f"{len(diffs)} inputs ({', '.join(diffs)}), {sum(bad.values())} "
        f"differing entries {json.dumps(bad)}")
    log(f"long-read phase {time.time() - t_phase:.1f} s")
    assert not bad, f"link kernels differ from their plain versions: {bad}"
    assert n_diff == 0, f"{n_diff} long-read records differ between engines"
    assert frac >= 0.95, frac
    assert on_card > 0, "the device engine resolved no link on the card"
    assert set(captured) == {256, 768}, sorted(captured)
    assert set(passes_in["link_pack"]) == {256, 768}, passes_in["link_pack"]
    # link_runs' count and write passes run on a bucket with a certified
    # task
    with_cert = sum(1 for b in buckets.values() if b["certified"])
    for name in LINK_KERNELS:
        want = 2 * with_cert if name == "link_runs" else len(buckets)
        assert launches[name] == want, \
            f"{name} launched {launches[name]} times on the timed batch"
        assert launches_p[name] == want, \
            f"{name} launched {launches_p[name]} times in the profiled pass"
    assert len(recs_p) == n_timed and n_diff_p == 0, \
        f"the profiled pass: {n_diff_p} records differ"
    kernels = {}
    for name in LINK_KERNELS:
        mism = [link_mismatches(d, name) for d in diffs.values()]
        kernels[name] = dict(timed_k[name][256],
                             mismatches=sum(m[0] for m in mism),
                             max_abs_err=max(m[1] for m in mism),
                             bucket_768=timed_k[name][768])
    return dict(native_rps=n_timed / dt_n, device_rps=n_timed / dt_d,
                launches=launches, kernels=kernels)


# ------------------------------------------------- vg map, surject, call

def vgmap_reads(mapper, seed, n):
    """150 bp reads with qualities from ReadSimulator(with_quality=True),
    and each read's truth (the simulated alignment, its refpos on the
    mapper's reference paths)."""
    from vg_tpu_torch.io.fastq import Read
    from vg_tpu_torch.sim.simulator import ReadSimulator

    sim = ReadSimulator(mapper.haps, seed=seed, read_length=150,
                        with_quality=True,
                        ref_path_names=mapper.path_pos.path_names)
    truth = sim.simulate(n)
    reads = [Read(a.name, a.sequence, "".join(chr(33 + b) for b in a.quality))
             for a in truth]
    return reads, truth


def refpos_placed(recs, truth, tol=100) -> tuple:
    """(placed share, reads with a truth position): the first refpos
    within tol bp of the truth's first refpos on the same path, over the
    reads whose truth has one."""
    from vg_tpu_torch.io.gam import Alignment

    ok = n = 0
    for rec, t in zip(recs, truth):
        if not t.refpos:
            continue
        n += 1
        a = Alignment.decode(bytes(rec))
        ok += bool(a.refpos) and a.refpos[0].name == t.refpos[0].name \
            and abs(a.refpos[0].offset - t.refpos[0].offset) <= tol
    return ok / max(n, 1), n


def phase_vg_map(haps, mem, card, seed):
    """`vg map -A` (workload 1: cmd_giraffe --engine mem with qualities):
    MEMMapper(qual_adjusted=True, batch_reads=512) driven by map_batch on
    the card, 1 warmup batch, then VGMAP_BATCHES timed batches with the
    launch counts set to 0 before them. Checks: the quality entry
    launched once a batch, each on the route qual_lanes gives the batch's
    slots, >= 95% placed against the simulator's truth,
    the first timed batch's records byte-identical to a device="cpu"
    twin's. Returns the numbers (with the timed reads and their records
    as JSON, the CLI phase's reference) and the quality entry's inputs on
    the warmup batch (captured from the wrapper call)."""
    from vg_tpu_torch.map.giraffe import GiraffeParams
    from vg_tpu_torch.map.memmapper import MEMMapper
    from vg_tpu_torch.ops import cuda_align

    params = GiraffeParams(qual_adjusted=True, batch_reads=VGMAP_BATCH)
    mapper = MEMMapper(haps, mem, params)
    bs = VGMAP_BATCH
    reads, truth = vgmap_reads(mapper, seed + 11, bs * (VGMAP_BATCHES + 1))
    captured = []
    wrapper = cuda_align.banded_scores_qual_packed

    def capture(*a, **kw):
        # the wrapper counts itself under its module name: put it back
        # before it runs
        cuda_align.banded_scores_qual_packed = wrapper
        captured.append((a, kw))
        return wrapper(*a, **kw)

    t0 = time.time()
    cuda_align.banded_scores_qual_packed = capture
    try:
        warm = mapper.map_batch(reads[:bs])
    finally:
        cuda_align.banded_scores_qual_packed = wrapper
    torch.cuda.synchronize()
    assert len(captured) == 1 and len(warm) == bs, (len(captured), len(warm))
    log(f"vg map warmup: {bs} reads in {time.time() - t0:.2f} s")
    reset_launches()
    alns, recs = [], []
    t0 = time.time()
    for k in range(1, VGMAP_BATCHES + 1):
        out = mapper.map_batch(reads[k * bs : (k + 1) * bs])
        alns += out
        recs += [a.encode() for a in out]
    torch.cuda.synchronize()
    dt = time.time() - t0
    n = kernel_launches()
    routes = dict(cuda_align.banded_scores_qual_packed.routes)
    a, kw = captured[0]
    N = a[2].shape[0] * a[7].shape[1]
    G = cuda_align.qual_lanes(N, cuda_align.sm_count(torch.device("cuda")),
                              a[2].shape[1])
    frac, n_truth = refpos_placed(recs, truth[bs:])
    first = reads[bs : 2 * bs]
    events, wall = profiled(lambda: mapper.map_batch(first))
    busy = sum(us for _, us in events) / 1e3
    cpu = MEMMapper(haps, mem, params, device="cpu")
    t1 = time.time()
    cpu_recs = [a.encode() for a in cpu.map_batch(first)]
    n_diff = sum(1 for a, b in zip(recs[:bs], cpu_recs) if a != b)
    log(f"vg map (MEMMapper, qual_adjusted, batch {bs}): {len(recs)} reads "
        f"in {dt:.2f} s = {len(recs) / dt:.1f} reads/s; launches "
        f"{json.dumps(n)}, the quality entry's by lanes a slot "
        f"{json.dumps(routes)} (N = {N} slots: the rule gives G = {G}); "
        f"{100 * frac:.2f}% placed within 100 bp of the "
        f"simulator's truth ({n_truth} reads with a truth position); one "
        f"batch under the profiler: device busy {busy:.2f} ms of "
        f"{wall:.3f} s wall (idle {100 - 100 * busy / (1e3 * wall):.2f}%); "
        f"card vs CPU twin (CPU {time.time() - t1:.2f} s): {n_diff} of {bs} "
        f"records differ, on {card}")
    assert len(recs) == bs * VGMAP_BATCHES, len(recs)
    assert n["banded_dp_qual"] == VGMAP_BATCHES, n
    assert routes == {g: VGMAP_BATCHES * (g == G) for g in routes}, routes
    assert frac >= 0.95, frac
    assert len(cpu_recs) == bs and n_diff == 0, \
        f"vg map: {n_diff} records differ between the card and the CPU"
    return dict(reads_per_s=len(recs) / dt, seconds=dt, placed=frac,
                launches=n["banded_dp_qual"], lanes=G, busy_ms=busy,
                wall_s=wall,
                reads=reads[bs:], json=[a.to_json_str() for a in alns]), \
        captured[0]


def qual_case_tensors(rng, text, R, B, tabs=None):
    """dp_cases.qual_case on the fixture's text as the wrapper's
    arguments (packed text and T first, the tables last)."""
    from vg_tpu_torch.ops import cuda_align, dp_cases, qualadj

    args = dp_cases.qual_case(rng, R=R, B=B, text=text)
    tabs = qualadj.qual_tables(1, 4, 5) if tabs is None else tabs
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device="cuda")
    return ([put(cuda_align.pack_text(text)), len(text)]
            + [put(a) for a in args[1:]]
            + [put(np.asarray(t, np.int32)) for t in tabs])


def phase_qual_kernel(text, vgmap_inputs, card, parent=None):
    """The quality entry (banded_dp_qual_packed) against its plain version
    on the card, exact, on both routes: dp_cases.qual_case on the
    fixture's text at B = 8, 12 and 16 (both strands, rlen < RL and rlen 0
    on valid slots, N bases, phred 0-2 and 61-93, quality strings shorter
    than the read, windows cut by lo / hi or the text's ends, invalid
    slots) and the same at B = 16 with tables of either sign, each on the
    rule's route; for each route, G = 1 and 4 lanes a slot, qual_case and
    dp_cases.split_case's cases on a batch sized so that the rule
    (cuda_align.qual_lanes) picks it; the vg map phase's own first batch.
    Each route's launches here are counted by the wrapper and by the
    library and held to the calls made (checks, not the path's launches).
    Times and the bound on the vg map batch; with `parent` (a checkout),
    the parent's quality entry against this one on that batch."""
    from vg_tpu_torch.ops import cuda_align, dp_cases

    dev = torch.device("cuda")
    sms = cuda_align.sm_count(dev)
    wrap = cuda_align.banded_scores_qual_packed
    rng = np.random.default_rng(6)
    a, kw = vgmap_inputs
    vg, b_vg = list(a), kw["band_radius"]
    cases = [(f"qual_case R=1024 B={b}", qual_case_tensors(rng, text, 1024, b),
              b, None) for b in (8, 12, BAND)]
    cases.append((f"qual_case R=1024 B={BAND}, tables of either sign",
                  qual_case_tensors(rng, text, 1024, BAND,
                                    dp_cases.signed_tables(rng)), BAND, None))
    put = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
    for G in cuda_align.QUAL_LANES:
        R = next(R for R in (256, 2048, 8192, 32768)
                 if cuda_align.qual_lanes(R * 8, sms, 160) == G)
        cases.append((f"qual_case R={R} B={BAND} (the rule's G = {G})",
                      qual_case_tensors(rng, text, R, BAND), BAND, G))
        for name in dp_cases.SPLIT_CASES:
            args, tabs = dp_cases.split_case(name, rng, BAND, R=R)
            cases.append((f"split case {name} R={R} B={BAND} (the rule's "
                          f"G = {G})",
                          [put(cuda_align.pack_text(args[0])), len(args[0])]
                          + [put(x) for x in args[1:]]
                          + [put(np.asarray(x, np.int32)) for x in tabs],
                          BAND, G))
    cases.append(("vg map batch 0", vg, b_vg, None))
    mism, err = 0, 0
    calls = dict.fromkeys(cuda_align.QUAL_LANES, 0)
    lib0 = cuda_align.qual_launches_by_route()
    wrap0 = dict(wrap.routes)
    for label, args, b, lanes in cases:
        before = dict(wrap.routes)
        got = wrap(*args, band_radius=b)
        torch.cuda.synchronize()
        took = [G for G in calls if wrap.routes[G] != before[G]]
        assert len(took) == 1, (label, took)
        calls[took[0]] += 1
        if lanes is not None:
            assert took[0] == lanes, f"{label}: the rule took {took[0]} lanes"
        want = cuda_align.banded_scores_qual_packed_ref(*args, band_radius=b)
        bad, e = max_err((got,), (want,))
        log(f"banded_dp_qual vs plain, {label}: {tuple(got.shape)} {bad} "
            f"mismatches, max |err| {e}, {int(args[-4].sum())} valid slots, "
            f"{took[0]} lanes a slot")
        mism += bad
        err = max(err, e)
    lib = {G: n - lib0[G]
           for G, n in cuda_align.qual_launches_by_route().items()}
    by_wrap = {G: n - wrap0[G] for G, n in wrap.routes.items()}
    log(f"banded_dp_qual launches in these checks by lanes a slot: calls "
        f"{json.dumps(calls)}, wrapper {json.dumps(by_wrap)}, library "
        f"{json.dumps(lib)}")
    if mism:
        raise AssertionError(f"banded_dp_qual disagrees with its plain "
                             f"version on {mism} slots")
    assert calls == by_wrap == lib, (calls, by_wrap, lib)
    assert all(calls.values()), calls
    packed, reads, rlen, valid = vg[0], vg[2], vg[5], vg[-4]
    R, RL = reads.shape
    G = cuda_align.qual_lanes(valid.numel(), sms, RL)
    nbytes, ops = cuda_align.dp_work(reads, rlen, valid, packed.numel(), b_vg,
                                     source="qual",
                                     tab_entries=vg[-1].numel())
    res = time_entry(
        lambda: wrap(*vg, band_radius=b_vg),
        lambda: cuda_align.banded_scores_qual_packed_ref(*vg,
                                                         band_radius=b_vg),
        nbytes, ops)
    if parent:
        compare_parent_qual(parent, vg, b_vg, card)
    return dict(res, mismatches=mism, max_abs_err=err, lanes=G,
                check_launches=calls,
                shape=f"R={R} C={valid.shape[1]} RL={RL} B={b_vg}",
                valid=int(valid.sum()), slots=valid.numel())


def compare_parent_qual(root, args, b, card) -> dict:
    """The parent tree's quality entry against this tree's on the vg map
    batch: the same scores, then device and enqueue times in turns."""
    from vg_tpu_torch.ops import cuda_align

    par = load_parent(root, "cuda_align")
    t0 = time.time()
    par.library()
    log(f"parent banded_dp.cu built in {time.time() - t0:.1f} s from {root}")
    fn = lambda m: (m.banded_scores_qual_packed(*args, band_radius=b),)
    bad, _ = max_err(fn(par), fn(cuda_align))
    assert bad == 0, f"banded_dp_qual: parent and this tree differ on {bad}"
    res = {"banded_dp_qual": turns("banded_dp_qual on the vg map batch", fn,
                                   {"parent": par, "this": cuda_align}, card)}
    print(json.dumps({"compare_parent_qual": res}), flush=True)
    return res


def phase_surject(graph, recs, card):
    """Surjection (workload 3) as bench.py's sidecar runs it: the first
    SURJECT_N records of the host-seeded path's GAM, surject_batch warmed
    on 256, then timed; the records through io/bam.write_bam and read
    back equal; each mapped record's CIGAR consumes its read's bases and
    its position lies in [1, contig length]; >= 90% mapped."""
    import io

    from vg_tpu_torch.io import bam
    from vg_tpu_torch.io.gam import Alignment
    from vg_tpu_torch.io.sam import cigar_ops
    from vg_tpu_torch.surject.surjector import Surjector

    alns = [Alignment.decode(bytes(r)) for r in recs[:SURJECT_N]]
    sj = Surjector(graph)
    sj.surject_batch(alns[:256])
    t0 = time.time()
    srecs = sj.surject_batch(alns)
    dt = time.time() - t0
    buf = io.BytesIO()
    bam.write_bam(buf, sj.header(), sj.ref_lengths(), srecs)
    _, refs, back = bam.read_bam(io.BytesIO(buf.getvalue()))
    contig = dict(sj.ref_lengths())
    mapped = bad = 0
    for a, r in zip(alns, srecs):
        if r.flag & 0x4:
            continue
        mapped += 1
        used = sum(n for op, n in cigar_ops(r.cigar) if op in "MIS=X")
        bad += used != len(a.sequence) or not 1 <= r.pos <= contig[r.rname]
    log(f"surject: {len(srecs)} alignments in {dt:.3f} s = "
        f"{len(srecs) / dt:.1f} alns/s, {mapped} mapped "
        f"({100 * mapped / len(srecs):.2f}%), {bad} break the CIGAR / "
        f"position invariants; BAM {len(buf.getvalue())} bytes, read back "
        f"{len(back)} records on {card}")
    assert len(srecs) == len(alns) == SURJECT_N, (len(srecs), len(alns))
    assert [r.line() for r in back] == [r.line() for r in srecs]
    assert refs == sj.ref_lengths(), refs
    assert bad == 0, f"{bad} surjected records break the invariants"
    assert mapped >= 0.9 * len(srecs), mapped
    return dict(alns_per_s=len(srecs) / dt, seconds=dt,
                mapped=mapped / len(srecs))


def depth_reads(rng, haps, depth, L=150, err=0.002):
    """tests/test_property.py's calling reads: sample s1's two haplotypes
    at `depth` diploid depth, L bp, substitutions at `err`."""
    from vg_tpu_torch.io.fastq import Read
    from vg_tpu_torch.utils import dna

    ranges = [haps.hap_text_range(i) for i, m in enumerate(haps.metas)
              if m.sample == "s1"]
    assert ranges, [m.sample for m in haps.metas]
    n = depth * haps.graph.path_len("ref") // L // len(ranges)
    reads = []
    for t0, t1 in ranges:
        for i in range(n):
            s = int(rng.integers(t0, t1 - L))
            c = haps.text[s : s + L].copy()
            ne = rng.binomial(L, err)
            ps = rng.integers(0, L, ne)
            c[ps] = (c[ps] + 1 + rng.integers(0, 3, ne)) % 4
            reads.append(Read(f"d{t0}_{i}", dna.decode(c), ""))
    return reads


def genotype_concordance(calls, vcf) -> tuple:
    """tests/test_property.py's rule: (agreeing, compared) genotype
    classes (ref / het / hom) of the calls at the truth sites of sample
    s1 (a call's position, or one off it)."""
    truth = {rec.pos: tuple(sorted(rec.genotypes[0][0]))
             for rec in vcf.records}
    cls = lambda gt: "ref" if gt[0] == gt[1] == 0 else (
        "het" if gt[0] != gt[1] else "hom")
    ok = tot = 0
    for vc in calls:
        t = truth.get(vc.pos) or truth.get(vc.pos + 1) \
            or truth.get(vc.pos - 1)
        if t is None:
            continue
        tot += 1
        ok += cls(tuple(sorted(int(x) for x in vc.genotype))) == cls(t)
    return ok, tot


def phase_pack_call(haps, idx, mem, vcf, card, seed):
    """Pack and call (workload 5), tests/test_property.py's protocol at the
    fixture's size: s1's reads at CALL_DEPTH, mapped single-end on the
    card through the host-seeded path (launch counts set to 0 before),
    Packer.add_batch, SnarlCaller(..., "ref", sample_name="s1").call();
    genotype-class concordance >= 85% at >= 20 truth sites."""
    from vg_tpu_torch.call.caller import SnarlCaller
    from vg_tpu_torch.call.pack import Packer
    from vg_tpu_torch.io.gam import Alignment
    from vg_tpu_torch.map.giraffe import GiraffeMapper, GiraffeParams

    reads = depth_reads(np.random.default_rng(seed + 13), haps, CALL_DEPTH)
    mapper = GiraffeMapper(haps, idx, GiraffeParams(batch_reads=BATCH))
    mapper._mem_fallback_index = mem
    reset_launches()
    t0 = time.time()
    recs = [r for out in mapper.map_stream_encoded(
        iter([reads[i : i + BATCH] for i in range(0, len(reads), BATCH)]))
        for r in out]
    torch.cuda.synchronize()
    dt_map = time.time() - t0
    n = kernel_launches()
    t0 = time.time()
    alns = [Alignment.decode(bytes(r)) for r in recs]
    dt_dec = time.time() - t0
    pk = Packer(haps.graph)
    t0 = time.time()
    pk.add_batch(alns)
    dt_pack = time.time() - t0
    t0 = time.time()
    calls = SnarlCaller(haps.graph, pk, "ref", sample_name="s1").call()
    dt_call = time.time() - t0
    ok, tot = genotype_concordance(calls, vcf)
    log(f"pack + call: {len(reads)} reads of s1 at {CALL_DEPTH}x mapped in "
        f"{dt_map:.2f} s ({len(reads) / dt_map:.0f} reads/s, launches "
        f"{json.dumps(n)}), decoded in {dt_dec:.2f} s; pack {len(alns)} "
        f"alignments in {dt_pack:.3f} s = {len(alns) / dt_pack:.1f} alns/s, "
        f"mean coverage {pk.mean_coverage('ref'):.2f}; call {dt_call:.3f} s, "
        f"{len(calls)} calls, genotype classes agree at {ok} of {tot} truth "
        f"sites ({100 * ok / max(tot, 1):.2f}%) on {card}")
    assert len(recs) == len(reads), (len(recs), len(reads))
    assert n["banded_dp"] >= -(-len(reads) // BATCH), n
    assert tot >= 20, tot
    assert ok >= 0.85 * tot, (ok, tot)
    return dict(reads=len(reads), pack_alns_per_s=len(alns) / dt_pack,
                call_s=dt_call, concordance=ok / tot, sites=tot)


# ------------------------------------------------------------ command line

def cli_run(argv, stdout=None, platform=None):
    """One command of the port's command line, in-process as
    `python -m vg_tpu_torch.cli` runs it: VGTPU_PLATFORM unset (the card)
    or `platform`, the launch counts set to 0 just before it and read just
    after, its standard output to the file `stdout`. Returns (seconds,
    launches)."""
    import os

    from vg_tpu_torch.cli.main import main as cli_main

    os.environ.pop("VGTPU_PLATFORM", None)
    if platform is not None:
        os.environ["VGTPU_PLATFORM"] = platform
    reset_launches()
    t0 = time.time()
    try:
        with open(stdout or os.devnull, "w") as f, \
                contextlib.redirect_stdout(f):
            rc = cli_main(argv)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        os.environ.pop("VGTPU_PLATFORM", None)
    dt = time.time() - t0
    n = kernel_launches()
    assert rc == 0, (argv, rc)
    return dt, n


def launched(n) -> str:
    """The kernels that launched, with their counts, for the log."""
    return json.dumps({k: v for k, v in n.items() if v})


def write_fastq(path, reads):
    with open(path, "w") as f:
        for r in reads:
            f.write(f"@{r.name}\n{r.sequence}\n+\n"
                    f"{r.quality or 'I' * len(r.sequence)}\n")


def ticked_pairs_pipeline(ticks):
    """map_pairs_encoded_mt with the wall time and size of each batch it
    yields appended to `ticks` (the steady rate leaves out the first)."""
    from vg_tpu_torch.parallel import pipeline

    stream = pipeline.map_pairs_encoded_mt

    def ticked(*a, **kw):
        for out in stream(*a, **kw):
            ticks.append((time.time(), len(out)))
            yield out
    return stream, ticked


def steady_rate(ticks) -> float:
    n = sum(k for _, k in ticks[1:])
    return n / (ticks[-1][0] - ticks[0][0]) if len(ticks) > 1 else 0.0


@contextlib.contextmanager
def batch_paths(kinds):
    """Record which way each pair's batch went through the paired
    pipeline (PairedGiraffeMapper.stage_rescue's item kind: "warmup" and
    "main" on the host while the fragment model learns, "main_dev" through
    the device step after), by the pair's name. Which batches the seeder
    scores before the model is finalized depends on the threads' timing,
    so two runs on the same input may take different ways."""
    from vg_tpu_torch.map.paired import PairedGiraffeMapper

    orig = PairedGiraffeMapper.stage_rescue

    def stage_rescue(self, item, *a):
        out = orig(self, item, *a)
        for r1, _ in item[1]:
            kinds[r1.name] = out[0]
        return out
    PairedGiraffeMapper.stage_rescue = stage_rescue
    try:
        yield kinds
    finally:
        PairedGiraffeMapper.stage_rescue = orig


@contextlib.contextmanager
def timed_method(cls, name, acc):
    """Add the seconds each call of cls.name takes to acc[0] (summed over
    the threads that call it)."""
    orig = getattr(cls, name)

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return orig(*a, **kw)
        finally:
            acc[0] += time.perf_counter() - t0
    setattr(cls, name, timed)
    try:
        yield acc
    finally:
        setattr(cls, name, orig)


def json_diff(a, b) -> str:
    """The fields in which two GAM records differ, for the log."""
    from vg_tpu_torch.io.gam import Alignment

    if b is None:
        return "missing"
    ja, jb = Alignment.decode(a).to_json(), Alignment.decode(b).to_json()
    keys = sorted(k for k in set(ja) | set(jb) if ja.get(k) != jb.get(k))
    return ", ".join(f"{k} {str(ja.get(k))[:80]} vs {str(jb.get(k))[:80]}"
                     for k in keys)


def gam_name(rec: bytes) -> str:
    """A GAM record's name (Alignment field 3) without decoding the rest."""
    from vg_tpu_torch.io.wire import iter_fields

    for f, _, v in iter_fields(rec):
        if f == 3:
            return bytes(v).decode()
    return ""


@contextlib.contextmanager
def counted(obj, name, calls):
    """Count the calls of obj.name in calls[0], from any thread."""
    orig = getattr(obj, name)
    lock = threading.Lock()

    def counting(*a, **kw):
        with lock:
            calls[0] += 1
        return orig(*a, **kw)
    setattr(obj, name, counting)
    try:
        yield calls
    finally:
        setattr(obj, name, orig)


def gam_records(path):
    from vg_tpu_torch.io.gam import read_messages

    return [bytes(r) for r in read_messages(pathlib.Path(path).read_bytes())]


# ------------------------------------------------------------ MAPQ cap

# H100 SXM: 64 FP64 lanes an SM a clock (NVIDIA's data sheet: 34 TFLOP/s
# of float64 outside the tensor cores, an FMA counted as two)
F64_OPS_PER_S = 132 * 64 * 1.98e9
CAP_TOL = 1e-9            # phred: caps of the kernel against the plain's


@contextlib.contextmanager
def capture_caps(store, calls):
    """GiraffeMapper._cap_inputs (called once for each mapq_cap launch;
    None, and not counted, for a batch without qualities) counted in
    calls[0]; the first two calls of the first thread that makes one
    (both mates of one paired batch) kept in store: mapq_cap's inputs
    (codes2d, rlen, quals, qoff) as numpy arrays, the mapper's key tensor,
    k and w, and the mapper and batch for replaying the call's parts
    (cap_call_parts; phase_cli drops them after it)."""
    from vg_tpu_torch.map.giraffe import GiraffeMapper

    orig = GiraffeMapper._cap_inputs
    lock = threading.Lock()

    def capturing(self, sb):
        out = orig(self, sb)
        if out is None:
            return out
        tid = threading.get_ident()
        with lock:
            calls[0] += 1
            if len(store) < 2 and (not store or store[0]["tid"] == tid):
                store.append(dict(tid=tid, arrays=tuple(
                                      np.array(a) for a in out),
                                  keys=self._cap_keys()[0],
                                  k=self.index.k, w=self.index.w,
                                  mapper=self, sb=sb))
        return out
    GiraffeMapper._cap_inputs = capturing
    try:
        yield store
    finally:
        GiraffeMapper._cap_inputs = orig


# the cap's call in parts: begin (rescue stage), _cap_begin (inside begin;
# inline at emit for the warmup batches), its input build and upload,
# apply at emit, and the wait for the caps inside apply
CAP_PARTS = (("GiraffeMapper", "begin_mapq_caps"),
             ("GiraffeMapper", "_cap_begin"),
             ("GiraffeMapper", "_cap_inputs"),
             ("GiraffeMapper", "_cap_upload"),
             ("GiraffeMapper", "apply_mapq_caps"),
             ("PendingCaps", "fetch"))


@contextlib.contextmanager
def cap_parts(acc):
    """Wall seconds of each CAP_PARTS method in acc[name] and the calling
    thread's CPU seconds in acc[name + "_cpu"] (time.thread_time: without
    the waits for the GIL and for the card), summed over the threads;
    acc["calls"][name] the calls."""
    from vg_tpu_torch.map import giraffe

    lock = threading.Lock()
    acc.setdefault("calls", {})
    origs = []
    for cls_name, name in CAP_PARTS:
        cls = getattr(giraffe, cls_name)
        orig = getattr(cls, name)
        acc[name] = acc[name + "_cpu"] = 0.0
        acc["calls"][name] = 0

        def timed(*a, _orig=orig, _name=name, **kw):
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return _orig(*a, **kw)
            finally:
                dt, dc = time.perf_counter() - t0, time.thread_time() - c0
                with lock:
                    acc[_name] += dt
                    acc[_name + "_cpu"] += dc
                    acc["calls"][_name] += 1
        setattr(cls, name, timed)
        origs.append((cls, name, orig))
    try:
        yield acc
    finally:
        for cls, name, orig in origs:
            setattr(cls, name, orig)


def cap_parts_text(acc) -> str:
    c = acc["calls"]
    part = lambda n: f"{acc[n]:.4f} s (CPU {acc[n + '_cpu']:.4f}, {c[n]})"
    inline = c["_cap_begin"] - c["begin_mapq_caps"]
    return (f"begin {part('begin_mapq_caps')}, of it the input build "
            f"{part('_cap_inputs')} and upload {part('_cap_upload')} (these "
            f"two summed with the {inline} begun inline at emit); apply at "
            f"emit {part('apply_mapq_caps')}, of it the wait "
            f"{part('fetch')} and the {inline} inline begins "
            f"{acc['_cap_begin'] - acc['begin_mapq_caps']:.4f} s (CPU "
            f"{acc['_cap_begin_cpu'] - acc['begin_mapq_caps_cpu']:.4f})")


def cap_args(codes2d, rlen, quals, qoff, keys, dev):
    """mapq_cap's tensors on dev (keys a numpy int64 array or a tensor)."""
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return (put(codes2d), put(rlen), put(quals), put(qoff),
            keys.to(dev) if isinstance(keys, torch.Tensor) else put(keys))


def capped_mapqs(caps) -> np.ndarray:
    """(R, 61): apply_mapq_caps' rule (half to even, at least 0, below a
    finite cap) at every MAPQ 0..60."""
    m = np.arange(61)[None, :]
    c = caps[:, None]
    low = np.isfinite(c) & (c < m)
    return np.where(low, np.maximum(np.rint(np.where(low, c, 0)), 0), m)


def check_cap(args, k, w) -> dict:
    """mapq_cap on the card against its plain version on the card, on
    the same inputs: MAPQs that differ at any MAPQ 0..60, the largest cap
    difference, caps not bit-identical, reads whose NaN or +inf differ."""
    from vg_tpu_torch.ops import cuda_mapqcap

    got = cuda_mapqcap.mapq_cap(*args, k=k, w=w).cpu().numpy()
    want = cuda_mapqcap.mapq_cap_ref(*args, k=k, w=w).cpu().numpy()
    nan, fin = np.isnan(want), np.isfinite(want)
    kinds = int(((np.isnan(got) != nan)
                 | (np.isposinf(got) != np.isposinf(want))).sum())
    same = ~nan & ~np.isnan(got)
    diff = np.abs(got[fin] - want[fin])
    return dict(reads=len(want), finite=int(fin.sum()), kinds=kinds,
                mapqs=int((capped_mapqs(got[same])
                           != capped_mapqs(want[same])).sum()),
                max_diff=float(np.nan_to_num(diff, nan=np.inf).max(
                    initial=0.0)),
                not_bitwise=int((got[fin] != want[fin]).sum()))


def cap_bound(nbytes, int_ops, f64_ops) -> dict:
    """The least time of a mapq_cap call: its bytes over the HBM rate,
    or its operations over the issue rate (each takes an issue slot) and
    its float64 operations over the FP64 lanes' rate, whichever is
    longest."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = max((int_ops + f64_ops) / INT32_OPS_PER_S, f64_ops / F64_OPS_PER_S)
    return dict(bound_ms=max(t_b, t_o) * 1e3,
                bound_by="operations" if t_o >= t_b else "bytes",
                bytes=nbytes, ops=int_ops + f64_ops, f64_ops=f64_ops)


def host_ms(fn, reps=5) -> list:
    """Host milliseconds of fn (it ends in a sync where it uses the card),
    each of reps runs after a warm one."""
    fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def cap_call_parts(cap) -> dict:
    """The cap's call replayed on a captured batch, in parts, host ms each:
    the input build (_cap_inputs), the upload (_cap_upload through the
    pinned staging buffer, to the end of its copy), begin_mapq_caps to the
    end of the kernel and the caps' copy home, and begin_mapq_caps then
    apply_mapq_caps (build, upload, kernel, wait, fetch)."""
    m, sb = cap["mapper"], cap["sb"]
    _, stream = m._cap_keys()

    def upload():
        inputs = m._cap_inputs(sb)
        with torch.cuda.stream(stream):
            m._cap_upload(stream, *inputs)
        stream.synchronize()

    def begin():
        m.begin_mapq_caps(sb)
        sb.caps_pending.event.synchronize()
        sb.caps_pending = None

    mq = np.full(len(sb.reads), 60)

    def whole():
        m.begin_mapq_caps(sb)
        m.apply_mapq_caps(sb, mq.copy())

    out = dict(build_ms=host_ms(lambda: m._cap_inputs(sb)),
               build_upload_ms=host_ms(upload), begin_ms=host_ms(begin),
               begin_apply_ms=host_ms(whole))
    return {x: min(v) for x, v in out.items()} | dict(runs=out)


def phase_cap_kernel(captured, call_parts, card, parent=None) -> dict:
    """The MAPQ cap kernel against its plain version on the card: every
    ops/cap_cases.py case (reads of up to 10,000 bases among them, past
    the kernel's shared-memory rows), 2,000 seeded reads, both mates of
    the CLI's captured batch (caps bit-equal, 0 differing MAPQs); then
    the kernel timed on the captured mate 1 beside its plain version and
    its bound (cap_work), and its phases apart (stopped after (a), after
    (b): cuda_mapqcap.stopped_library); logged beside the call's parts
    (call_parts, cap_call_parts' replay). With `parent`, the parent
    tree's kernel (the padded phred form) on the same mate: the same
    caps, bit for bit, then times in turns."""
    from vg_tpu_torch.ops import cap_cases, cuda_mapqcap

    t0 = time.time()
    runs = [(name, cap_cases.case(name)) for name in cap_cases.CASES]
    runs.append(("random 2000", cap_cases.random_case(0, 2000)))
    worst, n_checks = dict(mapqs=0, max_diff=0.0, not_bitwise=0), 0
    dev = torch.device("cuda")
    inputs = []
    for name, c in runs:
        p = cap_cases.ragged(c)
        inputs.append((name, cap_args(p["codes2d"], p["rlen"], p["quals"],
                                      p["qoff"], p["keys"], dev),
                       c["k"], c["w"]))
    for i, cap in enumerate(captured):
        inputs.append((f"cli batch mate {i + 1}",
                       cap_args(*cap["arrays"], cap["keys"], dev),
                       cap["k"], cap["w"]))
    for name, args, k, w in inputs:
        d = check_cap(args, k, w)
        n_checks += 1
        log(f"mapq_cap vs plain on {name}: {json.dumps(d)}")
        assert d["kinds"] == 0 and d["mapqs"] == 0, (name, d)
        assert d["not_bitwise"] == 0, (name, d)
        worst = {x: max(worst[x], d[x]) for x in worst}
    assert len(captured) == 2, len(captured)
    _, args, k, w = inputs[-2]                 # the CLI batch's mate 1
    nbytes, int_ops, f64 = cuda_mapqcap.cap_work(*args, k=k, w=w)
    run_k = lambda: cuda_mapqcap.mapq_cap(*args, k=k, w=w)
    run_p = lambda: cuda_mapqcap.mapq_cap_ref(*args, k=k, w=w)
    res = dict(timed_turns(run_k, run_p, 20, 1),
               **cap_bound(nbytes, int_ops, f64),
               mismatches=worst["mapqs"], max_abs_err=worst["max_diff"],
               not_bitwise=worst["not_bitwise"], checks=n_checks,
               shape=f"R={args[0].shape[0]} L={args[0].shape[1]} "
                     f"Q={args[2].shape[0]} keys={args[4].shape[0]}")
    log(f"mapq_cap at {res['shape']}, the CLI batch's mate 1: "
        f"{timing_text(res)}, {f64:.3e} of the ops float64; {n_checks} "
        f"checks, worst {json.dumps(worst)} on {card}")
    # the phases apart: every read stopped after (a), after (b), or not
    lib = {1: cuda_mapqcap.stopped_library(1),
           2: cuda_mapqcap.stopped_library(2), 3: cuda_mapqcap.library()}
    split = {1: [], 2: [], 3: []}
    for stop in (1, 2, 3, 3, 2, 1):
        split[stop].append(device_ms(lambda: cuda_mapqcap.run_kernel(
            lib[stop], *args, k=k, w=w), 20)[0])
    t1, t2, t3 = (min(split[p]) for p in (1, 2, 3))
    res["phase_ms"] = dict(a=t1, b=t2 - t1, c=t3 - t2, runs=split)
    log(f"mapq_cap's phases on the CLI batch's mate 1 (device ms, stopped "
        f"after (a), after (b), whole; runs {json.dumps(split)}): (a) "
        f"minimizers {t1:.4f}, (b) filter and sort {t2 - t1:.4f}, (c) "
        f"sweep {t3 - t2:.4f} on {card}")
    res["call_parts"] = call_parts
    log(f"mapq_cap's call on the CLI batch's mate 1, in parts: input build "
        f"{call_parts['build_ms']:.3f} ms, with the upload "
        f"{call_parts['build_upload_ms']:.3f}, begin to the caps at home "
        f"{call_parts['begin_ms']:.3f}, begin and apply "
        f"{call_parts['begin_apply_ms']:.3f} (host ms, the least of 5, "
        f"replayed after the CLI run); the kernel {res['ms']:.4f} ms device "
        f"time (the waits at emit in the CLI run: its giraffe -2 line) on "
        f"{card}")
    if parent:
        res["compare_parent"] = compare_parent_cap(parent, args, k, w, card)
    log(f"mapq_cap phase {time.time() - t0:.1f} s on {card}")
    return res


def compare_parent_cap(root, args, k, w, card) -> dict:
    """The parent tree's mapq_cap (its first form: the qualities as padded
    phred) against this tree's on the CLI batch's mate 1: caps bit-equal
    (NaN and inf where the other has them), then device and enqueue
    times in turns."""
    from vg_tpu_torch.ops import cap_cases, cuda_mapqcap

    par = load_parent(root, "cuda_mapqcap")
    t0 = time.time()
    par.library()
    log(f"parent mapq_cap.cu built in {time.time() - t0:.1f} s from {root}")
    for line in par.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  parent ptxas: " + line.strip())
    quals2d, qlen = cap_cases.padded_quals(args[2].cpu().numpy(),
                                           args[3].cpu().numpy())
    pargs = (args[0], args[1], torch.as_tensor(quals2d, device="cuda"),
             torch.as_tensor(qlen, device="cuda"), args[4])
    got = cuda_mapqcap.mapq_cap(*args, k=k, w=w).cpu().numpy()
    want = par.mapq_cap(*pargs, k=k, w=w).cpu().numpy()
    same = np.array_equal(got, want, equal_nan=True)
    log(f"mapq_cap, parent vs this tree on the CLI batch's mate 1: caps "
        f"bit-equal {same} ({int((got != want).sum())} entries differ "
        f"as numbers, NaN {int(np.isnan(got).sum())} / "
        f"{int(np.isnan(want).sum())})")
    assert same, "parent and this tree's mapq_cap differ"
    mods = {"parent": (par, pargs), "this": (cuda_mapqcap, args)}
    fn = lambda m: m[0].mapq_cap(*m[1], k=k, w=w)
    res = dict(turns(f"mapq_cap on the CLI batch's mate 1 (R = "
                     f"{args[0].shape[0]}, L = {args[0].shape[1]})", fn,
                     mods, card))
    print(json.dumps({"compare_parent_cap": res}), flush=True)
    return res


def phase_cli(haps, idx, pairs, truth, vgmap, card, seed, bs=BATCH,
              device="cuda"):
    """The port's command line, `python -m vg_tpu_torch.cli`, driven
    in-process on the fixture's bundle (written with io.native into a
    temporary directory) and reads written as FASTQ, each command with the
    launch counts set to 0 before it and read after it:

    1. giraffe -2 on the paired path's pairs, batch `bs`: the GAM equal,
       read by read, to map_pairs_encoded_mt on a fresh PairedGiraffeMapper
       with the same parsed pairs and batches wherever a read's batch
       went the same way through the pipeline in both runs (batch_paths),
       >= 95% placed, banded_dp launched at least twice a batch, the
       MAPQ cap (mapq_cap) once for each apply_mapq_caps call and so for
       each mate of each batch, map/mapqcap.explored_cap never; reads/s
       overall and steady beside the library path's, with the FASTQ parse
       and the one-time setup (bundle load, MEM fallback index) timed
       apart; the inputs of one batch's two cap calls kept for
       phase_cap_kernel;
    2. map -A -o json on the `vg map` phase's timed reads: the quality
       entry launched once a batch, the records equal to that phase's
       MEMMapper(qual_adjusted=True) records;
    3. mpmap on 1,024 of those reads, mpmap -2 on 1,024 pairs with
       qualities (quality entry), mpmap -A (packed DP, no quality entry):
       one GAMP record a read; the first 64 reads' records equal to a
       VGTPU_PLATFORM=cpu run on them;
    4. surject -b (BAM equal to Surjector's on the first records), pack,
       call, sim + giraffe -G + gamcompare, mapeval -n 2000.
    With device="cpu" every command runs with VGTPU_PLATFORM=cpu and no
    launch is asserted (a rehearsal of the phase on a machine without a
    card)."""
    import io
    import json as _json
    import tempfile

    from vg_tpu_torch.cli.main import _load_bundle
    from vg_tpu_torch.io import bam, native
    from vg_tpu_torch.io.fastq import Read, iter_fastq_paired
    from vg_tpu_torch.io.gam import Alignment
    from vg_tpu_torch.io.gamp import read_gamp
    from vg_tpu_torch.map import mapqcap
    from vg_tpu_torch.map.giraffe import GiraffeMapper, GiraffeParams
    from vg_tpu_torch.map.memmapper import MEMIndex
    from vg_tpu_torch.map.paired import PairedGiraffeMapper
    from vg_tpu_torch.parallel import pipeline
    from vg_tpu_torch.surject.surjector import Surjector

    on_card = device == "cuda"
    plat = None if on_card else "cpu"
    t_phase = time.time()
    tmp = tempfile.TemporaryDirectory(prefix="vgtpu_cli_")
    d = pathlib.Path(tmp.name)
    x = str(d / "x")
    native.save_graph(x + ".vgz.npz", haps.graph)
    native.save_haplotypes(x + ".hpt.npz", haps)
    native.save_minimizer(x + ".min.npz", idx)
    rng = np.random.default_rng(seed + 17)

    # 1. paired giraffe: the CLI, then the library path on the same input
    fq1, fq2 = str(d / "r1.fq"), str(d / "r2.fq")
    write_fastq(fq1, [a for a, _ in pairs])
    write_fastq(fq2, [b for _, b in pairs])
    t0 = time.time()
    parsed = list(iter_fastq_paired(fq1, fq2))
    t_parse = time.time() - t0
    ticks, kinds_cli, cap_cli = [], {}, {}
    captured, cap_calls, explored = [], [0], [0]
    stream, ticked = ticked_pairs_pipeline(ticks)
    pipeline.map_pairs_encoded_mt = ticked
    try:
        with batch_paths(kinds_cli), \
                cap_parts(cap_cli), \
                capture_caps(captured, cap_calls), \
                counted(mapqcap, "explored_cap", explored):
            dt, n = cli_run(["giraffe", "-Z", x, "-f", fq1, "-2", fq2,
                             "-B", str(bs), "--output",
                             str(d / "cli.gam")], platform=plat)
    finally:
        pipeline.map_pairs_encoded_mt = stream
    # the cap's call replayed on mate 1 while the CLI's mapper is alive;
    # after it the captured mates keep only the kernel's inputs
    call_parts = cap_call_parts(captured[0]) if on_card else None
    for cap in captured:
        del cap["mapper"], cap["sb"]
    n_batches = -(-len(pairs) // bs)
    cli_steady = steady_rate(ticks)
    recs = gam_records(d / "cli.gam")
    t0 = time.time()
    _load_bundle(x)
    t_load = time.time() - t0
    t0 = time.time()
    MEMIndex(haps, max_mem_hits=max(64, 4 * haps.count))    # as giraffe's
    t_mem = time.time() - t0
    lib = PairedGiraffeMapper(GiraffeMapper(
        haps, idx, GiraffeParams(batch_reads=bs), device=device))
    ticks_lib, kinds_lib, want, cap_lib = [], {}, [], {}
    lib_calls = [0]
    n_lib0 = kernel_launches()
    t0 = time.time()
    with batch_paths(kinds_lib), \
            cap_parts(cap_lib), \
            capture_caps([], lib_calls), \
            counted(mapqcap, "explored_cap", explored):
        for out in stream(lib, (parsed[i : i + bs]
                                for i in range(0, len(parsed), bs))):
            want += [bytes(r) for r in out]
            ticks_lib.append((time.time(), len(out)))
    dt_lib = time.time() - t0
    lib_launches = kernel_launches()["mapq_cap"] - n_lib0["mapq_cap"]
    # records by name: pairs held back while the fragment model learns
    # come out after the stream, in the CLI and the library alike.
    # Placement on every PLACE_EVERY-th record (Python decoding of all
    # 110,592 would add about 12 s to the phase)
    got, sample = {}, []
    for k, r in enumerate(recs):
        name = gam_name(r)
        mate = int((name, 0) in got)
        got[name, mate] = r
        if k % PLACE_EVERY == 0:
            sample.append((Alignment.decode(r), truth[int(name[1:]), mate]))
    frac = placed_alns(lib.mapper, [a for a, _ in sample],
                       np.array([t for _, t in sample], np.int64))
    lib_by = {}
    for r in want:
        name = gam_name(r)
        lib_by[name, int((name, 0) in lib_by)] = r
    diff = sorted(k for k in got if got[k] != lib_by.get(k))
    same_path = [k for k in diff if kinds_cli[k[0]] == kinds_lib[k[0]]]
    path_seq = lambda kinds: [kinds[p.name] for p, _ in parsed[::bs]]
    log(f"cli giraffe -2 (batch {bs}, FASTQ with base qualities): "
        f"{len(recs)} records in {dt:.2f} s = {len(recs) / dt:.0f} reads/s "
        f"overall, {cli_steady:.0f} steady; FASTQ parse of both files "
        f"alone {t_parse:.2f} s; one-time setup alone: bundle load "
        f"{t_load:.2f} s, MEM fallback index {t_mem:.2f} s; library path "
        f"(map_pairs_encoded_mt, fresh mapper, the parsed pairs) "
        f"{len(want) / dt_lib:.0f} reads/s overall, "
        f"{steady_rate(ticks_lib):.0f} steady; the explored-minimizer MAPQ "
        f"cap (one mapq_cap call a mate, reads with qualities), summed "
        f"over the threads: CLI run {cap_calls[0]} calls, "
        f"{cap_parts_text(cap_cli)}; library run {lib_calls[0]} calls "
        f"({lib_launches} launches), {cap_parts_text(cap_lib)}; the Python "
        f"explored_cap "
        f"called {explored[0]} times; library stage seconds "
        f"{json.dumps(lib.stage_seconds)}; {100 * frac:.2f}% of "
        f"{len(sample)} records (every {PLACE_EVERY}th) within 100 bp of "
        f"truth; launches {launched(n)}, on {card}")
    log(f"cli giraffe -2 vs the library path: {len(diff)} of {len(recs)} "
        f"records differ, {len(same_path)} of them in batches both runs "
        f"took the same way (batch paths, CLI {path_seq(kinds_cli)}, "
        f"library {path_seq(kinds_lib)})"
        + "".join(f"; {k[0]} mate {k[1] + 1}: "
                  f"{json_diff(got[k], lib_by.get(k))}" for k in diff[:3]))
    assert len(recs) == len(want) == 2 * len(pairs), (len(recs), len(want))
    assert len(got) == len(lib_by) == len(recs)
    assert not same_path, "cli giraffe -2 differs from the library path"
    assert frac >= 0.95, frac
    assert explored[0] == 0, "the Python explored_cap ran"
    # every mate of every batch has qualities: one cap launch each
    assert cap_calls[0] == 2 * n_batches, (cap_calls, n_batches)
    assert lib_calls[0] == 2 * n_batches, (lib_calls, n_batches)
    if on_card:
        assert n["banded_dp"] >= 2 * (len(pairs) // bs - 1), n
        assert n["mapq_cap"] == cap_calls[0], (n, cap_calls)
        assert lib_launches == lib_calls[0], (lib_launches, lib_calls)
    cap_launches = n["mapq_cap"]
    del lib, want, parsed, lib_by, got

    # 2. map -A: the vg map phase's reads, quality-adjusted (JSON out: the
    # GAM stream of `map` scores through score_reads_packed, which has no
    # quality entry in vg_tpu either)
    qreads = vgmap["reads"]
    qfq = str(d / "q.fq")
    write_fastq(qfq, qreads)
    dt, n = cli_run(["map", "-A", "-Z", x, "-f", qfq, "-o", "json"],
                    stdout=str(d / "map.json"), platform=plat)
    lines = (d / "map.json").read_text().splitlines()
    n_diff = sum(1 for a, b in zip(lines, vgmap["json"]) if a != b)
    log(f"cli map -A: {len(lines)} reads in {dt:.2f} s = "
        f"{len(lines) / dt:.1f} reads/s (the SA built in the run), launches "
        f"{launched(n)}; {n_diff} of {len(lines)} records differ from "
        f"MEMMapper(qual_adjusted=True) in batches of {VGMAP_BATCH}, on "
        f"{card}")
    assert len(lines) == len(vgmap["json"]) == len(qreads), len(lines)
    assert n_diff == 0, "cli map -A differs from MEMMapper"
    if on_card:
        assert n["banded_dp_qual"] >= len(qreads) // VGMAP_BATCH, n

    # 3. mpmap: single-end, paired, -A; the card against the CPU
    n_mp = 1024
    q1k = str(d / "q1k.fq")
    write_fastq(q1k, qreads[:n_mp])
    q64 = str(d / "q64.fq")
    write_fastq(q64, qreads[:64])
    qual = lambda: "".join(chr(33 + int(q))
                           for q in rng.integers(2, 41, 150))
    pq = [(Read(a.name, a.sequence, qual()), Read(b.name, b.sequence, qual()))
          for a, b in pairs[:n_mp]]
    p1, p2 = str(d / "pq1.fq"), str(d / "pq2.fq")
    write_fastq(p1, [a for a, _ in pq])
    write_fastq(p2, [b for _, b in pq])
    runs = {}
    for label, argv, n_want in (
            ("mpmap", ["-f", q1k], n_mp),
            ("mpmap -2", ["-f", p1, "-2", p2], 2 * n_mp),
            ("mpmap -A", ["-f", q1k, "-A"], n_mp)):
        out = str(d / (label.replace(" ", "") + ".gamp"))
        dt, n = cli_run(["mpmap", "-Z", x, *argv, "--output", out],
                        platform=plat)
        mps = [mp.encode() for mp in read_gamp(out)]
        log(f"cli {label}: {len(mps)} multipath records in {dt:.2f} s = "
            f"{n_want / dt:.1f} reads/s, launches {launched(n)}, on "
            f"{card}")
        assert len(mps) == n_want, (label, len(mps))
        if on_card:
            if label == "mpmap -A":
                assert n["banded_dp"] > 0 and n["banded_dp_qual"] == 0, n
            else:
                assert n["banded_dp_qual"] > 0, n
        runs[label] = mps
    dt, _ = cli_run(["mpmap", "-Z", x, "-f", q64, "--output",
                     str(d / "cpu.gamp")], platform="cpu")
    cpu = [mp.encode() for mp in read_gamp(str(d / "cpu.gamp"))]
    n_diff = sum(1 for a, b in zip(runs["mpmap"][:64], cpu) if a != b)
    log(f"cli mpmap, card vs VGTPU_PLATFORM=cpu on the first 64 reads "
        f"(CPU {dt:.2f} s): {n_diff} of {len(cpu)} records differ")
    assert len(cpu) == 64 and n_diff == 0, "mpmap: card and CPU differ"

    # 4. the tools on the files above
    gam = str(d / "cli.gam")
    dt, _ = cli_run(["surject", "-Z", x, "-i", gam, "-b",
                     str(d / "cli.bam")], platform=plat)
    _, refs, back = bam.read_bam(str(d / "cli.bam"))
    head = [Alignment.decode(r) for r in recs[:SURJECT_N]]
    sj = Surjector(haps.graph)
    mine = sj.surject_batch(head)
    buf = io.BytesIO()
    bam.write_bam(buf, sj.header(), sj.ref_lengths(), mine)
    _, _, mine_back = bam.read_bam(io.BytesIO(buf.getvalue()))
    n_diff = sum(1 for a, b in zip(back, mine_back) if a.line() != b.line())
    mapped = sum(1 for r in back if not r.flag & 0x4)
    log(f"cli surject -b: {len(back)} records in {dt:.2f} s = "
        f"{len(back) / dt:.1f} alns/s, {100 * mapped / len(back):.2f}% "
        f"mapped; against Surjector on the first {len(mine)}: {n_diff} "
        f"records differ, on {card}")
    assert len(back) == len(recs) and refs == sj.ref_lengths()
    assert n_diff == 0, "cli surject differs from Surjector"
    assert mapped >= 0.9 * len(back), mapped
    dt_pack, _ = cli_run(["pack", "-Z", x, "-g", gam, "-o",
                          str(d / "cli.pack.npz")], platform=plat)
    dt_call, _ = cli_run(["call", "-Z", x, "-k", str(d / "cli.pack.npz"),
                          "-s", "s1"], stdout=str(d / "cli.vcf"),
                         platform=plat)
    body = [ln for ln in (d / "cli.vcf").read_text().splitlines()
            if ln and not ln.startswith("#")]
    log(f"cli pack: {len(recs)} alignments in {dt_pack:.2f} s = "
        f"{len(recs) / dt_pack:.1f} alns/s; call {dt_call:.2f} s, "
        f"{len(body)} VCF records, on {card}")
    assert body, "cli call wrote no variant"
    sim = str(d / "sim.gam")
    cli_run(["sim", "-Z", x, "-n", "2000", "-l", "150", "-e", "0.01", "-s",
             str(seed), "-a", "--output", sim], platform=plat)
    dt, n = cli_run(["giraffe", "-Z", x, "-G", sim, "--output",
                     str(d / "sim_mapped.gam")], platform=plat)
    cli_run(["gamcompare", str(d / "sim_mapped.gam"), sim],
            stdout=str(d / "cmp.json"), platform=plat)
    cmp = _json.loads((d / "cmp.json").read_text().splitlines()[-1])
    dt_me, n_me = cli_run(["mapeval", "-Z", x, "-n", "2000"],
                          stdout=str(d / "mapeval.json"), platform=plat)
    me = _json.loads((d / "mapeval.json").read_text().splitlines()[-1])
    log(f"cli sim + giraffe -G + gamcompare: 2000 reads mapped in "
        f"{dt:.2f} s (launches {launched(n)}), accuracy "
        f"{cmp['accuracy']}; cli mapeval -n 2000: accuracy "
        f"{me['accuracy']}, {me['wrong_mapq60']} wrong at MAPQ 60, "
        f"{dt_me:.2f} s (launches {launched(n_me)}), on {card}")
    assert cmp["total"] == 2000 and cmp["accuracy"] >= 0.9, cmp
    assert me["total"] == 2000 and me["accuracy"] >= 0.9, me
    tmp.cleanup()
    log(f"cli phase {time.time() - t_phase:.1f} s on {card}")
    return dict(cap_launches=cap_launches, captured=captured,
                call_parts=call_parts)


# the kernels the device-seeded path launches (banded_dp_bytes lies on the
# sharded steps' path; banded_dp_windows on none: vg_tpu runs it only in
# benchmarks)
SEEDED_PATH_KERNELS = ["banded_dp", "softcap_compact", "cluster_topc",
                       "argsort_i32"]
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "banded_dp": ("vg_tpu_torch/csrc/banded_dp.cu",
                  "vg_tpu/ops/pallas_align.py:47"),
    "banded_dp_bytes": ("vg_tpu_torch/csrc/banded_dp.cu",
                        "vg_tpu/ops/pallas_align.py:205"),
    "banded_dp_windows": ("vg_tpu_torch/csrc/banded_dp.cu",
                          "vg_tpu/ops/pallas_align.py:148"),
    "softcap_compact": ("vg_tpu_torch/csrc/seed_kernels.cu",
                        "vg_tpu/ops/pallas_seed.py:195"),
    "cluster_topc": ("vg_tpu_torch/csrc/seed_kernels.cu",
                     "vg_tpu/ops/pallas_seed.py:275"),
    "argsort_i32": ("vg_tpu_torch/csrc/seed_kernels.cu",
                    "vg_tpu/ops/pallas_seed.py:398"),
    "banded_dp_qual": ("vg_tpu_torch/csrc/banded_dp.cu",
                       "vg_tpu/ops/align.py:164 banded_scores_qual "
                       "(XLA scan, no Pallas kernel)"),
    "link_fill": ("vg_tpu_torch/csrc/link_engine.cu",
                  "vg_tpu/ops/device_links.py:110-166 the link engine's "
                  "fill (lax.scan over rows, XLA; no Pallas kernel)"),
    "link_walk": ("vg_tpu_torch/csrc/link_engine.cu",
                  "vg_tpu/ops/device_links.py:186-221 the link engine's "
                  "walk (lax.scan over steps, XLA; no Pallas kernel)"),
    "link_pack": ("vg_tpu_torch/csrc/link_engine.cu",
                  "vg_tpu/ops/device_links.py:300-307 and "
                  "vg_tpu/map/longread.py:656-676 the oriented slices "
                  "packed into a4 (numpy on the host; no Pallas kernel)"),
    "link_runs": ("vg_tpu_torch/csrc/link_engine.cu",
                  "vg_tpu/ops/device_links.py:333-377 the step codes "
                  "turned into runs (numpy on the host; no Pallas kernel)"),
    "mapq_cap": ("vg_tpu_torch/csrc/mapq_cap.cu",
                 "vg_tpu/map/mapqcap.py:94-171 explored_cap and faster_cap, "
                 "the explored-minimizer MAPQ cap (Python on the host, a "
                 "read at a time; no Pallas kernel)"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref-mbp", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--profile", action="store_true",
                    help="trace one more pass of each paired stream")
    ap.add_argument("--compare-parent", metavar="DIR",
                    help="time another checkout's kernels against this "
                         "tree's on the main path's inputs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    t_start = time.time()
    card = phase_environment()
    phase_build()
    phase_int_pipes(card)
    bs = BATCH
    haps, idx, mem, vcf, pairs, truth = build_fixture(
        args.seed, args.ref_mbp, bs * (N_BATCHES + 1))

    # the main path's own kernel inputs (its first streamed batch)
    from vg_tpu_torch.map.giraffe import GiraffeMapper, GiraffeParams

    probe = GiraffeMapper(haps, idx, GiraffeParams(batch_reads=bs))
    probe._mem_fallback_index = mem
    real, mates = [], []
    for mate in (0, 1):
        pr = probe.prepare_batch([p[mate] for p in pairs[bs : 2 * bs]],
                                 want_packed2=False)
        mates.append(pr)
        real.append(tuple(pr[k] for k in (
            "reads_arr", "reads_rc_arr", "rlens", "cand_start", "cand_lo",
            "cand_hi", "cand_rev", "cand_valid")))
    kern = phase_kernel(haps.text, real)
    for name, k in kern["timed"].items():
        log(f"banded_dp at {k['shape']}, {name} ({k['valid']} valid "
            f"slots of {k['slots']}, {100 * k['valid'] / k['slots']:.2f}%): "
            f"{timing_text(k)} on {card}")
    seedk, seed_inputs = phase_seed_kernels(
        probe, [p[0] for p in pairs[bs : 2 * bs]])
    for name, k in seedk.items():
        log(f"{name} at {k['shape']}, main path batch 0: {timing_text(k)} "
            f"on {card}")
    if args.compare_parent:
        phase_compare_parent(args.compare_parent, seed_inputs,
                             kern["main_inputs"], probe.params.score_fraction,
                             probe.params.band_radius,
                             probe.params.max_candidates, card)
    del probe, seed_inputs
    main_k = kern["timed"]["main path batch 0"]
    del kern["main_inputs"]
    entries = phase_dp_entries(haps.text, real)
    step_launches, replicated = phase_byte_step(haps, mates)
    entries["banded_dp_bytes"]["check_launches"] += step_launches
    for name, k in entries.items():
        log(f"{name} at {k['shape']}, main path batch 0: {timing_text(k)}, "
            f"{k['check_launches']} launches in its checks on {card}")

    # the sharded steps (parallel/mesh.py's multi-device half) on that batch
    sharded_launches = phase_sharded(haps, idx, mem, pairs[bs : 2 * bs],
                                     mates, replicated, card)
    del replicated, mates

    # host-seeded main path, then single-end and the card-vs-CPU step
    from vg_tpu_torch.ops import cuda_align

    routes0 = cuda_align.launches_by_route()
    pm, host_recs, res = phase_main_path(haps, idx, mem, pairs, truth, bs,
                                         N_BATCHES)
    log_path("main path, host seeding", res, card)
    routes = {b: n - routes0[b]
              for b, n in cuda_align.launches_by_route().items()}
    log(f"banded_dp routes on the host-seeded path: {json.dumps(routes)}")
    assert routes == {16: res["launches"]["banded_dp"], 32: 0}, routes
    assert res["launches"]["banded_dp"] > 0, \
        "the main path never launched the kernel"
    assert res["stream_launches"]["banded_dp"] >= 2 * N_BATCHES
    assert res["placed"] >= 0.95, res["placed"]
    phase_single_end(pm, pairs[bs:], bs, ["banded_dp"])
    phase_reference(haps, idx, pm, pairs[bs : bs + 1024])

    # device-seeded path, then single-end and the card-vs-CPU seeded step
    spm, seeded_recs, sres = phase_main_path(
        haps, idx, mem, pairs, truth, bs, N_BATCHES, device_seed=True)
    log_path("device-seeded path", sres, card)
    log(f"cluster_topc block path on the seeded stream: "
        f"{sres['block_rows']} rows over "
        f"{sres['stream_launches']['cluster_topc']} calls")
    for name in SEEDED_PATH_KERNELS:
        n = sres["stream_launches"][name]
        assert n >= 2 * N_BATCHES, f"{name} launched {n} times while the " \
            f"seeded path streamed {N_BATCHES} batches"
    assert sres["placed"] >= 0.95, sres["placed"]
    n_diff = sum(1 for a, b in zip(host_recs, seeded_recs)
                 if bytes(a) != bytes(b))
    log(f"device-seeded vs host-seeded records on the same pairs: {n_diff} "
        f"of {len(host_recs)} differ (the host path re-seeds reads without "
        f"candidates from the MEM index; device seeding does not)")
    phase_score_split(pm, spm, pairs[bs : 2 * bs])
    phase_single_end(spm, pairs[bs:], bs, SEEDED_PATH_KERNELS)
    phase_reference_seeded(haps, idx, spm, pairs[bs : bs + 1024])
    if args.profile:
        phase_profile(pm, pairs, bs, N_BATCHES, "host seeding")
        phase_profile(spm, pairs, bs, N_BATCHES, "device seeding")
    surject_recs = host_recs[:SURJECT_N]
    del pm, spm, host_recs, seeded_recs

    # long-read mapping, both engines, and the link engine's kernels
    lr = phase_longread(haps, idx, card, args.seed, args.compare_parent)

    # vg map with qualities and its DP entry; surject; pack and call
    vgmap, vgmap_inputs = phase_vg_map(haps, mem, card, args.seed)
    qual = phase_qual_kernel(haps.text, vgmap_inputs, card,
                             args.compare_parent)
    log(f"banded_dp_qual at {qual['shape']}, vg map batch 0 "
        f"({qual['valid']} valid slots of {qual['slots']}, {qual['lanes']} "
        f"lanes a slot): {timing_text(qual)} on {card}")
    del vgmap_inputs
    phase_surject(haps.graph, surject_recs, card)
    del surject_recs
    phase_pack_call(haps, idx, mem, vcf, card, args.seed)

    # the command line: giraffe -2, map -A, mpmap, and the tools after them
    cli = phase_cli(haps, idx, pairs, truth, vgmap, card, args.seed)
    capk = phase_cap_kernel(cli["captured"], cli["call_parts"], card,
                            args.compare_parent)
    log(f"total {time.time() - t_start:.1f} s")

    rows = []
    for name, (source, replaces) in KERNELS.items():
        if name == "banded_dp":
            k = dict(main_k, mismatches=kern["mismatches"],
                     max_abs_err=kern["max_abs_err"], library_ms=None)
            n = res["launches"][name]
        elif name == "banded_dp_bytes":   # the sharded steps' path
            k = dict(entries[name], library_ms=None)
            n = sharded_launches
        elif name in entries:        # on no path: its checks' launches
            k = dict(entries[name], library_ms=None)
            n = k["check_launches"]
        elif name == "banded_dp_qual":
            k = dict(qual, library_ms=None)
            n = vgmap["launches"]
        elif name == "mapq_cap":     # the CLI's giraffe -2 on FASTQ
            k = dict(capk, library_ms=None)
            n = cli["cap_launches"]
        elif name in lr["kernels"]:  # bucket 256 of the long-read batch
            k = dict(lr["kernels"][name], library_ms=None)
            n = lr["launches"][name]
        else:
            k = seedk[name]
            n = sres["stream_launches"][name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            "mismatches": k["mismatches"], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "enqueue_ms": k["enqueue_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
