"""Multi-process dry run of the port's sharded steps: the counterpart of
vg_tpu's __graft_entry__.dryrun_multichip, one process per device.

    python -m vg_tpu_torch.parallel.dryrun --nproc N [--device cpu]

spawns N ranks that meet through a file store in a temporary directory
(no TCP port). On a mesh of all N ranks ('data',) they run the map step
(its coverage sums to R) and the full paired step (coverage 2R, each
rank's rows equal to the replicated step's); with N >= 2 also the
text-sharded paired step on a (N / dt, dt) ('data', 'text') mesh, dt = 4
where N % 4 == 0 else 2, equal to the replicated step, and rescue on the
sharded text equal to the replicated scorer. --device cuda, the default,
runs NCCL with one card a rank; cpu runs gloo.

run_ranks is the launcher: the ranks run a function of this JAX-free
package (spawned children import the target's module afresh), and a rank
that hangs is killed at the deadline instead of holding its caller.
"""
from __future__ import annotations

import argparse
import datetime
import multiprocessing
import multiprocessing.connection
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..ops import align
from .mesh import (BACKENDS, make_mesh, make_paired_step, mesh_device,
                   shard_rows, sharded_map_step, sharded_paired_step,
                   sharded_rescue_scores, sharded_text_paired_step)

INIT_TIMEOUT_S = 60      # a rank waits this long for the others to meet
OUTPUT_NAMES = ("s1", "s2", "j1", "j2", "mq1", "mq2", "use_pair", "frags",
                "mm1", "mm2", "bits1", "bits2", "stats", "cov")


def _example_batch(R=64, RL=128, C=8, B=16, T=32768, seed=0):
    """__graft_entry__._example_batch: a random text, reads copied from it
    at each row's first candidate, every candidate valid and forward."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, size=T).astype(np.uint8)
    starts = rng.integers(0, T - RL - 2 * B, size=(R, C)).astype(np.int32)
    reads = np.zeros((R, RL), np.uint8)
    for i in range(R):
        s = int(starts[i, 0]) + B
        reads[i] = text[s : s + RL]
    comp = np.array([3, 2, 1, 0, 4, 5], np.uint8)
    reads_rc = comp[reads][:, ::-1].copy()
    rlen = np.full(R, RL, np.int32)
    lo = np.zeros((R, C), np.int32)
    hi = np.full((R, C), T, np.int32)
    rev = np.zeros((R, C), bool)
    valid = np.ones((R, C), bool)
    return text, reads, reads_rc, rlen, starts, lo, hi, rev, valid


def _rank_main(rank, world, store, device, target, args):
    """One rank: join the process group through the file store, run
    target(rank, world, device, *args), leave the group."""
    torch.set_num_threads(1)
    # every rank of run_ranks is on this host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        BACKENDS[device], init_method="file://" + store, rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    target(rank, world, device, *args)
    dist.destroy_process_group()
    if "jax" in sys.modules:
        raise RuntimeError(f"rank {rank} imported jax")


def run_ranks(nproc: int, target, args=(), *, device: str = "cuda",
              timeout: float = 300.0) -> None:
    """Run target(rank, nproc, device, *args) in nproc spawned processes,
    one rank each, in a process group (NCCL for "cuda", a card a rank;
    gloo for "cpu"). Raises once any rank fails (the others are killed)
    or when ranks are still running at the deadline."""
    if device not in BACKENDS:
        raise ValueError(f"device {device!r}, expected one of "
                         f"{sorted(BACKENDS)}")
    if device == "cuda" and torch.cuda.device_count() < nproc:
        raise RuntimeError(f"{nproc} ranks on cuda need {nproc} cards, "
                           f"this host has {torch.cuda.device_count()}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="vgtpu_ranks_") as d:
        store = os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, nproc, store, device, target, args))
                 for r in range(nproc)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            running = list(procs)
            while running:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"ranks {[procs.index(p) for p in running]} still "
                        f"ran after {timeout} s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in running], left)
                running = [p for p in running if p.exitcode is None]
                failed = [(procs.index(p), p.exitcode) for p in procs
                          if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"ranks failed (rank, exit code): "
                                       f"{failed}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _same_as_replicated(got, want, rows, label):
    """A sharded step's outputs against the replicated step's: per-read
    outputs (this rank's rows) and coverage exact, the fragment count
    exact, its sums to float32 rounding (the ranks sum their rows apart)."""
    for name, g, w in zip(OUTPUT_NAMES, got, want):
        w = w if name in ("stats", "cov") else w[rows]
        if name == "stats":
            _expect(bool(g[0] == w[0]) and bool(torch.allclose(
                g[1:], w[1:], rtol=1e-5, atol=0)), f"{label}: stats {g} "
                f"against the replicated {w}")
        else:
            _expect(torch.equal(g.cpu(), w.cpu()),
                    f"{label}: {name} differs from the replicated step")


def dryrun_rank(rank, world, device):
    """The dry run on one rank (dryrun_multichip's asserts)."""
    mesh = make_mesh(world, device=device)
    dev = mesh_device(mesh)
    R = max(8 * world, 16)
    args = _example_batch(R=R, RL=64, C=4, B=8, T=8192)
    scores, cov = sharded_map_step(mesh, *args, band_radius=8)
    rows = shard_rows(R, mesh)
    _expect(tuple(scores.shape) == (R // world, 4), f"scores {scores.shape}")
    _expect(int(cov.sum()) == R, f"coverage sum lost reads: "
            f"{int(cov.sum())}/{R}")

    # the full paired step: per-mate DP + pair selection + MAPQ +
    # fragment statistics + coverage, data-parallel
    text, reads, reads_rc, rlen, starts, lo, hi, rev, valid = args
    C = starts.shape[1]
    rp = np.zeros((R, C), np.int32)           # all on one "reference path"
    ro = starts.astype(np.int32)
    mate1 = (reads, reads_rc, rlen, (starts, lo, hi, rev, valid, rp, ro))
    # mate 2: reverse-strand placements ~400bp downstream
    starts2 = starts + 300
    rev2 = np.ones_like(rev)
    mate2 = (reads_rc, reads, rlen,
             (starts2, lo, hi, rev2, valid, rp, starts2.astype(np.int32)))
    out = sharded_paired_step(mesh, text, mate1, mate2, mu=420.0, sd=60.0,
                              band_radius=8)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    whole = lambda m: (put(m[0]), put(m[1]), put(m[2]),
                       tuple(put(a) for a in m[3]))
    want = make_paired_step(band_radius=8)(
        put(text), *whole(mate1), *whole(mate2), 420.0, 60.0)
    _expect(tuple(out[0].shape) == (R // world, C), f"s1 {out[0].shape}")
    _expect(int(out[13].sum()) == 2 * R, "paired coverage sum lost ends")
    _expect(float(out[12][0]) >= 0, "negative fragment count")
    _same_as_replicated(out, want, rows, "data-parallel paired step")

    if world >= 2:
        # the text split over 'text' (per-shard int32 coordinates, the
        # capacity axis), reads data-parallel over 'data'
        dt = 4 if world % 4 == 0 else 2
        mesh2 = make_mesh(world, ("data", "text"), (world // dt, dt),
                          device=device)
        out_sh = sharded_text_paired_step(mesh2, text, mate1, mate2,
                                          mu=420.0, sd=60.0, band_radius=8)
        _same_as_replicated(out_sh, want, shard_rows(R, mesh2),
                            f"text-sharded step on ({world // dt}, {dt})")

        # rescue on the sharded text: windows near the mates, on a third
        # of the rows, scored on the shard owning each
        Crc = 4
        r_start = starts[:, :Crc] + 280
        r_valid = np.zeros((R, Crc), bool)
        r_valid[::3] = True
        s_sh = sharded_rescue_scores(mesh2, text, reads_rc, rlen, r_start,
                                     lo[:, :Crc], hi[:, :Crc], r_valid,
                                     band_radius=8)
        s_ref = align.banded_scores(
            put(text), put(reads_rc), put(reads_rc), put(rlen),
            put(r_start), put(lo[:, :Crc]), put(hi[:, :Crc]),
            put(np.zeros((R, Crc), bool)), put(r_valid), band_radius=8)
        _expect(torch.equal(s_sh, torch.where(put(r_valid), s_ref, -1)),
                "sharded rescue scores diverge")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, required=True,
                    help="ranks to spawn, one device each")
    ap.add_argument("--device", choices=sorted(BACKENDS), default="cuda")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds before running ranks are killed")
    args = ap.parse_args(argv)
    t0 = time.time()
    try:
        run_ranks(args.nproc, dryrun_rank, device=args.device,
                  timeout=args.timeout)
    except (RuntimeError, TimeoutError) as e:
        print(f"dryrun: {e}", file=sys.stderr)
        return 1
    print(f"dryrun_multichip OK on {args.nproc} ranks ({args.device}, "
          f"{BACKENDS[args.device]}) in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
