#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, benchmark/ and
vg_tpu_torch/. Makes the cell's inputs from the seed, sets up the port
as `vg giraffe` does for the cell's configuration, warms it up, streams
reads through it for the window, then judges a sample of what it
produced against the plain reference under benchmark/reference/. With
--trace 0 the last line of standard output is the cell's end-to-end
metrics, with --trace 1 its per-layer metrics, as one JSON object; the
numbers compared and their limits are the last lines of standard error.
Exits with 2 and prints no result where no CUDA device is present, and
with 3 where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(HERE), str(ROOT)]
    import harness

    t_proc = harness.process_start()
    # every build and kernel cache of the program inside the checkout, at
    # fixed paths
    build = ROOT / "vg_tpu_torch" / "_build"
    os.environ["VGTPU_TORCH_KERNEL_CACHE"] = str(build)
    os.environ["VGTPU_TORCH_NATIVE_CACHE"] = str(build)
    cache = HERE / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, config, traffic = harness.load_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"no CUDA device for {args.workload} (needs {cell['chips']})",
              file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    print(f"card: {kind}, {torch.cuda.device_count()} device(s); "
          f"nvidia-smi name, power limit: {card_line()}; host cores: "
          f"{os.cpu_count()}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; Python {sys.version.split()[0]}",
          file=sys.stderr, flush=True)
    ctx = harness.Context(cell=cell, config=config, traffic=traffic,
                          seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), t_start=t_proc)
    ctx.notes["bench"] = bench
    ctx.notes["device_kind"] = kind
    out = harness.run(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
