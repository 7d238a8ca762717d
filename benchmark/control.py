#!/usr/bin/env python3
"""The control of a cell's comparison, and planted faults, on the card at
the cell's size.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13
                                 [--seconds 4]

For each seed, in one process: the cell's set-up and a short window, as
a run makes them, then one more short window with each of two faults of
faults.py planted in the timed path (records unmapped, and records under
each other's names: the faults that placement catches); then the numbers
compared, once as a run judges the port's outputs, once with the control
in the port's place (the reference in the precision below the one the
configuration states: giraffe-sr's MAPQ cap in float32, giraffe-hifi's
scores summed in float16), and once for each fault's window. Prints one
JSON line a seed with every reading. The benchmark's own runs never run
this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FAULTS = ("unmapped", "swapped")


def window_kept(cfg_mod, ctx, state):
    """A short window, and the calls it kept for the judge."""
    win = cfg_mod.window(ctx, state)
    capture = getattr(state, "capture", None)
    return win, capture and {k: list(v) for k, v in capture.kept.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import faults
    import harness
    from spans import Tracer

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, config, traffic = harness.load_cell(bench, args.workload)
    cfg_mod = harness.load_module(HERE / "configs" / f"{cell['config']}.py",
                                 f"bench_config_{cell['config']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(cell=cell, config=config, traffic=traffic,
                              seed=seed, seconds=args.seconds,
                              trace=False, t_start=time.time())
        ctx.tracer = Tracer(False)
        state = cfg_mod.setup(ctx)
        wins = {"program": window_kept(cfg_mod, ctx, state)}
        for kind in FAULTS:
            with faults.planted(kind, cell["config"]):
                wins[kind] = window_kept(cfg_mod, ctx, state)
        cfg_mod.release(state)
        got = {"seed": seed}
        readings = [("program", False, "program"),
                    ("control", True, "program")] + [
            (kind, False, kind) for kind in FAULTS]
        for label, control, of in readings:
            t0 = time.time()
            win, kept = wins[of]
            if kept is not None:
                state.capture.kept = kept
            checks = cfg_mod.judge(ctx, state, win, control=control)
            got[label] = {n: v for n, v, _ in checks}
            got[label + "_fails"] = [n for n, v, lim in checks
                                     if not harness.ok(v, lim)]
            got[label + "_s"] = time.time() - t0
        print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
