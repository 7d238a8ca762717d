"""One run of one cell: set-up, window, readers, judge, result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by name: `configs/<config>.json` and its module
`configs/<config>.py`, `traffic/<traffic>.json`, `metrics/<metric>.py`.
A configuration's module defines

    setup(ctx) -> state            inputs, the program's set-up, warm-up
    window(ctx, state) -> dict     the measured window; end-to-end work
    layer(ctx, state, win) -> dict what the per-layer readers read
    release(state)                 drops the program's state
    judge(ctx, state, win) -> list (name, number, limit) checks

and a metric reader `read(layer) -> float | None`.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import pathlib
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vg_tpu")


def process_start() -> float:
    """Wall-clock time at which this process started (Linux)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Context:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = 0.0
    parts: Dict[str, float] = field(default_factory=dict)
    tracer: object = None
    notes: Dict[str, object] = field(default_factory=dict)

    @contextlib.contextmanager
    def part(self, name: str):
        """Time one part of set-up (printed on an earlier line)."""
        t0 = time.time()
        try:
            yield
        finally:
            self.parts[name] = self.parts.get(name, 0.0) + time.time() - t0

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()


def load_cell(bench: dict, workload: str, root: pathlib.Path = ROOT):
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return cell, config, traffic


def cell_metrics(bench: dict, cell: dict) -> tuple:
    """(end-to-end, per-layer) metric entries this cell reports."""
    def mine(m):
        return "workloads" not in m or cell["name"] in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if mine(m)
             and m["moves"] in names]
    return e2e, layer


def run(ctx: Context) -> dict:
    """Set-up, window, readers, judge. Returns the result object."""
    from spans import Tracer

    ctx.tracer = Tracer(ctx.trace)
    cfg_mod = load_module(HERE / "configs" / f"{ctx.cell['config']}.py",
                         f"bench_config_{ctx.cell['config']}")
    state = cfg_mod.setup(ctx)
    ctx.sync()
    win = cfg_mod.window(ctx, state)
    memory_peak = None
    if ctx.device == "cuda":
        import torch

        torch.cuda.synchronize()
        memory_peak = int(max(torch.cuda.max_memory_allocated(d)
                              for d in range(torch.cuda.device_count())))
    e2e, per_layer = cell_metrics(ctx.notes["bench"], ctx.cell)
    metrics = {}
    if ctx.trace:
        layer = cfg_mod.layer(ctx, state, win)
        for m in per_layer:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 f"bench_metric_{m['name']}")
            v = reader.read(layer)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": win["setup_s"], "unit": "s"}
            elif m["name"] in win["metrics"]:
                metrics[m["name"]] = {"value": win["metrics"][m["name"]],
                                      "unit": m["unit"]}
    cfg_mod.release(state)
    gc.collect()
    if ctx.device == "cuda":
        import torch

        torch.cuda.empty_cache()
    t0 = time.time()
    checks = cfg_mod.judge(ctx, state, win)
    ctx.log(f"reference: {time.time() - t0:.1f} s")
    correct = all(ok(v, lim) for _, v, lim in checks)
    device = {"platform": "gpu" if ctx.device == "cuda" else ctx.device,
              "kind": win.get("device_kind"),
              "count": 1, "memory_peak_bytes": memory_peak}
    if ctx.trace:
        device["busy_s"] = win.get("busy_s")
        device["window_s"] = win.get("trace_window_s")
    out = {"correct": correct, "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics, "device": device}
    if ctx.trace and win.get("breakdown"):
        out["breakdown"] = win["breakdown"]
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def ok(value, limit) -> bool:
    return value is not None and value == value and value <= limit
