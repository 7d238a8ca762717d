"""Tiny cells for the benchmark's CPU tests: the cells of BENCHMARK.json
at a size a test run holds, run through the harness on the CPU (the
port's plain versions) without its look for a card."""
from __future__ import annotations

import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402


# A cell whose files are under benchmark/ but that BENCHMARK.json does not
# run (PERF.md, Open questions): its entries, for the tests alone.
WAITING = {
    "workloads": [{"name": "giraffe-hifi.hifi", "config": "giraffe-hifi",
                   "traffic": "hifi", "chips": 1}],
    "configs": [{"name": "giraffe-hifi",
                 "file": "benchmark/configs/giraffe-hifi.json"}],
}


def context(workload: str, seed: int = 5, seconds: float = 2.0,
            ref_bp: int = 120_000, trace: bool = False):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in WAITING.items():
        bench[key] = bench[key] + entries
    cell, config, traffic = harness.load_cell(bench, workload)
    config = dict(config, ref_length_bp=ref_bp)
    traffic = dict(traffic)
    if traffic["kind"] == "pairs":
        traffic.update(batch_pairs=32, pool_batches=3)
        config["warm_batches"] = 3
    else:
        traffic.update(batch_reads=3, pool_batches=2, length_mean=2500,
                       length_sd=400, length_min=1800, length_max=3200)
        config["warm_batches"] = 1
    ctx = harness.Context(cell=cell, config=config, traffic=traffic,
                          seed=seed, seconds=seconds,
                          trace=trace, device="cpu", t_start=time.time())
    ctx.notes["bench"] = bench
    return ctx
