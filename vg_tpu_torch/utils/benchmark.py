"""Micro-benchmark harness (vg benchmark role, reference:
src/benchmark.hpp:20-40 — control-normalized benchmark results so numbers
are comparable across machines).

Copied from vg_tpu/utils/benchmark.py.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List


@dataclass
class BenchmarkResult:
    name: str
    iterations: int
    seconds: float
    control_seconds: float

    @property
    def per_iteration(self) -> float:
        return self.seconds / max(self.iterations, 1)

    @property
    def normalized_score(self) -> float:
        """Iterations per control-unit time (machine-independent-ish)."""
        if self.seconds == 0:
            return float("inf")
        return self.iterations * self.control_seconds / self.seconds

    def line(self) -> str:
        return (f"{self.name}\t{self.iterations} iters\t"
                f"{self.per_iteration*1e6:.2f} us/iter\t"
                f"score {self.normalized_score:.1f}")


def _control_work() -> None:
    x = 0
    for i in range(100000):
        x += i * i


def run_benchmark(name: str, fn: Callable[[], None],
                  iterations: int = 100) -> BenchmarkResult:
    t0 = time.perf_counter()
    _control_work()
    control = time.perf_counter() - t0
    fn()                              # warm
    t0 = time.perf_counter()
    for _ in range(iterations):
        fn()
    dt = time.perf_counter() - t0
    return BenchmarkResult(name, iterations, dt, control)
