"""Spans from the harness's own wrappers, and the device trace of a
stretch of the window.

A span is the host time of one call into the program, summed over the
threads that make it. While the profiler runs, each span is also a
`record_function` range named `bench.<span>` (the breakdown names idle
gaps by them), and a call whose device time a roofline needs is timed
by CUDA events around its kernel launches. The profiler traces every
thread (the pipeline's threads start before the stretch does), and one
short spin kernel primes it before the stretch starts: without a torch
kernel in the profiled region it misses the first kernels that the
port's own libraries launch.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

SPIN = "spin_kernel"


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Total length covered by the intervals (overlaps counted once)."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class _Ranged:
    ranged = False


class Tracer:
    """Host spans always (cheap sums), ranges and the device trace while
    a stretch is profiled. Off entirely when `enabled` is false."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.lock = threading.Lock()
        self.sums: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.profiling = False
        self.payloads: Dict[str, list] = defaultdict(list)
        self.timed: Dict[str, list] = defaultdict(list)
        self.local = threading.local()
        self.prof = None
        self.wall = None
        self.events = None

    def reset(self) -> None:
        with self.lock:
            self.sums.clear()
            self.calls.clear()

    @contextlib.contextmanager
    def span(self, name: str, device: bool = False):
        """Time a call as span `name`. Yields a record whose `ranged` is
        true once the call has run wholly inside the profiled stretch.
        With `device`, the kernel launches the call makes through
        `launch` are kept under `name` when it is ranged."""
        rec = _Ranged()
        if not self.enabled:
            yield rec
            return
        rf = None
        if self.profiling:
            from torch.profiler import record_function

            rf = record_function("bench." + name)
            rf.__enter__()
            if device:
                self.local.launches = []
        t0 = time.perf_counter()
        try:
            yield rec
        finally:
            dt = time.perf_counter() - t0
            launches = None
            if rf is not None:
                rf.__exit__(None, None, None)
                rec.ranged = self.profiling
                if device:
                    launches, self.local.launches = self.local.launches, None
            with self.lock:
                self.sums[name] += dt
                self.calls[name] += 1
                if launches and rec.ranged:
                    self.timed[name].extend(launches)

    @contextlib.contextmanager
    def launch(self):
        """Time one kernel launch by a pair of CUDA events on the current
        stream, inside a `device` span of the profiled stretch."""
        pairs = getattr(self.local, "launches", None)
        if pairs is None or not self.profiling:
            yield
            return
        import torch

        ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
        ev[0].record()
        try:
            yield
        finally:
            ev[1].record()
            pairs.append(ev)

    def keep(self, name: str, payload) -> None:
        """Keep what a call profiled under span `name` worked on."""
        with self.lock:
            self.payloads[name].append(payload)

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        (CUPTI's) takes seconds, which would otherwise fall in the
        window."""
        import torch

        self.start()
        torch.cuda.synchronize()
        self.profiling = False
        self.prof.__exit__(None, None, None)
        self.prof = None

    def due(self, now: float, start: float, seconds: float) -> None:
        """Start the stretch at 40% of the window; stop it once it has
        lasted a fifth of the window."""
        if self.prof is None and now - start >= 0.4 * seconds:
            self.start()
        elif self.profiling and time.perf_counter() - self.t0 >= \
                0.2 * seconds:
            self.stop()

    def span_window(self):
        """(start, end) on the perf_counter clock of the profiled stretch
        with the profiler's own start before it and stop after it; an
        empty interval where no stretch was traced."""
        if self.wall is None:
            return float("inf"), float("-inf")
        return self.t_enter, self.t_exit

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        kw = {}
        try:
            from torch._C._profiler import _ExperimentalConfig

            kw["experimental_config"] = _ExperimentalConfig(
                profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA], **kw)
        self.t_enter = time.perf_counter()
        self.prof.__enter__()
        torch.cuda._sleep(100)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self.profiling = True

    def stop(self) -> None:
        import torch

        self.profiling = False
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.events = list(self.prof.profiler.kineto_results.events())
        self.t_exit = time.perf_counter()

    # ------------------------------------------------------ reading
    def device_events(self):
        """(name, start ns, end ns, correlation, linked correlation) of
        every device operation in the stretch but the priming spin."""
        from torch.autograd import DeviceType

        out = []
        for e in self.events or ():
            if e.device_type() != DeviceType.CUDA:
                continue
            name = e.name()
            # the profiler mirrors each range onto the device's timeline
            # as an annotation: not an operation
            if SPIN in name or name.startswith("bench.") or getattr(
                    e, "is_user_annotation", lambda: False)():
                continue
            s = e.start_ns()
            out.append((name, s, s + e.duration_ns(), e.correlation_id(),
                        e.linked_correlation_id()))
        return out

    def host_ranges(self):
        """(span name, start ns, end ns, thread, correlation) of each
        harness range in the stretch."""
        from torch.autograd import DeviceType

        out = []
        for e in self.events or ():
            if e.device_type() == DeviceType.CUDA:
                continue
            name = e.name()
            if name.startswith("bench."):
                out.append((name[6:], e.start_ns(), e.end_ns(),
                            e.start_thread_id(), e.correlation_id()))
        return out

    def busy_seconds(self) -> Optional[float]:
        dev = self.device_events()
        if self.events is None:
            return None
        return union_length([(s, e) for _, s, e, _, _ in dev]) / 1e9

    def span_device_seconds(self, span: str) -> Optional[float]:
        """Device seconds of the kernel launches inside the ranged calls
        of `span` (`span(..., device=True)`): from the event before each
        launch to the event after it, summed. Events, not the trace: the
        trace has been seen to miss a whole thread's kernels."""
        pairs = self.timed.get(span)
        if not pairs:
            return None
        return sum(a.elapsed_time(b) for a, b in pairs) / 1e3

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps named by the harness spans the host was in."""
        dev = self.device_events()
        by_name = defaultdict(int)
        for name, s, e, _, _ in dev:
            by_name[name[:120]] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = merged([(s, e) for _, s, e, _, _ in dev])
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])]
        gaps.sort(reverse=True)
        ranges = self.host_ranges()
        named = []
        for length, s, e in gaps[:top]:
            mid = (s + e) / 2
            names = sorted({r[0] for r in ranges if r[1] <= mid <= r[2]})
            named.append(["+".join(names) or "no span", length / 1e9])
        return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
                "idle_gaps": named}
