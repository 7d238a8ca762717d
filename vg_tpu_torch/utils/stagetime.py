"""Stage clock: the mapping pipeline's spans, summed into one counter dict.

`StageClock.span(name, cpu=False)` times a block of a pipeline stage. On
exit it adds the block's wall seconds (time.perf_counter) to
counters[name] and, with `cpu`, the calling thread's CPU seconds
(time.thread_time: this thread alone, not an OpenMP region's other
threads) to counters[name + ".cpu"], both under one lock. A span's wall
time less its CPU time is time the thread spent off the CPU: waiting for
the interpreter lock, a lock, the device, or a core.

While torch's profiler records, each span is also a profiler range named
"vg." + name on its thread, so it lands in the same trace, on the same
clock, as the device operations, nested as the spans nest. The range's
one input is the sequence number of the batch the thread works on (see
`set_batch`), so that one batch's ranges on the seeder, rescuer and
emitter threads can be matched; the profiler keeps inputs where it
records shapes. With the profiler off a span costs two clock reads (four
with `cpu`), a lock and a dict add. `add` keeps a count in the same
dict.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from torch._C import _autograd
from torch.autograd import profiler as _profiler


def _open_range(name: str, seq: Optional[int]):
    """Open profiler range `name` on this thread; its handle."""
    if seq is None:
        return _autograd._record_function_with_args_enter(name)
    return _autograd._record_function_with_args_enter(name, seq)


class StageClock:
    """Span seconds summed into `counters` (a dict of floats, shared by
    every thread of the pipeline)."""

    def __init__(self, counters: Optional[Dict[str, float]] = None):
        self.counters = {} if counters is None else counters
        self._lock = threading.Lock()
        self._local = threading.local()

    def set_batch(self, seq: Optional[int]) -> None:
        """The sequence number of the batch this thread works on (None
        between batches): the input of this thread's profiler ranges."""
        self._local.seq = seq

    def span(self, name: str, cpu: bool = False) -> "_Span":
        return _Span(self, name, cpu)

    def add(self, name: str, value: float) -> None:
        """Add `value` to counters[name]: a count kept beside the spans
        (rows of a kind, say), read as the spans are."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value


class _Span:
    __slots__ = ("clock", "name", "cpu", "handle", "t0", "c0")

    def __init__(self, clock: StageClock, name: str, cpu: bool):
        self.clock, self.name, self.cpu = clock, name, cpu

    def __enter__(self):
        self.handle = None
        if _profiler._is_profiler_enabled:
            self.handle = _open_range(
                "vg." + self.name,
                getattr(self.clock._local, "seq", None))
        # the CPU clock's reads inside the wall clock's: CPU <= wall
        self.t0 = time.perf_counter()
        self.c0 = time.thread_time() if self.cpu else 0.0
        return self

    def __exit__(self, *exc) -> None:
        c1 = time.thread_time() if self.cpu else 0.0
        t1 = time.perf_counter()
        if self.handle is not None:
            _autograd._record_function_with_args_exit(self.handle)
        clock, name = self.clock, self.name
        with clock._lock:
            d = clock.counters
            d[name] = d.get(name, 0.0) + (t1 - self.t0)
            if self.cpu:
                name += ".cpu"
                d[name] = d.get(name, 0.0) + (c1 - self.c0)
