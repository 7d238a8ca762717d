"""Runtime infrastructure: logging, watchdog, crash context.

Reference counterparts (SURVEY.md §5): vg::Logger with error[context]
formatting (src/log.hpp:8-34), the per-thread Watchdog flagging reads
stuck beyond a timeout (src/watchdog.hpp:20-47), and crash context
attaching the current read name to failure reports (src/crash.hpp:1-40
set_crash_context / crash_unless).

Copied from vg_tpu/utils/runtime.py.
"""
from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Optional


class Logger:
    """error[vg_tpu giraffe]: ... style messages, matching vg's format."""

    def __init__(self, context: str = "vg_tpu", stream=None):
        self.context = context
        self.stream = stream or sys.stderr

    def info(self, msg: str) -> None:
        self.stream.write(f"info[{self.context}]: {msg}\n")

    def warn(self, msg: str) -> None:
        self.stream.write(f"warning[{self.context}]: {msg}\n")

    def error(self, msg: str) -> None:
        self.stream.write(f"error[{self.context}]: {msg}\n")


_crash_context = threading.local()


def set_crash_context(msg: Optional[str]) -> None:
    """Record what is being processed for crash reports (vg
    set_crash_context)."""
    _crash_context.msg = msg


def get_crash_context() -> Optional[str]:
    return getattr(_crash_context, "msg", None)


def crash_unless(condition: bool, what: str = "invariant") -> None:
    """assert with context (vg crash_unless)."""
    if not condition:
        ctx = get_crash_context()
        detail = f" while processing {ctx}" if ctx else ""
        raise AssertionError(f"{what} violated{detail}")


class Watchdog:
    """Background thread that warns when a checked-in task runs longer
    than the timeout (vg Watchdog: check_in/check_out around each read;
    here around each batch)."""

    def __init__(self, timeout_s: float = 10.0, logger: Optional[Logger] = None):
        self.timeout_s = timeout_s
        self.logger = logger or Logger("vg_tpu watchdog")
        self._tasks: dict[int, tuple[str, float]] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_id = 0
        self.warnings = 0

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)

    def check_in(self, what: str) -> int:
        with self._lock:
            tid = self._next_id
            self._next_id += 1
            self._tasks[tid] = (what, time.time())
        return tid

    def check_out(self, tid: int) -> None:
        with self._lock:
            self._tasks.pop(tid, None)

    def _run(self) -> None:
        warned = set()
        while not self._stop.wait(min(self.timeout_s / 2, 1.0)):
            now = time.time()
            with self._lock:
                items = list(self._tasks.items())
            for tid, (what, t0) in items:
                if now - t0 > self.timeout_s and tid not in warned:
                    warned.add(tid)
                    self.warnings += 1
                    self.logger.warn(
                        f"task '{what}' has been running for "
                        f"{now - t0:.1f}s (> {self.timeout_s:.0f}s)")

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
