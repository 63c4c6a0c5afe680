"""Runtime metrics: counters and phase timers, a copy of the JAX package's
`utils/metrics.py`.

sentences/s, tokens/s, batch occupancy (real tokens over padded token
slots) and per-phase wall time.  The Engine and the server publish here;
the server sends a snapshot over the wire (the TPES frame).

The same spans go on the profiler's clock: while a torch profiler records
on the calling thread, `Metrics.timer(name)` also opens a profiler range
named `name`, and `op_range(name)` opens one around an op family's work
(`op.linear`, `op.norm`, ...) with no timer.  Each range is a `cpu_op`
event (`_RecordFunctionFast`), not a user annotation: the profiler links
every kernel launched inside it to it, the ctypes-launched ones included,
and mirrors nothing of it onto the device's row.  With no profiler
recording, either costs one flag check.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def op_range(name: str):
    """A profiler range named `name` while a profiler records on this
    thread (torch's process-wide flag first, then the thread's own state),
    else a shared no-op context."""
    if _profiler._is_profiler_enabled and _profiler_enabled():
        return _RecordFunctionFast(name)
    return _OFF


def in_op_range(name: str):
    """Decorator: every call of the function inside `op_range(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            with op_range(name):
                return fn(*args, **kw)
        return run
    return wrap


class Metrics:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._timers: dict[str, float] = defaultdict(float)
        self._timer_counts: dict[str, int] = defaultdict(int)
        self._start = time.time()

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    @contextmanager
    def timer(self, name: str):
        """Time the block under `name`, and while a profiler records, a
        profiler range of that name around it (`op_range`)."""
        with op_range(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.add_time(name, time.perf_counter() - t0)

    def add_time(self, name: str, seconds: float) -> None:
        """One span of `seconds` under `name`: for a span that starts on one
        thread or task and ends on another, where no range can open."""
        with self._lock:
            self._timers[name] += seconds
            self._timer_counts[name] += 1

    def snapshot(self) -> dict:
        with self._lock:
            uptime = time.time() - self._start
            eval_time = self._timers.get("eval", 0.0)
            sentences = self._counters.get("sentences", 0.0)
            tokens = self._counters.get("tokens", 0.0)
            padded = self._counters.get("padded_slots", 0.0)
            out = {
                "uptime_s": round(uptime, 2),
                "counters": dict(self._counters),
                "timers_s": {k: round(v, 4) for k, v in self._timers.items()},
                "timer_counts": dict(self._timer_counts),
            }
            if eval_time > 0:
                out["sentences_per_sec"] = round(sentences / eval_time, 1)
                out["tokens_per_sec"] = round(tokens / eval_time, 1)
            if padded > 0:
                out["batch_occupancy"] = round(tokens / padded, 4)
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()
            self._timer_counts.clear()
            self._start = time.time()


GLOBAL = Metrics()
