"""Runtime metrics: counters and phase timers, a copy of the JAX package's
`utils/metrics.py`.

sentences/s, tokens/s, batch occupancy (real tokens over padded token
slots) and per-phase wall time.  The Engine and the server publish here;
the server sends a snapshot over the wire (the TPES frame).
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager


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
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._timers[name] += dt
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
