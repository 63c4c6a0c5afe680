"""The traced slice: torch.profiler over a short stretch of the cell's own
traffic after the window, reduced to what the per-layer metrics and the
`breakdown` read.

- kernels: every device operation (kernels, copies, sets) as (name, start
  us, end us) on the profiler's clock;
- spans: the benchmark's host spans (`bench.<name>` ranges it records
  around the program's calls) on the same clock;
- busy_s: the union of the device operations' intervals; window_s: the
  slice's length on the host clock;
- idle gaps between device operations, each named by the innermost host
  span open at its middle (where none is, by what the traffic says its
  host does outside the spans: `IDLE` of `traffic/<kind>.py`).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

SPAN_PREFIX = "bench."


@dataclass
class Slice:
    window_s: float
    kernels: list = field(default_factory=list)  # (name, t0_us, t1_us)
    spans: list = field(default_factory=list)  # (name, t0_us, t1_us)
    shapes: list = field(default_factory=list)  # (rows, seq) of each launched batch
    lengths: list = field(default_factory=list)  # framed lengths of the texts launched

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in union(self.kernels)) * 1e-6

    def kernel_seconds(self, match) -> float:
        """Summed device seconds of the operations whose name `match` accepts."""
        return sum(t1 - t0 for name, t0, t1 in self.kernels if match(name)) * 1e-6

    def device_ops(self, top: int = 10) -> list:
        total: dict[str, float] = {}
        for name, t0, t1 in self.kernels:
            total[name[:160]] = total.get(name[:160], 0.0) + (t1 - t0) * 1e-6
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10, unnamed: str = "other") -> list:
        """Idle device seconds by what the host was doing, longest first;
        a gap under no span is `unnamed`."""
        iv = union(self.kernels)
        bounds = [s for s in self.spans if s[0] == "slice"]
        lo, hi = (bounds[0][1], bounds[0][2]) if bounds else (iv[0][0], iv[-1][1]) if iv else (0, 0)
        edges = [lo] + [x for a, b in iv for x in (a, b)] + [hi]
        named: dict[str, float] = {}
        inner = [s for s in self.spans if s[0] != "slice"]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            open_ = [s for s in inner if s[1] <= mid <= s[2]]
            name = max(open_, key=lambda s: s[1])[0] if open_ else unnamed
            named[name] = named.get(name, 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in named.items()), key=lambda kv: -kv[1])[:top]


def union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for _, a, b in sorted(intervals, key=lambda x: x[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Profiler:
    """Start / stop the profiler around a slice and reduce what it saw."""

    def __init__(self):
        self._prof = None
        self._t0 = 0.0
        self._range = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        self._range = torch.profiler.record_function(SPAN_PREFIX + "slice")
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> Slice:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._range.__exit__(None, None, None)
        self._prof.stop()
        s = Slice(wall)
        for e in self._prof.events():
            dev = getattr(e, "device_type", None)
            if e.name.startswith(SPAN_PREFIX):
                # a host range also shows on the device's row as an
                # annotation: it is no device work
                if dev is None or dev.name != "CUDA":
                    s.spans.append((e.name[len(SPAN_PREFIX):], e.time_range.start,
                                    e.time_range.end))
            elif dev is not None and dev.name == "CUDA":
                s.kernels.append((e.name, e.time_range.start, e.time_range.end))
        return s
