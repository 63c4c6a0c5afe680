"""The program's own ranges in the traced slice, reduced once per run from
the profiler's events (`Run._profiler._prof.events()`).

The port opens them itself (`embedding_cpp_tpu_torch/utils/metrics.py`):
the Engine's request spans (`encode`, `tokenize`, `eval`, `plan`,
`launch`, `fetch`, `finish`) and the op families' ranges (`op.linear`,
`op.residual`, `op.norm`, `op.attention`, `op.rope`, `op.embed`,
`op.pool`), each a CPU op on the profiler's clock, never a user
annotation, so none of them is a device operation of the slice.

- spans: every program range as (name, t0 us, t1 us) on the profiler's
  clock, the clock of the slice's device operations;
- device_us: device microseconds per innermost program range.  A device
  operation belongs to the op the profiler's correlation links it to (the
  innermost op open on the launching thread: an aten op, or a program
  range itself for a kernel launched through ctypes), then up that op's
  `cpu_parent`s to the nearest program range; None holds those under no
  program range.  The benchmark's own annotations (`bench.*`) are no
  device operations here either, as in `trace.py`.

A program without these ranges gives nothing: `program_trace(run)` is None
and the readers that use it return None.
"""
from __future__ import annotations

from dataclasses import dataclass, field

REQUEST_SPANS = frozenset({"encode", "tokenize", "eval", "plan", "launch", "fetch", "finish"})
OP_PREFIX = "op."
BENCH_PREFIX = "bench."


def is_program_range(name: str) -> bool:
    return name in REQUEST_SPANS or name.startswith(OP_PREFIX)


@dataclass
class ProgramTrace:
    spans: list = field(default_factory=list)  # (name, t0_us, t1_us)
    device_us: dict = field(default_factory=dict)  # innermost range (or None) -> us

    def device_seconds(self, *names) -> float:
        return sum(self.device_us.get(n, 0.0) for n in names) * 1e-6

    def span_seconds(self, name: str) -> float:
        return sum(b - a for n, a, b in self.spans if n == name) * 1e-6

    def intervals(self, name: str) -> list:
        return [(a, b) for n, a, b in self.spans if n == name]


def _is_op(e) -> bool:
    """A host op the profiler links device work to: a torch op (`ns::name`)
    or a program range, on the CPU.  The profiler's own host events (its
    "Activity Buffer Request" may list a copy that a torch op lists too),
    runtime calls and user annotations own nothing here."""
    return (e.device_type.name == "CPU" and not getattr(e, "is_user_annotation", False)
            and ("::" in e.name or is_program_range(e.name)))


def _owner(e):
    """The nearest program range at or above `e` (None where there is none)."""
    while e is not None:
        if is_program_range(e.name):
            return e.name
        e = e.cpu_parent
    return None


def reduce_events(events) -> ProgramTrace | None:
    out = ProgramTrace()
    for e in events:
        if not _is_op(e):
            continue
        if is_program_range(e.name):
            out.spans.append((e.name, e.time_range.start, e.time_range.end))
        kernels = [k for k in e.kernels if not k.name.startswith(BENCH_PREFIX)]
        if kernels:
            owner = _owner(e)
            out.device_us[owner] = out.device_us.get(owner, 0.0) + sum(k.duration
                                                                       for k in kernels)
    return out if out.spans else None


def program_trace(run) -> ProgramTrace | None:
    """The run's reduced program ranges, made at the first call and kept on
    the run; None without a traced slice or without program ranges."""
    if not hasattr(run, "_program_trace"):
        prof = getattr(getattr(run, "_profiler", None), "_prof", None)
        run._program_trace = (reduce_events(prof.events())
                              if prof is not None and run.slice is not None else None)
    return run._program_trace


def per_ktok(seconds: float, run, scale: float) -> float | None:
    """`seconds` in units of 1/`scale` s per 1000 real tokens launched in
    the slice."""
    tokens = float(run.slice.lengths.sum()) if len(run.slice.lengths) else 0.0
    return seconds * scale / (tokens / 1e3) if tokens else None
