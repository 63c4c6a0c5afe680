"""Published dense peaks of the card and the roofline bound.

Frozen copy of `PEAKS` / `peaks_for` / `bound_ms` from the port's
`embedding_cpp_tpu_torch/utils/profiling.py` (as of this benchmark's first
version), so that a later change to the program cannot move the yardstick:
NVIDIA's data sheets, memory bytes/s and bf16 tensor-core flop/s, dense
rates without sparsity, at the card's full power limit.
"""
from __future__ import annotations

PEAKS = {
    "H100 PCIe": (2.0e12, 756e12),
    "H100 NVL": (3.9e12, 835e12),
    "H100": (3.35e12, 989e12),  # SXM5, the 80 GB HBM3 part
}


def peaks_for(name: str) -> tuple[float, float]:
    """(bytes/s, bf16 flop/s) for a card's reported name."""
    for key, val in PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no published peaks for {name!r}")


def bound_ms(nbytes: float, flops: float, peaks: tuple[float, float]) -> tuple[float, str]:
    """The least time for work that moves `nbytes` and does `flops`: the
    larger of bytes / memory rate and flops / peak rate, with which one."""
    bw, flop_rate = peaks
    t_bytes, t_ops = nbytes / bw * 1e3, flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
