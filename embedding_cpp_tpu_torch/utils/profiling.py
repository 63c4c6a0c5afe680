"""GPU profiling helpers: torch.profiler traces, CUDA-event kernel times and
the roofline bound (the counterpart of the JAX package's
`utils/profiling.py`).

`trace` profiles a region with torch.profiler and can write its
Chrome/Perfetto trace; `gpu_ms` times a call on the card with CUDA events;
`bound_ms` gives the least time the card could take for the same work,
from the card's published dense peaks (`peaks_for`).  `chip_smoke.py` and
the kernel A/B suite (`benchmarks/kernels.py`) share these, so their
profiles, times and bounds are taken and computed one way.
"""
from __future__ import annotations

import subprocess
from contextlib import contextmanager
from pathlib import Path

import numpy as np

# Published dense peaks by the name the card reports (NVIDIA data sheets):
# memory bytes/s and bf16 tensor-core flop/s.
PEAKS = {
    "H100 PCIe": (2.0e12, 756e12),
    "H100 NVL": (3.9e12, 835e12),
    "H100": (3.35e12, 989e12),  # SXM5, the 80 GB HBM3 part
}
# f32 outside the tensor cores (the same data sheets)
F32_PEAKS = {"H100 PCIe": 51e12, "H100 NVL": 60e12, "H100": 67e12}


def peaks_for(name: str) -> tuple[str, tuple[float, float]]:
    """(table key, (bytes/s, bf16 flop/s)) for a card's reported name."""
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise RuntimeError(f"no published peaks for {name!r}")


@contextmanager
def trace(log_dir: str | None = None):
    """Profile the region with torch.profiler, on the CPU and, where there
    is one, the card; yields the profiler (its `key_averages()` read after
    the region).  With `log_dir`, also writes the Chrome trace (viewable in
    Perfetto) to log_dir/trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def gpu_ms(fn, samples: int = 20, reps: int = 3, spin: int = 2_000_000) -> float:
    """Median over `samples` of CUDA-event time per call, each sample `reps`
    back-to-back calls queued behind a GPU spin of `spin` cycles, so the
    host's launch overhead stays out of the device time."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(spin)  # keep the stream busy while we enqueue
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))



def device_ms(fn, device, samples: int = 20, spin: int = 2_000_000) -> float:
    """ms per call of `fn` on `device`: on a card `gpu_ms` with one call a
    sample (a call that waits on the host is timed up to its end); on the
    CPU the least host-clock time of `samples` calls after a warmup."""
    import time

    import torch

    if torch.device(device).type == "cuda":
        return gpu_ms(fn, samples=samples, reps=1, spin=spin)
    fn()
    best = float("inf")
    for _ in range(samples):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3

def bound_ms(nbytes: float, flops: float, peaks: tuple[float, float]) -> tuple[float, str]:
    """The least time for work that moves `nbytes` and does `flops`: the
    larger of bytes / memory rate and flops / peak rate, with which one."""
    bw, flop_rate = peaks
    t_bytes, t_ops = nbytes / bw * 1e3, flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_block(device=None):
    """What a measurement ran on: "cpu" for a CPU run; for the card, its
    name and power limit as `nvidia-smi --query-gpu=name,power.limit` gives
    them, beside torch's name, the card count and the torch and CUDA
    versions, so no time stands without its card."""
    import torch

    if device is not None and torch.device(device).type == "cpu":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    name, _, limit = smi.partition(",")
    return {"platform": "gpu", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi_name": name.strip(),
            "power_limit": limit.strip(), "torch": torch.__version__, "cuda": torch.version.cuda}
