"""What the per-layer readers share: the layer a device operation belongs
to, by its kernel's name (the port launches its hand-written kernels
through ctypes, so no PyTorch op encloses them and the profiler's
correlation names none), and the card's peaks."""
from __future__ import annotations

from perfbench.peaks import peaks_for

# csrc/q4_matmul.cu: q4_matmul_tc_kernel (K1, K8), q4_matmul_f32_kernel,
# q4_matmul_2d_f32_kernel
LINEAR_PATTERNS = ("q4_matmul",)
# csrc/attention_bse.cu, attention_long.cu, attention_headpack.cu,
# deberta_attention.cu: attn_bse_*, attn_long_*, attn_headpack_*, deberta_attn_*
ATTENTION_PATTERNS = ("attn_",)


def is_linear(name: str) -> bool:
    return any(p in name for p in LINEAR_PATTERNS)


def is_attention(name: str) -> bool:
    return any(p in name for p in ATTENTION_PATTERNS) and not is_linear(name)


def peaks(run) -> tuple[float, float] | None:
    """The card's (bytes/s, flop/s); None off the card (a CPU run has no
    roofline)."""
    return None if run.device == "cpu" else peaks_for(run.card)


def idle_share(run) -> float | None:
    s = run.slice
    if s is None or not s.kernels or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def slot_occupancy(run) -> float | None:
    padded = run.counter_delta("padded_slots")
    return 100.0 * run.counter_delta("tokens") / padded if padded > 0 else None
