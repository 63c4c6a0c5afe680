"""Which version of a kernel a call runs: the hand-written CUDA kernel or
its plain PyTorch version.

Two families, each with a choice of "auto" | "kernel" | "plain": "q4" (the
fused dequant-matmul K1 / K8) and "attn" (every attention kernel: K2-K7,
K9/K10).  "auto" launches the kernel for a CUDA tensor and runs the plain
version for a CPU tensor; "plain" runs the plain version on any device, as
the caller's choice; "kernel" launches the kernel and raises for a CPU
tensor.  A forward sets the choice for every call it makes with
`kernel_impls` (models/bert.py's entry points do, from `ComputeOptions`),
so the switch reaches each kernel wrapper the forward reaches; outside
such a block every call is "auto".

A kernel built for a set of shapes (the attention bodies' head dims) is
asked whether it serves the call's shape before any launch: where it does
not, "auto" runs the plain version on any device and counts the call in
the wrapper's `plain_routes` (so a run shows the route, the CPU's as the
card's), and "kernel" raises.

Every wrapper counts its launches through `count`, under one lock, so the
counts stay exact when a mesh's shard threads launch at the same time.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading

import torch

IMPLS = ("auto", "kernel", "plain")
_CHOICE: contextvars.ContextVar[tuple[str, str]] = contextvars.ContextVar(
    "kernel_impls", default=("auto", "auto"))


_COUNT_LOCK = threading.Lock()


def count(fn, attr: str = "launches") -> None:
    """Add one launch to the counter `attr` of the wrapper `fn`."""
    with _COUNT_LOCK:
        setattr(fn, attr, getattr(fn, attr) + 1)


def check_impl(what: str, impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"{what} {impl!r} not in {IMPLS}")


@contextlib.contextmanager
def kernel_impls(q4: str = "auto", attn: str = "auto"):
    """Within the block, the q4 and attention wrappers run as `q4` / `attn`
    say."""
    check_impl("q4_impl", q4)
    check_impl("attn_impl", attn)
    token = _CHOICE.set((q4, attn))
    try:
        yield
    finally:
        _CHOICE.reset(token)


def use_kernel(t: torch.Tensor, family: str, name: str, fn=None, served: bool = True) -> bool:
    """Whether the wrapper `name` of `family` ("q4" | "attn") launches its
    kernel on `t`: False for the plain version; raises for "kernel" on a
    CPU tensor and for a device that is neither.  `served` False (no
    kernel instance for the call's shape): "auto" gives False and counts
    the call in `fn.plain_routes`, "kernel" raises."""
    impl = _CHOICE.get()[0 if family == "q4" else 1]
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if not served:
        if impl == "kernel":
            raise ValueError(f"{name}: impl 'kernel' has no instance for this shape "
                             f"{tuple(t.shape)}")
        if impl == "auto":
            count(fn, "plain_routes")
        return False
    if t.device.type == "cpu":
        if impl == "kernel":
            raise ValueError(f"{name}: impl 'kernel' needs a CUDA tensor, got one on the CPU")
        return False
    return impl != "plain"
