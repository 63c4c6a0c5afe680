"""Fused quantized dequant + matmul (Q4_0 / Q4_1 / Q8_0): the CUDA kernel's
wrapper and its plain PyTorch version.

Kernel: `csrc/q4_matmul.cu`, the Hopper port of the TPU kernel
`_q4_matmul_1d` (embedding_cpp_tpu/ops/q4_matmul.py): y = act((x [* g]) @
dequant(W) + bias), the epilogue in f32 on the accumulator, then one cast.
The optional prologue multiplicand g ([M, K], the gated FFN's gate) scales
the loaded x tile before the product, rounded to x's dtype as the TPU
kernel's `x_ref[:] * g_ref[:]` rounds it.  The weight
stays packed 4- or 8-bit in device memory and is dequantized on chip, 32
rows at a time, exactly as the TPU kernel's `_dequant_tile` does it.  bf16
activations run on the tensor cores with f32 accumulation; f32 activations
run f32 FMAs (no TF32).  What bounds it on an H100 and what the first
version does about it is noted in the source.

`q4_matmul` launches the kernel for a CUDA tensor and runs
`q4_matmul_plain`, which repeats the kernel's arithmetic step by step, only
for a tensor on the CPU.  `q4_matmul.launches` counts kernel launches,
`q4_matmul.prologue_launches` those of them with a prologue multiplicand.
"""
from __future__ import annotations

import ctypes

import torch

from ..gguf.constants import QK4, GGMLType
from ._build import check, load
from .qtensor import QUANT_TYPES, QTensor

ACTIVATIONS = (None, "gelu_erf", "gelu_tanh", "silu")
_QTYPE_CODE = {GGMLType.Q4_0: 0, GGMLType.Q4_1: 1, GGMLType.Q8_0: 2}


def dequant_weight(w: QTensor, dtype) -> torch.Tensor:
    """[K, N] weight as the kernel stages it: f32 math, one rounding to
    `dtype` (the TPU kernel's `_dequant_tile`)."""
    if w.qtype == GGMLType.Q8_0:
        k, n = w.qs.shape
        q = w.qs.reshape(k // QK4, QK4, n).to(torch.float32)
        y = q * w.scales.reshape(k // QK4, 1, n)
        return y.reshape(k, n).to(dtype)
    half_k, n = w.qs.shape
    nb = half_k * 2 // QK4
    b = w.qs.reshape(nb, QK4 // 2, n).to(torch.int32)
    q = torch.cat([b & 0x0F, b >> 4], dim=1).to(torch.float32)
    s = w.scales.reshape(nb, 1, n)
    if w.qtype == GGMLType.Q4_0:
        y = (q - 8.0) * s
    else:
        y = q * s + w.mins.reshape(nb, 1, n)
    return y.reshape(half_k * 2, n).to(dtype)


def epilogue(y: torch.Tensor, bias: torch.Tensor | None,
             activation: str | None) -> torch.Tensor:
    """bias add, then the activation, in f32 (the TPU kernel's `_epilogue`
    without the residual/LayerNorm tail)."""
    if bias is not None:
        y = y + bias.to(torch.float32)
    if activation == "gelu_erf":
        y = 0.5 * y * (1.0 + torch.erf(y * 2.0**-0.5))
    elif activation == "gelu_tanh":
        c = (2.0 / 3.141592653589793) ** 0.5
        y = 0.5 * y * (1.0 + torch.tanh(c * (y + 0.044715 * y * y * y)))
    elif activation == "silu":
        y = y / (1.0 + torch.exp(-y))
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return y


def prologue(x: torch.Tensor, g: torch.Tensor | None) -> torch.Tensor:
    """x * g rounded once to x's dtype (exact in f32 for two bf16 inputs,
    so one rounding equals the TPU's bf16 multiply)."""
    if g is None:
        return x
    return (x.to(torch.float32) * g.to(torch.float32)).to(x.dtype)


def q4_matmul_plain(x: torch.Tensor, w: QTensor, bias=None, activation=None,
                    out_f32: bool = False,
                    prologue_mul: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: the prologue multiply,
    bf16 (or f32) products accumulated in f32, f32 epilogue, one cast."""
    wd = dequant_weight(w, x.dtype)
    y = torch.matmul(prologue(x, prologue_mul).to(torch.float32), wd.to(torch.float32))
    y = epilogue(y, bias, activation)
    return y if out_f32 else y.to(x.dtype)


def _lib():
    fn = load("q4_matmul.cu").q4_matmul_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check_args(x: torch.Tensor, w: QTensor, activation, prologue_mul) -> None:
    if w.qtype not in QUANT_TYPES:
        raise ValueError(f"not a quantized tensor: {w.qtype}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    k = x.shape[1]
    if k % QK4:
        raise ValueError(f"K = {k} is not a multiple of {QK4}")
    if (k, w.qs.shape[-1]) != tuple(w.shape) or w.qs.dim() != 2:
        raise ValueError(f"x {tuple(x.shape)} does not match weight {w.shape}")
    if prologue_mul is not None and prologue_mul.shape != x.shape:
        raise ValueError(f"prologue_mul {tuple(prologue_mul.shape)} != x {tuple(x.shape)}")


def q4_matmul(x: torch.Tensor, w: QTensor, bias: torch.Tensor | None = None,
              activation: str | None = None, out_f32: bool = False,
              prologue_mul: torch.Tensor | None = None) -> torch.Tensor:
    """(x [M, K] [* prologue_mul [M, K]]) @ packed w [K, N] -> act(. +
    bias) [M, N] in x.dtype (f32 with `out_f32`).  CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    _check_args(x, w, activation, prologue_mul)
    if x.device.type == "cpu":
        return q4_matmul_plain(x, w, bias, activation, out_f32, prologue_mul)
    if x.device.type != "cuda":
        raise ValueError(f"q4_matmul: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q4_matmul: x dtype {x.dtype} (bf16 or f32 only)")
    fields = [w.qs, w.scales] + ([] if w.mins is None else [w.mins])
    if any(t.device != x.device for t in fields):
        raise ValueError("q4_matmul: weight and x on different devices")
    if any(t.dtype != torch.float32 for t in fields[1:]):
        raise ValueError("q4_matmul: scales/mins must be f32")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    g = None
    if prologue_mul is not None:
        if prologue_mul.device != x.device or prologue_mul.dtype != x.dtype:
            raise ValueError("q4_matmul: prologue_mul must match x's device and dtype")
        g = prologue_mul.contiguous()
        if g.data_ptr() % 16:
            g = g.clone()
    qs, scales = w.qs.contiguous(), w.scales.contiguous()
    mins = None if w.mins is None else w.mins.contiguous()
    if bias is not None:
        bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
        if bias.shape != (w.shape[1],):
            raise ValueError(f"bias shape {tuple(bias.shape)} != ({w.shape[1]},)")
    m, k = x.shape
    n = w.shape[1]
    f32_out = out_f32 or x.dtype == torch.float32
    out = torch.empty((m, n), device=x.device,
                      dtype=torch.float32 if f32_out else x.dtype)
    if m == 0:
        return out
    err = _lib()(
        x.data_ptr(), None if g is None else g.data_ptr(),
        int(x.dtype == torch.bfloat16), qs.data_ptr(),
        scales.data_ptr(), None if mins is None else mins.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        int(f32_out), m, k, n, _QTYPE_CODE[w.qtype],
        ACTIVATIONS.index(activation),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(err, "q4_matmul_launch")
    q4_matmul.launches += 1
    if g is not None:
        q4_matmul.prologue_launches += 1
    return out


q4_matmul.launches = 0
q4_matmul.prologue_launches = 0  # the launches that multiplied in a prologue
