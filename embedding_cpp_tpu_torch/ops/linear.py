"""Linear (dense / quantized) projection dispatch.

`linear()` hides the weight representation from the model code, in the
order of the JAX package's Pallas path (ops/linear.py): a QTensor weight
goes through the fused dequant-matmul kernel (`q4_matmul`, K1 or K8 as its
route says), which takes the gated FFN's `prologue_mul` on its loaded x
tiles and the bias and the activation in its f32 epilogue; the result is
cast to the activation dtype, the residual is added in that dtype, and the
LayerNorm tail runs in f32.  The residual and LayerNorm stay outside the
kernel although `q4_matmul` can fuse them (K1's epilogue): the JAX
package's linear composes them outside its kernel too (ops/linear.py:84-94),
and a residual added in f32 inside the kernel rounds differently in bf16
from one added in the activation dtype.  A dense weight takes a plain matmul with f32
accumulation (after the prologue multiply in the activation dtype), the
bias in f32, then the cast and the activation; in bf16 on the card that
matmul runs on the tensor cores with an f32 output (`weight_mode="dequant"`
puts every linear there).

Under tensor parallelism (`parallel.group.current_tp()` set), a
row-parallel linear (`row_parallel=True`: o and down, whose K is split over
the tp slots) keeps its f32 partial product, K1 with `out_f32` and no
bias or epilogue for a quantized weight, sums it over the slots
(`all_reduce`), and only then adds the bias, once, applies the activation
on the cast and the residual and LayerNorm tail, in the JAX package's order
(ops/linear.py:95-113): a bf16 round before the sum would degrade it.  The
column-parallel q/k/v/up/gate keep K1's fused bias / GELU / prologue.

While a profiler records, the product with its bias, activation and cast
runs in the range `op.linear`, the residual add in `op.residual` and the
LayerNorm in `op.norm` (`utils/metrics.op_range`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.group import current_tp
from ..utils.metrics import in_op_range, op_range
from .q4_matmul import prologue, q4_matmul
from .qtensor import QTensor


@in_op_range("op.norm")
def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float, out_dtype) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * scale + bias, computed in f32."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(out_dtype)


def _activate(y: torch.Tensor, activation: str | None) -> torch.Tensor:
    if activation is None:
        return y
    if activation == "gelu_erf":
        return F.gelu(y)
    if activation == "gelu_tanh":
        return F.gelu(y, approximate="tanh")
    if activation == "silu":
        return F.silu(y)
    raise ValueError(f"unknown activation {activation!r}")


def _f32_product(x: torch.Tensor, w, prologue_mul: torch.Tensor | None) -> torch.Tensor:
    """(x [* prologue_mul]) @ w [..., N] in f32, no bias: K1 with `out_f32`
    for a quantized weight, a matmul with f32 accumulation for a dense one."""
    lead = x.shape[:-1]
    if isinstance(w, QTensor):
        return q4_matmul(x.reshape(-1, x.shape[-1]), w, out_f32=True,
                         prologue_mul=None if prologue_mul is None
                         else prologue_mul.reshape(-1, x.shape[-1])).reshape(*lead, -1)
    xx = prologue(x, prologue_mul)
    if xx.is_cuda and x.dtype == torch.bfloat16:
        # bf16 products summed in f32 on the tensor cores, f32 out
        return torch.mm(xx.reshape(-1, xx.shape[-1]), w.to(x.dtype),
                        out_dtype=torch.float32).reshape(*lead, -1)
    return torch.matmul(xx.to(torch.float32), w.to(x.dtype).to(torch.float32))


def linear(x: torch.Tensor, w, b: torch.Tensor | None = None, *,
           activation: str | None = None, residual: torch.Tensor | None = None,
           ln: tuple | None = None,
           prologue_mul: torch.Tensor | None = None,
           row_parallel: bool = False) -> torch.Tensor:
    """y = act((x [* prologue_mul]) @ w + b) [+ residual] [-> LayerNorm].
    x, prologue_mul: [..., K]; w: [K, N] dense or QTensor; b: [N]; ln:
    (scale [N], bias [N], eps).  `row_parallel`: w holds this tp slot's
    rows of K, so under a tp group the partial products are summed first."""
    dtype = x.dtype
    lead = x.shape[:-1]
    tp = current_tp() if row_parallel else None
    with op_range("op.linear"):
        if tp is not None:
            y = tp.all_reduce(_f32_product(x, w, prologue_mul))
            if b is not None:
                y = y + b.to(torch.float32)
            y = _activate(y.to(dtype), activation)
        elif isinstance(w, QTensor):
            y = q4_matmul(x.reshape(-1, x.shape[-1]), w, bias=b, activation=activation,
                          prologue_mul=None if prologue_mul is None
                          else prologue_mul.reshape(-1, x.shape[-1]))
            y = y.reshape(*lead, -1).to(dtype)
        else:
            y = _f32_product(x, w, prologue_mul)
            if b is not None:
                y = y + b.to(torch.float32)
            y = _activate(y.to(dtype), activation)
    if residual is not None:
        with op_range("op.residual"):
            y = y + residual
    if ln is not None:
        y = layer_norm(y, ln[0], ln[1], ln[2], dtype)
    return y
