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

The residual add and the LayerNorm are one pass (`layer_norm` with its
`residual`): on the card one launch of `csrc/layer_norm.cu`, which rounds
the sum to the activation dtype, as a separate add does, before the f32
statistics; on the CPU, and where the forward chose the plain versions
(`q4_impl="plain"`, ops/dispatch.py), its plain version
`layer_norm_plain`: the add, then the f32 LayerNorm in PyTorch.  On the
card an operand the kernel has no instance for raises (a dtype other than
bf16 / f32, a residual of another shape or dtype), but for rows past
`LN_MAX_WIDTH`, which "auto" sends to the plain version.  A residual
without a LayerNorm stays a plain add.  Counters: `layer_norm.launches`
(kernel launches) and `layer_norm.plain_calls` (calls "auto" sent to the
plain version for their width, on any device).

While a profiler records, the product with its bias, activation and cast
runs in the range `op.linear`, a residual add alone in `op.residual` and
the LayerNorm, with its residual, in `op.norm` (`utils/metrics.op_range`).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..parallel.group import current_tp
from ..utils.metrics import in_op_range, op_range
from ._build import check, load
from .dispatch import count, use_kernel
from .q4_matmul import prologue, q4_matmul
from .qtensor import QTensor

# csrc/layer_norm.cu holds a row in one warp's registers (kMaxWidth):
# wider rows have no instance.
LN_MAX_WIDTH = 2048
_LN_DTYPES = (torch.bfloat16, torch.float32)


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None,
                     eps: float, out_dtype, residual: torch.Tensor | None = None) -> torch.Tensor:
    """[(x + residual) in x's dtype, then] (x - mean) / sqrt(var + eps) *
    scale [+ bias], computed in f32, one cast to `out_dtype`."""
    if residual is not None:
        with op_range("op.residual"):
            x = x + residual
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def _ln_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """t as [M, n] rows whose last dim is contiguous (a view where one
    exists, else a copy)."""
    rows = t.reshape(-1, n)
    return rows if rows.stride(-1) == 1 else rows.contiguous()


def _ln_param(t, n: int, device, what: str) -> torch.Tensor:
    """A [n] parameter as the kernel reads it: f32, contiguous."""
    if not isinstance(t, torch.Tensor) or t.numel() != n or t.device != device:
        raise ValueError(f"layer_norm: {what} must be a tensor of {n} elements on {device}, "
                         f"got {t if not isinstance(t, torch.Tensor) else (t.shape, t.device)}")
    return t.reshape(n).to(torch.float32).contiguous()


_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_LN_ARGTYPES = [_P, _P, _L, _L, _P, _P, _F, _P, _I, _I, _I, _I, _P]


def _layer_norm_kernel(x: torch.Tensor, scale, bias, eps: float, out_dtype,
                       residual) -> torch.Tensor:
    """One launch of csrc/layer_norm.cu (rows of at most LN_MAX_WIDTH);
    raises for operands it has no instance for."""
    n = x.shape[-1]
    if x.dtype not in _LN_DTYPES or out_dtype not in _LN_DTYPES:
        raise ValueError(f"layer_norm: no kernel instance for {x.dtype} -> {out_dtype} "
                         f"(bf16 / f32 in and out)")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device):
        raise ValueError(f"layer_norm: the residual {tuple(residual.shape)} {residual.dtype} "
                         f"on {residual.device} differs from x {tuple(x.shape)} {x.dtype}")
    sc = _ln_param(scale, n, x.device, "scale")
    bt = None if bias is None else _ln_param(bias, n, x.device, "bias")
    xr = _ln_rows(x, n)
    rr = None if residual is None else _ln_rows(residual, n)
    m = xr.shape[0]
    if m >= 2**31:
        raise ValueError(f"layer_norm: {m} rows, past the kernel's 2^31")
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    fn = load("layer_norm.cu").layer_norm_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _LN_ARGTYPES, _I
    check(fn(xr.data_ptr(), None if rr is None else rr.data_ptr(), xr.stride(0),
             0 if rr is None else rr.stride(0), sc.data_ptr(),
             None if bt is None else bt.data_ptr(), float(eps), out.data_ptr(),
             int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), m, n,
             torch.cuda.current_stream(x.device).cuda_stream), "layer_norm_launch")
    count(layer_norm)
    return out


@in_op_range("op.norm")
def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None, eps: float,
               out_dtype, residual: torch.Tensor | None = None) -> torch.Tensor:
    """[(x + residual) in x's dtype, then] (x - mean) / sqrt(var + eps) *
    scale [+ bias] in f32, cast to `out_dtype`: one pass of the kernel on
    the card, the plain version on the CPU.  The q4 choice of
    ops/dispatch.py picks the version: under "auto" rows past LN_MAX_WIDTH
    take the plain version, counted in `layer_norm.plain_calls`; under
    "kernel" they raise."""
    n = x.shape[-1]
    if use_kernel(x, "q4", "layer_norm", layer_norm, served=0 < n <= LN_MAX_WIDTH,
                  counter="plain_calls"):
        return _layer_norm_kernel(x, scale, bias, eps, out_dtype, residual)
    return layer_norm_plain(x, scale, bias, eps, out_dtype, residual)


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
    if ln is not None:
        return layer_norm(y, ln[0], ln[1], ln[2], dtype, residual=residual)
    if residual is not None:
        with op_range("op.residual"):
            y = y + residual
    return y


layer_norm.launches = 0
layer_norm.plain_calls = 0  # "auto" calls with rows past LN_MAX_WIDTH (plain version)
