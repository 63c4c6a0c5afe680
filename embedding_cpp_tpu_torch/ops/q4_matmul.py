"""Fused quantized dequant + matmul (Q4_0 / Q4_1 / Q8_0): the route, the
CUDA kernels' wrappers and their plain PyTorch version.

Kernels, both in `csrc/q4_matmul.cu`, the Hopper ports of the two TPU
kernels of embedding_cpp_tpu/ops/q4_matmul.py:

- K1 (`_q4_matmul_1d`, the TPU's 1-D kernel): y = act((x [* g]) @
  dequant(W) + bias), the epilogue in f32 on the accumulator, then one
  cast.  With `residual` and/or `ln` the same bodies add the residual in
  f32 and apply the LayerNorm over whole rows before the cast (the TPU
  kernel's `residual` / `ln_sb` epilogue): the N tiles of each row run as
  one thread-block cluster that sums the row statistics across its blocks
  (`ln_tile` names the instance).  Rows wider than one cluster holds take
  K1 into f32 and the same tail in plain PyTorch (the split route).
- K8 (`_q4_matmul_2d`, the TPU's N-tiled kernel): the same y without the
  residual/LayerNorm tail.

bf16 x, in both: one tile kernel, output tiles streamed over K in 64-deep
steps through a ring of asynchronous copies, each step's packed weight tile
dequantized once in shared memory for the tile's rows.  K8 runs its 256 x
128 instance; K1 the instance `k1_tile` chooses for its shape from
`TC_TILES` (`tile` reads an instance's layout on the card).  f32 x: K1
stages one quant block of the weight at a time; K8 holds one column slice
of the dequantized weight in shared memory for all the M tiles it walks
(`slice_width`).

The optional prologue multiplicand g ([M, K], the gated FFN's gate) scales
the loaded x tile before the product, rounded to x's dtype as the TPU
kernel's `x_ref[:] * g_ref[:]` rounds it.  The weight stays packed 4- or
8-bit in device memory and is dequantized on chip exactly as the TPU
kernel's `_dequant_tile` does it.  bf16 activations run on the tensor cores
with f32 accumulation; f32 activations run f32 FMAs (no TF32).

`q4_matmul` routes each call as the JAX package's `q4_matmul` does
(`route`): the 1-D kernel with the largest M tile whose TPU working set fits
12 MiB, else the N-tiled kernel.  Where the JAX package falls back to XLA
for a shape its kernels do not tile, the port launches K1, which takes
ragged M and N and computes the same function.  Where it composes the
residual/LayerNorm tail in f32 because the weight is too large for its 1-D
kernel, the port runs K8 into f32 and the same tail in plain PyTorch.

The launchers `_q4_matmul_1d` / `_q4_matmul_2d` launch their kernel for a
CUDA tensor and run the plain version, which repeats the kernels'
arithmetic step by step, for a tensor on the CPU, or where the forward
chose it (`q4_impl="plain"`, ops/dispatch.py).  K1 and K8 compute
one function, so `q4_matmul_plain` is the plain version of both.  Launch
counts: `q4_matmul.launches` (K1, both forms), `q4_matmul.prologue_launches`
(those with a prologue multiplicand), `q4_matmul.ln_launches` (K1 with the
residual/LayerNorm epilogue), `q4_matmul.ln_split_launches` (calls with that
tail that took the split route: one K1 launch each), `q4_matmul.n_tiled_launches`
(K8).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..gguf.constants import QK4, GGMLType
from ._build import check, load
from .dispatch import count, use_kernel
from .qtensor import QUANT_TYPES, QTensor

ACTIVATIONS = (None, "gelu_erf", "gelu_tanh", "silu")
_QTYPE_CODE = {GGMLType.Q4_0: 0, GGMLType.Q4_1: 1, GGMLType.Q8_0: 2}
# the TPU 1-D kernel's working-set budget and M tiles (q4_matmul.py:432-441)
VMEM_BUDGET = 12 * 1024 * 1024
_TM_1D = (2048, 1024, 512, 256, 128, 64, 32, 16, 8)

# The bf16 tile kernel's instances, as `TC_TILES` in csrc/q4_matmul.cu names
# them: (bm, bn) -> the blocks per SM each is built for.  K8 runs K8_TILE.
TC_TILES = {(256, 128): 1, (128, 64): 2}
K8_TILE = (256, 128)
# Outputs per SM per unit time of each instance over whole waves, relative
# to 256 x 128, from the card's times at K1's shapes (PERF.md).
_TILE_RATE = {(256, 128): 1.0, (128, 64): 0.72}
# The bf16 instances K1's residual + LayerNorm epilogue runs: those of
# TC_TILES and of `LN_ONLY_TILES` (csrc/q4_matmul.cu), by blocks per SM;
# the f32 epilogue's column tiles (the SIMT kernel's FBN).
LN_TILES = {**TC_TILES, (128, 256): 1}
LN_F32_WIDTHS = (64, 256)
LN_MAX_CLUSTER = 16  # Hopper's widest thread-block cluster (non-portable)


class Route(NamedTuple):
    """The JAX package's choice for one call: `kernel` is "1d"
    (`_q4_matmul_1d` with M tile `tm`), "2d" (`_q4_matmul_2d` with tiles
    `tm`, `tn`), "composed" (XLA, because a residual/LayerNorm tail meets a
    weight too large for the 1-D kernel) or "xla" (a shape its kernels do
    not tile)."""

    kernel: str
    tm: int = 0
    tn: int = 0


def _pick_tile(dim: int, candidates: tuple[int, ...]) -> int:
    return next((c for c in candidates if dim % c == 0 and c <= dim), dim)


def route(m: int, k: int, n: int, qtype: GGMLType, dtype: torch.dtype, *,
          prologue: bool = False, residual: bool = False, ln: bool = False) -> Route:
    """The JAX `q4_matmul`'s dispatch (q4_matmul.py:383-466) for x [m, k]
    of `dtype` times a [k, n] weight of `qtype`, with its VMEM estimate
    term for term."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    sublane = 16 if dtype == torch.bfloat16 else 8
    qk_rows = k if qtype == GGMLType.Q8_0 else k // 2

    def vmem_est(tm: int) -> int:
        return (k * n * itemsize
                + 2 * tm * (k + n) * itemsize
                + (2 * tm * n * itemsize if residual else 0)
                + (2 * tm * k * itemsize if prologue else 0)
                + qk_rows * n
                + (k // QK4) * n * 4 * (2 if qtype == GGMLType.Q4_1 else 1))

    candidates = [c for c in _TM_1D if c <= m and m % c == 0 and c % sublane == 0]
    if not candidates or k % QK4 or n % 128:
        return Route("xla")
    tm = next((c for c in candidates if vmem_est(c) <= VMEM_BUDGET), 0)
    if tm:
        return Route("1d", tm)
    if residual or ln:
        return Route("composed")
    tn = _pick_tile(n, (512, 384, 256, 128))
    if n % tn:
        return Route("xla")
    return Route("2d", _pick_tile(m, (256, 128, 64, 32, 16, 8)), tn)


def k1_tile(m: int, k: int, n: int, sms: int) -> tuple[int, int]:
    """K1's bf16 instance (bm, bn) for x [m, k] times a [k, n] weight on a
    card of `sms` SMs: the one whose grid finishes first, counting whole
    waves of `sms` * blocks-per-SM tiles, each wave the time one SM takes
    for its tiles at the instance's rate.  K does not enter: the card
    ranked the instances alike at every K of the models."""
    def cost(t: tuple[int, int]) -> float:
        bm, bn = t
        tiles = -(-m // bm) * -(-n // bn)
        waves = -(-tiles // (sms * TC_TILES[t]))
        return waves * bm * bn * TC_TILES[t] / _TILE_RATE[t]

    return min(TC_TILES, key=cost)


def ln_tile(m: int, k: int, n: int, x_bf16: bool, sms: int,
            cap=lambda tile: LN_MAX_CLUSTER) -> tuple[int, int] | None:
    """The instance (bm, bn) of K1's LayerNorm epilogue for x [m, k]
    times a [k, n] weight: its ceil(n / bn) N tiles of a row form one
    cluster, which must not pass `cap(tile)` blocks (the card's widest for
    that instance).  f32 x: (0, the narrowest width of LN_F32_WIDTHS that
    fits).  bf16 x: `k1_tile`'s instance where it fits, else the fitting
    instance with the widest tile.  None where none fits: the split route."""
    if not x_bf16:
        return next(((0, w) for w in LN_F32_WIDTHS if -(-n // w) <= cap((0, w))), None)
    fits = [t for t in LN_TILES if -(-n // t[1]) <= cap(t)]
    if not fits:
        return None
    k1 = k1_tile(m, k, n, sms)
    return k1 if k1 in fits else max(fits, key=lambda t: (t[1], t[0]))


def dequant_weight(w: QTensor, dtype) -> torch.Tensor:
    """[K, N] weight as the kernels stage it: f32 math, one rounding to
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
    """bias add, then the activation, in f32 (the head of the TPU kernel's
    `_epilogue`)."""
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


def ln_tail(y: torch.Tensor, residual: torch.Tensor | None,
            ln: tuple | None) -> torch.Tensor:
    """The tail of the TPU kernel's `_epilogue` on f32 rows: the residual
    added in f32, then (y - mean) * rsqrt(var + eps) * scale + bias with the
    row statistics in f32."""
    if residual is not None:
        y = y + residual.to(torch.float32)
    if ln is not None:
        mean = y.mean(dim=-1, keepdim=True)
        var = torch.square(y - mean).mean(dim=-1, keepdim=True)
        y = (y - mean) * torch.rsqrt(var + float(ln[2]))
        y = y * ln[0].to(torch.float32) + ln[1].to(torch.float32)
    return y


def prologue(x: torch.Tensor, g: torch.Tensor | None) -> torch.Tensor:
    """x * g rounded once to x's dtype (exact in f32 for two bf16 inputs,
    so one rounding equals the TPU's bf16 multiply)."""
    if g is None:
        return x
    return (x.to(torch.float32) * g.to(torch.float32)).to(x.dtype)


def q4_matmul_plain(x: torch.Tensor, w: QTensor, bias=None, activation=None,
                    residual: torch.Tensor | None = None, ln: tuple | None = None,
                    out_f32: bool = False,
                    prologue_mul: torch.Tensor | None = None) -> torch.Tensor:
    """The kernels' arithmetic in plain PyTorch (K1's, with its epilogue,
    and K8's, which computes the same function): the prologue multiply,
    bf16 (or f32) products accumulated in f32, the f32 epilogue (bias,
    activation, residual, LayerNorm), one cast."""
    wd = dequant_weight(w, x.dtype)
    y = torch.matmul(prologue(x, prologue_mul).to(torch.float32), wd.to(torch.float32))
    y = ln_tail(epilogue(y, bias, activation), residual, ln)
    return y if out_f32 else y.to(x.dtype)


def _fn(entry: str, argtypes: list):
    fn = getattr(load("q4_matmul.cu"), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int


def _check_args(x: torch.Tensor, w: QTensor, activation, prologue_mul,
                residual=None, ln=None) -> None:
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
    n = w.shape[1]
    if residual is not None and tuple(residual.shape) != (x.shape[0], n):
        raise ValueError(f"residual {tuple(residual.shape)} != ({x.shape[0]}, {n})")
    if ln is not None and (len(ln) != 3 or ln[0].shape != (n,) or ln[1].shape != (n,)):
        raise ValueError(f"ln must be (scale [{n}], bias [{n}], eps)")


def _operand(t: torch.Tensor, x: torch.Tensor, what: str) -> torch.Tensor:
    """`t` as the kernel reads it: x's device and dtype, contiguous, 16-byte
    aligned."""
    if t.device != x.device or t.dtype != x.dtype:
        raise ValueError(f"q4_matmul: {what} must match x's device and dtype")
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _cuda_args(x: torch.Tensor, w: QTensor, bias, prologue_mul, out_f32: bool,
               activation, residual=None, ln=None):
    """Checks a CUDA call and returns (x, g, bias, out, f32_out, the
    weight's (qs, scales, mins)) as the kernels read them."""
    _check_args(x, w, activation, prologue_mul, residual, ln)
    if x.device.type != "cuda":
        raise ValueError(f"q4_matmul: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q4_matmul: x dtype {x.dtype} (bf16 or f32 only)")
    fields = [w.qs, w.scales] + ([] if w.mins is None else [w.mins])
    if any(t.device != x.device for t in fields):
        raise ValueError("q4_matmul: weight and x on different devices")
    if any(t.dtype != torch.float32 for t in fields[1:]):
        raise ValueError("q4_matmul: scales/mins must be f32")
    n = w.shape[1]
    if bias is not None:
        bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
        if bias.shape != (n,):
            raise ValueError(f"bias shape {tuple(bias.shape)} != ({n},)")
    x = _operand(x, x, "x")
    g = None if prologue_mul is None else _operand(prologue_mul, x, "prologue_mul")
    f32_out = out_f32 or x.dtype == torch.float32
    out = torch.empty((x.shape[0], n), device=x.device,
                      dtype=torch.float32 if f32_out else x.dtype)
    weight = (w.qs.contiguous(), w.scales.contiguous(),
              None if w.mins is None else w.mins.contiguous())
    return x, g, bias, out, int(f32_out), weight


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _ln_cluster_cap(index: int, x_bf16: bool, tile: tuple[int, int], prologue: bool) -> int:
    """The widest cluster of the LN epilogue's instance `tile` the card
    `index` schedules (at most LN_MAX_CLUSTER)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        check(_fn("q4_matmul_ln_cluster_cap", [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)])(
            int(x_bf16), tile[0], tile[1], int(prologue), ctypes.byref(out)),
            "q4_matmul_ln_cluster_cap")
    return out.value


def ln_active_clusters(x_bf16: bool, tile: tuple[int, int], cluster: int,
                       prologue: bool = False) -> int:
    """How many clusters of `cluster` blocks of the LN epilogue's instance
    `tile` the current card runs at once (builds the kernels' library)."""
    out = ctypes.c_int(0)
    check(_fn("q4_matmul_ln_active_clusters", [_I, _I, _I, _I, _I,
                                               ctypes.POINTER(ctypes.c_int)])(
        int(x_bf16), tile[0], tile[1], int(prologue), cluster, ctypes.byref(out)),
        "q4_matmul_ln_active_clusters")
    return out.value


def _q4_matmul_1d(x: torch.Tensor, w: QTensor, bias=None, residual=None, ln=None,
                  prologue_mul=None, *, activation=None, out_f32: bool = False,
                  tile: tuple[int, int] | None = None) -> torch.Tensor:
    """K1: bf16 x runs the tile kernel at `k1_tile`'s instance for this
    shape (`tile` forces another of `TC_TILES`; the launch refuses one the
    source does not name), f32 x the SIMT kernel.  With `residual` / `ln`
    ((scale [N], bias [N], eps)) the same bodies apply that tail before
    their one cast, at `ln_tile`'s instance (`tile` forces one of LN_TILES,
    or (0, width) in f32); with `ln`, rows too wide for one cluster take
    K1 into f32 and `ln_tail` (counted in `ln_split_launches`)."""
    if not use_kernel(x, "q4", "q4_matmul"):
        return q4_matmul_plain(x, w, bias, activation, residual, ln, out_f32, prologue_mul)
    x, g, bias, out, f32_out, (qs, scales, mins) = _cuda_args(
        x, w, bias, prologue_mul, out_f32, activation, residual, ln)
    if x.shape[0] == 0:
        return out
    m, k = x.shape
    n = w.shape[1]
    bf16 = x.dtype == torch.bfloat16
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    common = (_ptr(x), _ptr(g), int(bf16), _ptr(qs), _ptr(scales), _ptr(mins), _ptr(bias))
    if residual is None and ln is None:
        if bf16 and tile is None:
            tile = k1_tile(m, k, n, _sms(index))
        bm, bn = tile or (0, 0)
        err = _fn("q4_matmul_launch", [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                       _I, _I, _P])(
            *common, _ptr(out), f32_out, m, k, n, _QTYPE_CODE[w.qtype],
            ACTIVATIONS.index(activation), bm, bn, stream)
        check(err, "q4_matmul_launch")
    else:
        def cap(t):
            return _ln_cluster_cap(index, bf16, t, g is not None)

        if ln is None:  # the residual alone needs no whole rows: no cluster
            tile = tile or (k1_tile(m, k, n, _sms(index)) if bf16 else (0, LN_F32_WIDTHS[0]))
        elif tile is None:
            tile = ln_tile(m, k, n, bf16, _sms(index), cap)
            if tile is None:  # past one cluster: K1 into f32, the f32 tail, one cast
                y = _q4_matmul_1d(x, w, bias, prologue_mul=g, activation=activation,
                                  out_f32=True)
                count(q4_matmul, "ln_split_launches")
                y = ln_tail(y, residual, ln)
                return y if f32_out else y.to(x.dtype)
        elif -(-n // tile[1]) > cap(tile):
            raise ValueError(f"q4_matmul: rows of {n} need {-(-n // tile[1])} blocks of "
                             f"{tile}, past the {cap(tile)} of one cluster")
        res = None if residual is None else _operand(residual, x, "residual")
        ln_sb = eps = None
        if ln is not None:
            ln_sb = torch.stack([ln[0], ln[1]]).to(device=x.device, dtype=torch.float32)
            eps = float(ln[2])
        err = _fn("q4_matmul_ln_launch", [_P, _P, _I, _P, _P, _P, _P, _P, _P, ctypes.c_float,
                                          _P, _I, _I, _I, _I, _I, _I, _I, _I, _P])(
            *common, _ptr(res), _ptr(ln_sb), 0.0 if eps is None else eps, _ptr(out), f32_out,
            m, k, n, _QTYPE_CODE[w.qtype], ACTIVATIONS.index(activation), tile[0], tile[1],
            stream)
        check(err, "q4_matmul_ln_launch")
        count(q4_matmul, "ln_launches")
    count(q4_matmul)
    if g is not None:
        count(q4_matmul, "prologue_launches")
    return out


def _q4_matmul_2d(x: torch.Tensor, w: QTensor, bias=None, prologue_mul=None, *,
                  activation=None, out_f32: bool = False) -> torch.Tensor:
    """K8: bf16 x streams K through output tiles (`tile`), at any K; f32 x
    holds one column slice of the dequantized weight in shared memory
    (`slice_width` columns) for every M tile it walks."""
    if not use_kernel(x, "q4", "q4_matmul_2d"):
        return q4_matmul_plain(x, w, bias, activation, out_f32=out_f32,
                               prologue_mul=prologue_mul)
    x, g, bias, out, f32_out, (qs, scales, mins) = _cuda_args(
        x, w, bias, prologue_mul, out_f32, activation)
    if x.shape[0] == 0:
        return out
    m, k = x.shape
    err = _fn("q4_matmul_2d_launch", [_P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                      _P])(
        _ptr(x), _ptr(g), int(x.dtype == torch.bfloat16), _ptr(qs), _ptr(scales), _ptr(mins),
        _ptr(bias), _ptr(out), f32_out, m, k, w.shape[1], _QTYPE_CODE[w.qtype],
        ACTIVATIONS.index(activation), torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "q4_matmul_2d_launch")
    count(q4_matmul, "n_tiled_launches")
    return out


def slice_width(k: int) -> int:
    """K8's column-slice width for f32 x at this K on the current card: the
    widest whose slice fits a block's shared memory (builds the kernels'
    library).  The bf16 body has no slice: see `tile`."""
    return _fn("q4_matmul_2d_slice_n", [_I])(k)


def tile(prologue: bool = False, bm: int = K8_TILE[0], bn: int = K8_TILE[1]) -> dict:
    """The bf16 tile kernel's bm x bn instance (K8's by default) on the
    current card: the output tile, the K step bk, the ring's stages, the
    warp tile wm x wn and the blocks per SM, for the kernel with or without
    the prologue's g tile (builds the kernels' library)."""
    out = (ctypes.c_int * 7)()
    check(_fn("q4_matmul_tile", [_I, _I, _I, ctypes.POINTER(ctypes.c_int)])(
        bm, bn, int(prologue), out), "q4_matmul_tile")
    return dict(zip(("bm", "bn", "bk", "stages", "wm", "wn", "blocks_per_sm"), out))


def q4_matmul(x: torch.Tensor, w: QTensor, bias: torch.Tensor | None = None,
              activation: str | None = None, residual: torch.Tensor | None = None,
              ln: tuple | None = None, out_f32: bool = False,
              prologue_mul: torch.Tensor | None = None) -> torch.Tensor:
    """(x [M, K] [* prologue_mul [M, K]]) @ packed w [K, N] -> act(. + bias)
    [+ residual [M, N]] [-> LayerNorm with ln = (scale [N], bias [N], eps)]
    [M, N] in x.dtype (f32 with `out_f32`), routed as `route` says.  CPU
    tensors take the plain version; CUDA tensors launch a kernel or raise."""
    _check_args(x, w, activation, prologue_mul, residual, ln)
    m, k = x.shape
    r = route(m, k, w.shape[1], w.qtype, x.dtype, prologue=prologue_mul is not None,
              residual=residual is not None, ln=ln is not None)
    if r.kernel == "1d":
        return _q4_matmul_1d(x, w, bias, residual, ln, prologue_mul,
                             activation=activation, out_f32=out_f32)
    if r.kernel == "2d":
        return _q4_matmul_2d(x, w, bias, prologue_mul, activation=activation, out_f32=out_f32)
    tail = residual is not None or ln is not None
    if r.kernel == "composed":
        y = _q4_matmul_2d(x, w, bias, prologue_mul, activation=activation, out_f32=True)
    else:  # "xla": K1 takes ragged M and N
        y = _q4_matmul_1d(x, w, bias, prologue_mul=prologue_mul, activation=activation,
                          out_f32=out_f32 or tail)
    if not tail:
        return y
    y = ln_tail(y, residual, ln)
    return y if out_f32 else y.to(x.dtype)


q4_matmul.launches = 0
q4_matmul.prologue_launches = 0  # the launches that multiplied in a prologue
q4_matmul.ln_launches = 0  # K1 launches with the residual/LayerNorm epilogue
q4_matmul.ln_split_launches = 0  # calls with that tail past one cluster: K1, then ln_tail
q4_matmul.n_tiled_launches = 0  # K8 launches
