"""K8's bf16 tile walk (`k8::q4_matmul_2d_tc_kernel`, csrc/q4_matmul.cu)
run in plain torch on the CPU, against the port's plain version and the
JAX package's N-tiled kernel.

The CUDA kernel cannot run here, so this file repeats its index
arithmetic: output tiles of TBM x TBN (read from the source), K walked in
TBK steps, each step's weight tile taken straight from the packed bytes as
the kernel's ring slot holds it (Q8 code rows, Q4 byte rows whose low
nibble is row j and high nibble row j + 16 of a 32-row block, one scale
row and one min row per 32 rows, zeros past K and N), each code made an
exact f32 as the kernel makes it (the byte in the mantissa of 2^23, less
the offset), dequantized with one f32 multiply (and add), rounded once to
the compute dtype, and the products summed per output tile in f32, then
the epilogue.

Checked: the dequantized tiles, put together, equal `dequant_weight` bit
for bit with zeros in the padding; the walk's output against
`q4_matmul_plain` (f32 1e-5 absolute: the same products summed in another
order; bf16 relative 1e-2, one rounding) and against the JAX package's
`_q4_matmul_2d` in interpret mode (f32 2e-5 absolute, the JAX package's
own bar: its kernel builds erf from a polynomial; bf16 relative 1e-2).
Shapes: K % 64 == 32, N not a multiple of 16, N below the tile width,
ragged M, the prologue multiply, every qtype, bf16 and f32.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import embedding_cpp_tpu.ops.q4_matmul as jq4
from embedding_cpp_tpu.gguf import GGMLType as JGGMLType
from embedding_cpp_tpu.gguf.quant import quantize as jax_quantize
from embedding_cpp_tpu.ops import qtensor as jqt
from embedding_cpp_tpu_torch.gguf import GGMLType
from embedding_cpp_tpu_torch.ops import qtensor as tqt
from embedding_cpp_tpu_torch.ops.q4_matmul import dequant_weight, epilogue, q4_matmul_plain

QK = 32
TWO23 = 8388608.0
F32_ATOL = 1e-5
JAX_F32_ATOL = 2e-5
BF16_REL = 1e-2
_SRC = Path(__file__).resolve().parents[1] / "embedding_cpp_tpu_torch" / "csrc" / "q4_matmul.cu"


def _kernel_tile() -> tuple[int, int, int]:
    """(TBM, TBN, TBK) as the kernel source defines them."""
    m = re.search(r"constexpr int TBM = (\d+), TBN = (\d+), TBK = (\d+)", _SRC.read_text())
    return int(m[1]), int(m[2]), int(m[3])


TBM, TBN, TBK = _kernel_tile()


def _codes(b: torch.Tensor, off: float) -> torch.Tensor:
    """Bytes (0..255) as exact f32 less `off`: 0x4B000000 | byte is the f32
    2^23 + byte, and the subtraction is exact (the kernel's `code`)."""
    return (b.to(torch.int32) | 0x4B000000).view(torch.float32) - off


def _slot(t: torch.Tensor, r0: int, rows: int, n0: int) -> torch.Tensor:
    """Rows r0 .. r0+rows-1, columns n0 .. n0+TBN-1 of a packed field, zeros
    past its end (the ring slot after its zero-filling copies)."""
    out = torch.zeros((rows, TBN), dtype=t.dtype)
    part = t[r0:r0 + rows, n0:n0 + TBN]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def _weight_tile(w: tqt.QTensor, k0: int, n0: int, dtype) -> torch.Tensor:
    """The kernel's B tile [TBK, TBN] of step k0, columns n0.., in `dtype`."""
    kb0 = k0 // QK
    s = _slot(w.scales, kb0, TBK // QK, n0).repeat_interleave(QK, dim=0)  # row r: r // 32
    if w.qtype == GGMLType.Q8_0:
        b = _slot(w.qs, k0, TBK, n0).view(torch.uint8).to(torch.int32) ^ 0x80  # code + 128
        return (_codes(b, TWO23 + 128.0) * s).to(dtype)
    b = _slot(w.qs, k0 // 2, TBK // 2, n0).to(torch.int32)  # [TBK / 2, TBN] byte rows
    lo, hi = b & 0x0F, b >> 4
    half = QK // 2
    nib = torch.cat([torch.cat([lo[j:j + half], hi[j:j + half]]) for j in range(0, TBK // 2, half)])
    if w.qtype == GGMLType.Q4_0:
        return (_codes(nib, TWO23 + 8.0) * s).to(dtype)
    m = _slot(w.mins, kb0, TBK // QK, n0).repeat_interleave(QK, dim=0)
    return (_codes(nib, TWO23) * s + m).to(dtype)


def _tiles_assembled(w: tqt.QTensor, k: int, n: int, dtype) -> torch.Tensor:
    kp, np_ = -(-k // TBK) * TBK, -(-n // TBN) * TBN
    out = torch.empty((kp, np_), dtype=dtype)
    for k0 in range(0, kp, TBK):
        for n0 in range(0, np_, TBN):
            out[k0:k0 + TBK, n0:n0 + TBN] = _weight_tile(w, k0, n0, dtype)
    return out


def tile_walk(x: torch.Tensor, w: tqt.QTensor, bias=None, activation=None,
              prologue_mul=None, out_f32: bool = False) -> torch.Tensor:
    """The kernel's walk: per output tile, per K step, the x tile (times
    the g tile in f32, rounded once) against the dequantized weight tile,
    summed in f32; then the epilogue and one cast."""
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32)
    for m0 in range(0, m, TBM):
        for n0 in range(0, n, TBN):
            acc = torch.zeros((TBM, TBN), dtype=torch.float32)
            for k0 in range(0, k, TBK):
                a = torch.zeros((TBM, TBK), dtype=x.dtype)
                xt = x[m0:m0 + TBM, k0:k0 + TBK]
                if prologue_mul is not None:
                    gt = prologue_mul[m0:m0 + TBM, k0:k0 + TBK]
                    xt = (xt.to(torch.float32) * gt.to(torch.float32)).to(x.dtype)
                a[:xt.shape[0], :xt.shape[1]] = xt
                acc += a.to(torch.float32) @ _weight_tile(w, k0, n0, x.dtype).to(torch.float32)
            rows, cols = min(TBM, m - m0), min(TBN, n - n0)
            b = None if bias is None else bias[n0:n0 + cols]
            out[m0:m0 + rows, n0:n0 + cols] = epilogue(acc[:rows, :cols], b, activation)
    return out if out_f32 else out.to(x.dtype)


def _weights(qtype: str, k: int, n: int, seed: int):
    """(JAX QTensor, port QTensor) of one random [k, n] weight."""
    w = np.random.default_rng(seed).normal(scale=0.02, size=(n, k)).astype(np.float32)
    raw = jax_quantize(w, JGGMLType[qtype])
    if qtype == "Q8_0":
        return jqt.pack_q8_matmul(raw, (n, k)), tqt.pack_q8_matmul(raw, (n, k))
    return (jqt.pack_q4_matmul(raw, (n, k), JGGMLType[qtype]),
            tqt.pack_q4_matmul(raw, (n, k), GGMLType[qtype]))


def _close(got: torch.Tensor, ref: np.ndarray, dtype: str, atol: float) -> None:
    got = got.to(torch.float32).numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    else:
        assert np.abs(got - ref).max() / np.abs(ref).max() <= BF16_REL


# (M, K, N, activation, bias, prologue): K % 64 == 32 in each but the last;
# N % 16 != 0 and a partial last N tile; N below the tile width with a
# ragged M over two M tiles and the prologue; one row at K = 32
SHAPES = [(37, 96, 200, "gelu_erf", True, False),
          (300, 1120, 72, None, False, True),
          (1, 32, 64, "gelu_tanh", True, False)]


@pytest.mark.parametrize("qtype", ["Q4_0", "Q4_1", "Q8_0"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n,act,bias,gated", SHAPES, ids=lambda v: str(v))
def test_tile_walk_matches_plain_and_pallas(qtype, dtype, m, k, n, act, bias, gated):
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    jw, tw = _weights(qtype, k, n, seed=k + n)
    rng = np.random.default_rng(m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32) if bias else None
    g = rng.standard_normal((m, k)).astype(np.float32) if gated else None
    tx = torch.from_numpy(x).to(td)
    tb = None if b is None else torch.from_numpy(b)
    tg = None if g is None else torch.from_numpy(g).to(td)

    tiles = _tiles_assembled(tw, k, n, td)
    assert torch.equal(tiles[:k, :n], dequant_weight(tw, td))
    assert not tiles[k:].any() and not tiles[:, n:].any()

    got = tile_walk(tx, tw, tb, act, tg)
    assert got.dtype == td
    _close(got, q4_matmul_plain(tx, tw, tb, act, prologue_mul=tg).to(torch.float32).numpy(),
           dtype, F32_ATOL)
    ref = jq4._q4_matmul_2d(
        jnp.asarray(x, jd), jw.qs, jw.scales, jw.mins, None if b is None else jnp.asarray(b),
        None if g is None else jnp.asarray(g, jd), tm=m, tn=n, activation=act)
    _close(got, np.asarray(jnp.asarray(ref, jnp.float32)), dtype, JAX_F32_ATOL)


def test_tile_walk_out_f32():
    """`out_f32` keeps the f32 epilogue's values (no cast) for bf16 x."""
    _, tw = _weights("Q4_1", 160, 136, seed=3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((70, 160)).astype(
        np.float32)).to(torch.bfloat16)
    got = tile_walk(x, tw, activation="silu", out_f32=True)
    assert got.dtype == torch.float32
    ref = q4_matmul_plain(x, tw, activation="silu", out_f32=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=F32_ATOL)
