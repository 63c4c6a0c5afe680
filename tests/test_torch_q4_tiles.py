"""The bf16 tile kernel of K1 and K8 (`tc::q4_matmul_tc_kernel`,
csrc/q4_matmul.cu) walked in plain torch on the CPU at every tile instance
the source names, against the port's plain version and the JAX package's
two TPU kernels; and K1's tile rule (`k1_tile`).

The CUDA kernel cannot run here, so this file repeats its index
arithmetic: output tiles of TBM x TBN (each instance of `TC_TILES`, read
from the source), K walked in TBK steps, each step's weight tile taken
straight from the packed bytes as the kernel's ring slot holds it (Q8 code
rows, Q4 byte rows whose low nibble is row j and high nibble row j + 16 of
a 32-row block, one scale row and one min row per 32 rows, zeros past K
and N), each code made an exact f32 as the kernel makes it (the byte in
the mantissa of 2^23, less the offset), dequantized with one f32 multiply
(and add), rounded once to the compute dtype, and the products summed per
output tile in f32, then the epilogue.

Checked: the dequantized tiles, put together, equal `dequant_weight` bit
for bit with zeros in the padding; the walk's output against
`q4_matmul_plain` (f32 1e-5 absolute: the same products summed in another
order; bf16 relative 1e-2, one rounding) and against the JAX package's
`_q4_matmul_1d` (K1's TPU kernel, one M tile of all M rows) and
`_q4_matmul_2d` (K8's) in interpret mode (f32 2e-5 absolute, the JAX
package's own bar: its kernel builds erf from a polynomial; bf16 relative
1e-2).  Shapes: K % 64 == 32, N not a multiple of 16, N below the tile
width, N = 384 and 1152, M = 512, ragged M, the prologue multiply, every
qtype, bf16 and f32.  The rule: the port's table of instances is the
source's, and for every K1 shape of the five models' planned batches it
names one of them with a launchable grid that keeps every SM busy where
any instance can.

K1's residual + LayerNorm epilogue is walked too (`ln_walk`, below): each
row's statistics formed from the partial sums of the blocks of one
thread-block cluster, in rank order, at N = 384, 768, 1024, 1000 and 4096
and a ragged M, against `q4_matmul_plain` and the JAX package's fused 1-D
kernel; and the rule that names its instance (`ln_tile`).
"""
import functools
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
from embedding_cpp_tpu_torch.benchmarks.kernels import K1_LAYERS
from embedding_cpp_tpu_torch.ops.q4_matmul import (
    K8_TILE,
    LN_F32_WIDTHS,
    LN_TILES,
    TC_TILES,
    dequant_weight,
    epilogue,
    k1_tile,
    ln_tile,
    q4_matmul_plain,
    route,
)

QK = 32
TWO23 = 8388608.0
F32_ATOL = 1e-5
JAX_F32_ATOL = 2e-5
BF16_REL = 1e-2
_SRC = Path(__file__).resolve().parents[1] / "embedding_cpp_tpu_torch" / "csrc" / "q4_matmul.cu"


def _kernel_tiles(macro: str = "TC_TILES") -> dict[tuple[int, int], int]:
    """{(TBM, TBN): blocks per SM} of every instance the macro `macro`
    (TC_TILES, or LN_ONLY_TILES) names in the kernel source, in its order."""
    block = re.search(rf"#define {macro}\(X\)((?:.*\\\n)*.*)", _SRC.read_text())[1]
    rows = re.findall(r"X\((\d+), (\d+), \d+, \d+, \d+, (\d+)\)", block)
    return {(int(bm), int(bn)): int(mb) for bm, bn, mb in rows}


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC.read_text())[1])


TILES = _kernel_tiles()
TBK = _constant("TBK")
F32_THREADS = _constant("F32_THREADS")


def _codes(b: torch.Tensor, off: float) -> torch.Tensor:
    """Bytes (0..255) as exact f32 less `off`: 0x4B000000 | byte is the f32
    2^23 + byte, and the subtraction is exact (the kernel's `code`)."""
    return (b.to(torch.int32) | 0x4B000000).view(torch.float32) - off


def _slot(t: torch.Tensor, r0: int, rows: int, n0: int, tbn: int) -> torch.Tensor:
    """Rows r0 .. r0+rows-1, columns n0 .. n0+tbn-1 of a packed field, zeros
    past its end (the ring slot after its zero-filling copies)."""
    out = torch.zeros((rows, tbn), dtype=t.dtype)
    part = t[r0:r0 + rows, n0:n0 + tbn]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def _weight_tile(w: tqt.QTensor, k0: int, n0: int, tbn: int, dtype) -> torch.Tensor:
    """The kernel's B tile [TBK, tbn] of step k0, columns n0.., in `dtype`."""
    kb0 = k0 // QK
    s = _slot(w.scales, kb0, TBK // QK, n0, tbn).repeat_interleave(QK, dim=0)  # row r: r // 32
    if w.qtype == GGMLType.Q8_0:
        b = _slot(w.qs, k0, TBK, n0, tbn).view(torch.uint8).to(torch.int32) ^ 0x80  # code + 128
        return (_codes(b, TWO23 + 128.0) * s).to(dtype)
    b = _slot(w.qs, k0 // 2, TBK // 2, n0, tbn).to(torch.int32)  # [TBK / 2, tbn] byte rows
    lo, hi = b & 0x0F, b >> 4
    half = QK // 2
    nib = torch.cat([torch.cat([lo[j:j + half], hi[j:j + half]]) for j in range(0, TBK // 2, half)])
    if w.qtype == GGMLType.Q4_0:
        return (_codes(nib, TWO23 + 8.0) * s).to(dtype)
    m = _slot(w.mins, kb0, TBK // QK, n0, tbn).repeat_interleave(QK, dim=0)
    return (_codes(nib, TWO23) * s + m).to(dtype)


def _tiles_assembled(w: tqt.QTensor, k: int, n: int, tbn: int, dtype) -> torch.Tensor:
    kp, np_ = -(-k // TBK) * TBK, -(-n // tbn) * tbn
    out = torch.empty((kp, np_), dtype=dtype)
    for k0 in range(0, kp, TBK):
        for n0 in range(0, np_, tbn):
            out[k0:k0 + TBK, n0:n0 + tbn] = _weight_tile(w, k0, n0, tbn, dtype)
    return out


def tile_walk(x: torch.Tensor, w: tqt.QTensor, tile: tuple[int, int], bias=None,
              activation=None, prologue_mul=None, out_f32: bool = False) -> torch.Tensor:
    """The kernel's walk at output tile `tile` (TBM, TBN): per output tile,
    per K step, the x tile (times the g tile in f32, rounded once) against
    the dequantized weight tile, summed in f32; then the epilogue and one
    cast."""
    tbm, tbn = tile
    m, k = x.shape
    n = w.shape[1]
    b_tiles = {}  # each weight tile is the same for every M tile
    out = torch.empty((m, n), dtype=torch.float32)
    for m0 in range(0, m, tbm):
        for n0 in range(0, n, tbn):
            acc = torch.zeros((tbm, tbn), dtype=torch.float32)
            for k0 in range(0, k, TBK):
                a = torch.zeros((tbm, TBK), dtype=x.dtype)
                xt = x[m0:m0 + tbm, k0:k0 + TBK]
                if prologue_mul is not None:
                    gt = prologue_mul[m0:m0 + tbm, k0:k0 + TBK]
                    xt = (xt.to(torch.float32) * gt.to(torch.float32)).to(x.dtype)
                a[:xt.shape[0], :xt.shape[1]] = xt
                if (k0, n0) not in b_tiles:
                    b_tiles[k0, n0] = _weight_tile(w, k0, n0, tbn, x.dtype).to(torch.float32)
                acc += a.to(torch.float32) @ b_tiles[k0, n0]
            rows, cols = min(tbm, m - m0), min(tbn, n - n0)
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


# (M, K, N, activation, bias, prologue): K % 64 == 32 in each but the last
# two; N % 16 != 0 and a partial last N tile; N below every tile width with
# a ragged M over two M tiles and the prologue; one row at K = 32; M = 512
# at N = K = 384 (MiniLM's q/k/v/o, DeBERTa's table-projection M); N = 1152
# (ModernBERT's up) at a ragged M with the prologue
SHAPES = [(37, 96, 200, "gelu_erf", True, False),
          (300, 1120, 72, None, False, True),
          (1, 32, 64, "gelu_tanh", True, False),
          (512, 384, 384, None, True, False),
          (45, 160, 1152, "silu", False, True)]


@functools.lru_cache(maxsize=None)
def _case(qtype: str, dtype: str, m: int, k: int, n: int, act, bias: bool, gated: bool):
    """The inputs of one case and the JAX package's two kernels' outputs on
    them (`_q4_matmul_1d` with one M tile of m rows, `_q4_matmul_2d` with
    tm = m, tn = n), computed once for every tile instance."""
    jd = getattr(jnp, dtype)
    jw, tw = _weights(qtype, k, n, seed=k + n)
    rng = np.random.default_rng(m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32) if bias else None
    g = rng.standard_normal((m, k)).astype(np.float32) if gated else None
    args = (jnp.asarray(x, jd), jw.qs, jw.scales, jw.mins, None if b is None else jnp.asarray(b))
    jg = None if g is None else jnp.asarray(g, jd)
    refs = [np.asarray(jnp.asarray(r, jnp.float32)) for r in (
        jq4._q4_matmul_1d(*args, prologue_mul=jg, tm=m, activation=act),
        jq4._q4_matmul_2d(*args, jg, tm=m, tn=n, activation=act))]
    return tw, x, b, g, refs


@pytest.mark.parametrize("tile", list(TILES), ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("qtype", ["Q4_0", "Q4_1", "Q8_0"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n,act,bias,gated", SHAPES, ids=lambda v: str(v))
def test_tile_walk_matches_plain_and_pallas(qtype, dtype, m, k, n, act, bias, gated, tile):
    td = getattr(torch, dtype)
    tw, x, b, g, refs = _case(qtype, dtype, m, k, n, act, bias, gated)
    tx = torch.from_numpy(x).to(td)
    tb = None if b is None else torch.from_numpy(b)
    tg = None if g is None else torch.from_numpy(g).to(td)

    tiles = _tiles_assembled(tw, k, n, tile[1], td)
    assert torch.equal(tiles[:k, :n], dequant_weight(tw, td))
    assert not tiles[k:].any() and not tiles[:, n:].any()

    got = tile_walk(tx, tw, tile, tb, act, tg)
    assert got.dtype == td
    _close(got, q4_matmul_plain(tx, tw, tb, act, prologue_mul=tg).to(torch.float32).numpy(),
           dtype, F32_ATOL)
    for ref in refs:
        _close(got, ref, dtype, JAX_F32_ATOL)


def test_tile_walk_out_f32():
    """`out_f32` keeps the f32 epilogue's values (no cast) for bf16 x, at
    every instance."""
    _, tw = _weights("Q4_1", 160, 136, seed=3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((70, 160)).astype(
        np.float32)).to(torch.bfloat16)
    ref = q4_matmul_plain(x, tw, activation="silu", out_f32=True)
    for tile in TILES:
        got = tile_walk(x, tw, tile, activation="silu", out_f32=True)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=F32_ATOL)


SMS = 132  # an H100 SXM's
# M of the five models' planned batches: the main path's [32, 512]; the
# STSB-profile corpus's packed and bucketed plans ([128, 512], [2048, 16],
# [512, 16], [168, 32], [172, 128]); nomic's 512 RAG chunks as [128, 2048];
# DeBERTa's 512-row relative table; ragged and tiny M
PLANNED_M = (16384, 65536, 32768, 8192, 5376, 22016, 262144, 512, 16347, 37, 1)
# The fastest instance on the card where it led the other by more than 3%
# (K1 forced through each instance, `kernels.py --only k1_tiles`, NVIDIA
# H100 80GB HBM3, 700 W; PERF.md): (M, K, N) -> (BM, BN)
CARD_FASTEST = {
    (512, 384, 384): (128, 64), (512, 768, 768): (128, 64), (512, 3072, 768): (128, 64),
    (512, 1024, 1024): (128, 64), (512, 768, 3072): (128, 64),
    (5376, 384, 384): (128, 64), (5376, 1536, 384): (128, 64),
    (5376, 384, 1536): (256, 128), (5376, 768, 768): (256, 128), (5376, 768, 1152): (256, 128),
    (5376, 3072, 768): (256, 128),
    (16384, 384, 384): (256, 128), (16384, 1536, 384): (256, 128),
    (16384, 768, 768): (256, 128), (16384, 1024, 1024): (256, 128),
    (16384, 768, 3072): (256, 128), (65536, 384, 384): (256, 128),
}


def test_k1_tile_rule_names_a_compiled_instance():
    """The port's table of instances is the source's (K8's first); for
    every K1 shape (route "1d" or "xla") of the five models at every planned
    M, with and without the prologue, `k1_tile` names one of them and its
    grid is launchable (at most 65535 M tiles)."""
    assert TC_TILES == TILES and K8_TILE == next(iter(TILES))
    seen = 0
    for qtype, _, layer in K1_LAYERS.values():
        for _, k, n, _, _, gated in layer:
            for m in PLANNED_M:
                r = route(m, k, n, GGMLType[qtype], torch.bfloat16, prologue=gated)
                if r.kernel not in ("1d", "xla"):
                    continue
                seen += 1
                bm, bn = k1_tile(m, k, n, SMS)
                assert (bm, bn) in TILES, (m, k, n)
                assert -(-m // bm) <= 65535
    assert seen >= 40


@pytest.mark.parametrize("m,k,n", list(CARD_FASTEST), ids=lambda v: str(v))
def test_k1_tile_rule_picks_what_the_card_ran_fastest(m, k, n):
    assert k1_tile(m, k, n, SMS) == CARD_FASTEST[m, k, n]


# --- K1's residual + LayerNorm epilogue across a cluster ------------------------
#
# The kernel's tail (`ln_tail`, csrc/q4_matmul.cu) walked on the tile walk's
# f32 output tiles: the N tiles of an M panel are one cluster; each block
# adds the residual to its tile and forms each row's partial sum (TPR =
# threads / TBM threads a row, each summing every TPR-th float4 of the row
# in order, then an xor butterfly over the TPR), the partials are
# summed in cluster-rank (N-tile) order for the mean (divided by N), then
# the same for sum((y - mean)^2) and rsqrt(var + eps); columns past N add
# nothing, rows past M are their own.  Tolerances: against
# `q4_matmul_plain`, f32 1e-5 absolute (the same products and sums in
# another order; the normalized outputs are O(1)) and bf16 relative 1e-2
# (one rounding); against the JAX fused 1-D kernel in interpret mode, f32
# 2e-5 (its erf polynomial).


@pytest.fixture
def one_thread():
    """The walks are many small tensor ops: one intra-op thread runs them
    as fast as many on an idle host, and keeps them from stalling on a busy
    one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block_threads(tile: tuple[int, int]) -> int:
    """Threads of a block at output tile `tile`: (TBM / WM) x (TBN / WN)
    warps of the tile kernel's instance, or F32_THREADS for the f32 body's
    tiles."""
    text = _SRC.read_text()
    for macro in ("TC_TILES", "LN_ONLY_TILES"):
        block = re.search(rf"#define {macro}\(X\)((?:.*\\\n)*.*)", text)[1]
        for bm, bn, wm, wn in re.findall(r"X\((\d+), (\d+), (\d+), (\d+), \d+, \d+\)", block):
            if (int(bm), int(bn)) == tile:
                return int(bm) // int(wm) * (int(bn) // int(wn)) * 32
    return F32_THREADS


def _block_partial(v: torch.Tensor, tpr: int) -> torch.Tensor:
    """One block's partial row sums of v [rows, TBN] as `ln_tail` forms
    them: thread p of a row sums its float4s j * tpr + p (j = 0, 1, ..), each
    one's 4 columns in order, then s_p += s_(p ^ o) for o = 1, 2, .. tpr / 2."""
    rows, tbn = v.shape
    parts = v.reshape(rows, tbn // (4 * tpr), tpr, 4).permute(0, 2, 1, 3).reshape(rows, tpr, -1)
    s = torch.zeros((rows, tpr), dtype=torch.float32)
    for j in range(parts.shape[-1]):
        s = s + parts[:, :, j]
    o = 1
    while o < tpr:
        s = s + s[:, torch.arange(tpr) ^ o]
        o *= 2
    return s[:, 0]


def ln_walk(x, w, tile, bias, activation, residual, ln, prologue_mul=None,
            out_f32: bool = False) -> torch.Tensor:
    """The kernel's epilogue at output tile `tile` (TBM, TBN): the tile walk
    (products, bias, activation, in f32), the residual, then the LayerNorm
    with the statistics of each row formed over its cluster's blocks."""
    tbm, tbn = tile
    y = tile_walk(x, w, tile, bias, activation, prologue_mul, out_f32=True)
    if residual is not None:
        y = y + residual.to(torch.float32)
    m, n = y.shape
    tpr = _block_threads(tile) // tbm
    ranks = -(-n // tbn)
    out = y.clone()
    for m0 in range(0, m, tbm):
        rows = y[m0:m0 + tbm]
        r = rows.shape[0]
        padded = torch.zeros((r, ranks * tbn), dtype=torch.float32)
        padded[:, :n] = rows
        tot = torch.zeros(r, dtype=torch.float32)
        for b in range(ranks):  # rank order
            tot = tot + _block_partial(padded[:, b * tbn:(b + 1) * tbn], tpr)
        mean = tot / n
        d = padded - mean[:, None]
        d[:, n:] = 0.0  # columns past N add nothing
        tot = torch.zeros(r, dtype=torch.float32)
        for b in range(ranks):
            tot = tot + _block_partial(torch.square(d[:, b * tbn:(b + 1) * tbn]), tpr)
        rstd = torch.rsqrt(tot / n + ln[2])
        out[m0:m0 + tbm] = ((rows - mean[:, None]) * rstd[:, None] * ln[0].to(torch.float32)
                            + ln[1].to(torch.float32))
    return out if out_f32 else out.to(x.dtype)


def _walk_tile(m: int, k: int, n: int, dtype: str) -> tuple[int, int]:
    """The output tile the epilogue runs at: `ln_tile`'s bf16 instance, or
    the f32 body's (4 * F32_THREADS / (FBN / 4)) x FBN."""
    tile = ln_tile(m, k, n, dtype == "bfloat16", SMS)
    assert tile is not None
    if dtype == "bfloat16":
        assert tile in LN_TILES
        return tile
    fbn = tile[1]
    assert fbn in LN_F32_WIDTHS
    return 4 * F32_THREADS // (fbn // 4), fbn


def _ln_inputs(qtype: str, m: int, k: int, n: int, dtype: str, seed: int):
    jw, tw = _weights(qtype, k, n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    lnb = (0.1 * rng.standard_normal(n)).astype(np.float32)
    td = getattr(torch, dtype)
    port = (torch.from_numpy(x).to(td), tw, torch.from_numpy(b), torch.from_numpy(res).to(td),
            (torch.from_numpy(scale), torch.from_numpy(lnb), 1e-12))
    return port, (jw, x, b, res, scale, lnb)


# (M, K, N): the model widths 384 / 768 / 1024 (one cluster of 3-16 blocks),
# N = 1000 (a ragged last tile), 4096 (16 blocks of 256 columns; f32: 16 of
# 256), and a ragged M over two M tiles
LN_SHAPES = [(37, 64, 384), (37, 64, 768), (20, 64, 1024), (37, 96, 1000), (20, 64, 4096),
             (300, 64, 384)]


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n", LN_SHAPES, ids=lambda v: str(v))
def test_ln_walk_matches_plain(m, k, n, dtype):
    qtype = ("Q4_0", "Q4_1", "Q8_0")[n % 3]
    (x, w, b, res, ln), _ = _ln_inputs(qtype, m, k, n, dtype, seed=n + m)
    tile = _walk_tile(m, k, n, dtype)
    got = ln_walk(x, w, tile, b, "gelu_erf", res, ln)
    assert got.dtype == x.dtype
    ref = q4_matmul_plain(x, w, b, "gelu_erf", residual=res, ln=ln)
    _close(got, ref.to(torch.float32).numpy(), dtype, F32_ATOL)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ln_walk_matches_the_fused_pallas_kernel(dtype):
    """The JAX package's `_q4_matmul_1d` with `residual` and `ln_sb` (its
    whole rows in one tile of all M rows), interpret mode."""
    m, k, n = 16, 64, 384
    (x, w, b, res, ln), (jw, xn, bn, rn, sn, lbn) = _ln_inputs("Q4_1", m, k, n, dtype, seed=9)
    jd = getattr(jnp, dtype)
    ref = jq4._q4_matmul_1d(jnp.asarray(xn, jd), jw.qs, jw.scales, jw.mins, jnp.asarray(bn),
                            jnp.asarray(rn, jd), jnp.stack([jnp.asarray(sn), jnp.asarray(lbn)]),
                            tm=m, activation="gelu_erf", ln_eps=1e-12)
    got = ln_walk(x, w, _walk_tile(m, k, n, dtype), b, "gelu_erf", res, ln)
    _close(got, np.asarray(jnp.asarray(ref, jnp.float32)), dtype, JAX_F32_ATOL)


@pytest.mark.usefixtures("one_thread")
def test_ln_walk_prologue_and_residual_alone():
    """The prologue multiply before the product, and the residual without
    a LayerNorm (no statistics, no cluster)."""
    m, k, n = 45, 160, 1152
    (x, w, b, res, ln), _ = _ln_inputs("Q8_0", m, k, n, "float32", seed=4)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((m, k)).astype(np.float32))
    tile = _walk_tile(m, k, n, "float32")
    got = ln_walk(x, w, tile, b, "silu", res, ln, prologue_mul=g)
    ref = q4_matmul_plain(x, w, b, "silu", residual=res, ln=ln, prologue_mul=g)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=F32_ATOL)
    alone = tile_walk(x, w, tile, b, "silu", g, out_f32=True) + res
    ref = q4_matmul_plain(x, w, b, "silu", residual=res, prologue_mul=g)
    np.testing.assert_allclose(alone.numpy(), ref.numpy(), rtol=0, atol=F32_ATOL)


def test_ln_tile_rule_names_an_instance_whose_cluster_holds_the_row():
    """The port's LN instances are the source's (TC_TILES and
    LN_ONLY_TILES); at the models' widths the rule names an instance whose
    ceil(N / TBN) blocks fit one cluster of 16; rows past 16 x 256 (f32: 16
    x 256) take the split route (None), as do rows past a smaller cap."""
    assert LN_TILES == {**TILES, **_kernel_tiles("LN_ONLY_TILES")}
    for m in PLANNED_M:
        for k, n in ((384, 384), (768, 768), (1024, 1024), (1024, 4096), (3072, 768)):
            for bf16 in (True, False):
                bm, bn = ln_tile(m, k, n, bf16, SMS)
                assert -(-n // bn) <= 16 and (not bf16 or (bm, bn) in LN_TILES)
    assert ln_tile(16384, 1024, 4096, True, SMS) == (128, 256)
    assert ln_tile(16384, 1024, 4096, False, SMS) == (0, 256)
    assert ln_tile(16384, 1024, 1024, False, SMS) == (0, 64)
    for bf16 in (True, False):
        assert ln_tile(64, 256, 8192, bf16, SMS) is None
        assert ln_tile(16384, 1024, 4096, bf16, SMS, cap=lambda t: 8) is None
