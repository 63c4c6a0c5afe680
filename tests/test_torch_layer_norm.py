"""The norm layer's one-pass residual add + LayerNorm (`ops/linear.py`:
`layer_norm`, kernel `csrc/layer_norm.cu`).

On the CPU: the plain version with a residual equals the composition the
port ran before the kernel (the add in the activation dtype, then the f32
LayerNorm) bit for bit, at every family's width, bf16 and f32, with a bias
tensor, no bias and ModernBERT's bias-free norm (which added 0.0 before);
`linear(..., residual=, ln=)` gives the tensor it gave before, dense and
quantized; rows past the widest instance go to the plain version under
"auto" (counted), raise under "kernel"; operands the kernel has no
instance for raise before any launch; the kernel's lane mapping walked
here (`lane_walk`: chunk c of a row to lane c % 32, slot c / 32, with the
instances the source names and the entry point's choice among them: the
16-byte path only for rows of a multiple of 8 elements, the smallest lane
count that covers the row), covering every element of a row once; and a
numpy model of the kernel's arithmetic (`walk_model`: each lane's partial
sums in its order, the xor butterfly, the rounded operations of the
epilogue) against the plain version's mean, variance and output.

Marked `cuda` (skip without a card): the kernel against the plain version
on the card at the same widths, at the cells' [262,144, 1024] and
[524,288, 768], bf16 / f32 in and out, with and without a residual, on the
scalar path, a transposed x; f16 refused, rows past the widest instance
counted; and the launch counts of a bge-large and a ModernBERT forward,
none under `q4_impl="plain"`.

Tolerances: the statistics to f32 rounding of sums in another order
(`_sum_tol`); outputs in f32 to 2e-5 absolute (LayerNorm outputs of
magnitude ~1-5, relative differences ~1e-6 from the sums' order), in bf16
to that plus one bf16 ulp of the reference (the f32 values before the cast
may straddle a rounding boundary).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from embedding_cpp_tpu_torch.gguf import GGMLType
from embedding_cpp_tpu_torch.gguf.quant import quantize
from embedding_cpp_tpu_torch.ops import qtensor as tqt
from embedding_cpp_tpu_torch.models.modernbert import _ln as modernbert_ln
from embedding_cpp_tpu_torch.ops.dispatch import kernel_impls
from embedding_cpp_tpu_torch.ops.linear import (
    LN_MAX_WIDTH,
    _layer_norm_kernel,
    layer_norm,
    layer_norm_plain,
    linear,
)

_SRC = Path(__file__).resolve().parents[1] / "embedding_cpp_tpu_torch" / "csrc" / "layer_norm.cu"
WIDTHS = (128, 256, 312, 384, 768, 1024)  # ALBERT's embeddings ... bge-large
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
F32_ATOL = 2e-5


def _before(x, scale, bias, eps, out_dtype):
    """`layer_norm` as the port ran it before the kernel (verbatim)."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(out_dtype)


def _rows(m: int, n: int, dtype, seed: int = 0, shift: float = 0.3) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(shift + rng.normal(size=(m, n)).astype(np.float32)).to(dtype)


def _params(n: int, bias: str, seed: int = 1):
    rng = np.random.default_rng(seed)
    scale = torch.from_numpy((1 + 0.1 * rng.normal(size=n)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.normal(size=n)).astype(np.float32))
    return scale, b if bias == "tensor" else None


# --- the plain version against the composition it replaces ---------------------

@pytest.mark.parametrize("bias", ["tensor", "none", "modernbert"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("n", WIDTHS)
def test_plain_residual_is_the_add_then_the_norm(n, dtype, bias):
    """layer_norm(y, residual=r) == the old layer_norm(y + r) bit for bit
    (no bias: the old code adding 0.0, equal in value); ModernBERT's
    bias-free `_ln`, which passed the scalar 0.0, the same."""
    dt = DTYPES[dtype]
    y, r = _rows(6, n, dt, 2), _rows(6, n, dt, 3, -0.2)
    scale, b = _params(n, bias)
    want = _before(y + r, scale, 0.0 if b is None else b, 1e-12, dt)
    if bias == "modernbert":
        assert torch.equal(modernbert_ln(y + r, scale, 1e-12, dt), want)
        return
    assert torch.equal(layer_norm(y, scale, b, 1e-12, dt, residual=r), want)
    assert torch.equal(layer_norm(y + r, scale, b, 1e-12, dt), want)


def _weight(kind: str, k: int, n: int, dtype):
    w = np.random.default_rng(4).normal(scale=0.05, size=(n, k)).astype(np.float32)
    if kind == "dense":
        return torch.from_numpy(w.T.copy()).to(dtype)
    raw = quantize(w, GGMLType[kind])
    return (tqt.pack_q8_matmul(raw, (n, k)) if kind == "Q8_0"
            else tqt.pack_q4_matmul(raw, (n, k), GGMLType[kind]))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("kind", ["dense", "Q8_0", "Q4_0"])
def test_linear_residual_ln_tail_unchanged(kind, dtype):
    """linear(x, w, b, residual=, ln=) on the CPU: the product, the add in
    the activation dtype, the f32 LayerNorm, as before the one-pass norm."""
    dt = DTYPES[dtype]
    x = _rows(34, 256, dt, 5).reshape(2, 17, 256)
    res = _rows(34, 384, dt, 6).reshape(2, 17, 384)
    w = _weight(kind, 256, 384, dt)
    b = torch.from_numpy(np.random.default_rng(7).normal(size=384).astype(np.float32))
    scale, lb = _params(384, "tensor")
    y = linear(x, w, b, activation="gelu_erf")
    want = _before(y + res, scale, lb, 1e-12, dt)
    got = linear(x, w, b, activation="gelu_erf", residual=res, ln=(scale, lb, 1e-12))
    assert got.dtype == dt and torch.equal(got, want)
    assert torch.equal(linear(x, w, b, residual=res), linear(x, w, b) + res)


def test_counters_exist_and_the_cpu_counts_nothing():
    before = (layer_norm.launches, layer_norm.plain_calls)
    layer_norm(_rows(3, 128, torch.float32), *_params(128, "tensor"), 1e-5, torch.float32)
    assert (layer_norm.launches, layer_norm.plain_calls) == before


def test_rows_past_the_widest_instance_take_the_plain_version():
    """Under "auto" a row wider than the kernel's widest instance runs the
    plain version on any device, counted in `plain_calls`; "kernel"
    raises; "plain" counts nothing."""
    assert LN_MAX_WIDTH == MAX_WIDTH == 32 * max(LANE_ELEMS)
    for n, counted in ((MAX_WIDTH, 0), (MAX_WIDTH + 8, 1)):
        x = _rows(3, n, torch.bfloat16)
        scale, b = _params(n, "tensor")
        before = (layer_norm.launches, layer_norm.plain_calls)
        got = layer_norm(x, scale, b, 1e-5, torch.bfloat16, residual=x)
        assert (layer_norm.launches - before[0], layer_norm.plain_calls - before[1]) == (0, counted)
        assert torch.equal(got, layer_norm_plain(x, scale, b, 1e-5, torch.bfloat16, residual=x))
        with kernel_impls(q4="plain"):
            layer_norm(x, scale, b, 1e-5, torch.bfloat16)
        assert layer_norm.plain_calls - before[1] == counted
        with kernel_impls(q4="kernel"), pytest.raises(ValueError, match="impl 'kernel'"):
            layer_norm(x, scale, b, 1e-5, torch.bfloat16)


def test_what_the_kernel_refuses():
    """Operands the kernel has no instance for raise before any launch
    (CPU tensors here: the checks come first)."""
    scale, b = _params(768, "tensor")
    x = _rows(4, 768, torch.bfloat16)
    for args, match in [
        ((x.half(), scale, b, 1e-5, torch.half, None), "no kernel instance"),
        ((x, scale, b, 1e-5, torch.half, None), "no kernel instance"),
        ((x, scale, b, 1e-5, torch.bfloat16, x.float()), "residual"),
        ((x, scale, b, 1e-5, torch.bfloat16, x[:2]), "residual"),
        ((x, scale[:-1], b, 1e-5, torch.bfloat16, None), "scale"),
        ((x, scale, 0.0, 1e-5, torch.bfloat16, None), "bias"),
    ]:
        with pytest.raises(ValueError, match=match):
            _layer_norm_kernel(*args)


# --- the kernel's lane mapping, walked on the CPU ------------------------------

def _source_instances():
    """(LN_LANE_ELEMS, kScalarElems, kVecBytes, kMaxWidth) as
    csrc/layer_norm.cu names them."""
    text = _SRC.read_text()
    lanes = re.search(r"#define LN_LANE_ELEMS\(X\) (.*)", text)[1]

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    return (tuple(int(e) for e in re.findall(r"X\((\d+)\)", lanes)), const("kScalarElems"),
            const("kVecBytes"), const("kMaxWidth"))


LANE_ELEMS, SCALAR_ELEMS, VEC_BYTES, MAX_WIDTH = _source_instances()


def lane_elems(n: int, vector: bool) -> int:
    """The entry point's choice of the elements a lane holds: on the
    16-byte path the smallest instance whose 32 lanes cover the row, else
    the scalar path's."""
    return next(e for e in LANE_ELEMS if 32 * e >= n) if vector else SCALAR_ELEMS


def lane_walk(n: int, vector: bool, itemsize: int) -> list[list[int]]:
    """The element indices each of a row's 32 lanes holds, in the kernel's
    order: slot s, then the V elements of chunk lane + 32 s."""
    v = VEC_BYTES // itemsize if vector else 1
    slots = lane_elems(n, vector) // v
    lanes = []
    for lane in range(32):
        idx = []
        for s in range(slots):
            j = (lane + 32 * s) * v
            if j < n:
                assert j + v <= n, "a chunk past the row"
                idx.extend(range(j, j + v))
        lanes.append(idx)
    return lanes


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n", [1, 7, 100, 128, 256, 300, 312, 384, 512, 768, 1000, 1024, 1536,
                               2040, 2047, 2048])
def test_lane_walk_covers_each_element_once(n, itemsize):
    """The 16-byte path only where the row is a multiple of 8 elements
    (chunks of 8 bf16 or 4 f32 never cross the row's end), the scalar path
    at every width up to the widest instance."""
    assert 32 * SCALAR_ELEMS >= MAX_WIDTH
    for vector in ([False, True] if n % 8 == 0 else [False]):
        lanes = lane_walk(n, vector, itemsize)
        flat = sorted(i for lane in lanes for i in lane)
        assert flat == list(range(n))
        assert max(len(lane) for lane in lanes) <= lane_elems(n, vector)
        if vector:  # each chunk one aligned 16-byte load
            v = VEC_BYTES // itemsize
            assert all(lane[i] % v == 0 for lane in lanes for i in range(0, len(lane), v))
            smaller = [e for e in LANE_ELEMS if e < lane_elems(n, True)]
            assert all(32 * e < n for e in smaller), "not the smallest instance"


def _butterfly(p: np.ndarray) -> np.ndarray:
    """[M, 32] f32 lane partials -> lane 0's total after the xor shuffles."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        p = (p + p[:, lanes ^ off]).astype(np.float32)
    assert (p == p[:, :1]).all()  # every lane ends with the same total
    return p[:, 0]


def walk_model(s: np.ndarray, n: int, vector: bool, itemsize: int, scale, bias, eps: float):
    """The kernel's arithmetic on the rounded sums s [M, n] f32: (mean,
    var, y before the cast), each operation rounded to f32 in its order."""
    f32 = np.float32
    lanes = lane_walk(n, vector, itemsize)
    width = max(len(lane) for lane in lanes)
    idx = np.array([lane + [-1] * (width - len(lane)) for lane in lanes])  # [32, width]
    vals = s[:, np.maximum(idx, 0)]  # [M, 32, width]
    valid = idx >= 0
    part = np.zeros(s.shape[:1] + (32,), f32)
    for t in range(width):
        part = np.where(valid[:, t], part + vals[:, :, t], part).astype(f32)
    mean = (_butterfly(part) / f32(n)).astype(f32)[:, None]
    sq = np.zeros_like(part)
    for t in range(width):
        d = (vals[:, :, t] - mean).astype(f32)
        sq = np.where(valid[:, t], sq + (d * d).astype(f32), sq).astype(f32)
    var = (_butterfly(sq) / f32(n)).astype(f32)[:, None]
    rstd = (f32(1) / np.sqrt((var + f32(eps)).astype(f32))).astype(f32)
    y = (((s - mean).astype(f32) * rstd).astype(f32) * scale).astype(f32)
    if bias is not None:
        y = (y + np.asarray(bias, f32)).astype(f32)
    return mean[:, 0], var[:, 0], y


def _sum_tol(terms: np.ndarray, n: int, per_lane: int) -> np.ndarray:
    """Worst-case f32 rounding of a mean of `terms` [M, n]: a sequential sum
    over a lane's `per_lane` terms, 5 butterfly levels and the division,
    on either side."""
    u = 2.0**-24
    return 2 * (per_lane + 6) * u * np.abs(terms).sum(-1) / n


def _bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(ref)
    return torch.ldexp(torch.ones_like(ref), e - 8)


def close(got: torch.Tensor, ref: torch.Tensor) -> None:
    """f32 outputs within F32_ATOL; bf16 within one bf16 ulp of the
    reference more."""
    got_f, ref_f = got.float().cpu(), ref.float().cpu()
    assert torch.isfinite(got_f).all()
    err = (got_f - ref_f).abs()
    tol = F32_ATOL + (_bf16_ulp(ref_f) if got.dtype == torch.bfloat16 else 0.0)
    assert (err <= tol).all(), float((err - tol).max())


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("n", WIDTHS + (300, 2048))
def test_walk_model_matches_the_plain_version(n, dtype, out):
    """The numpy model of the kernel (on its vector path where the row
    allows it, else the scalar path) against the plain version: mean and
    variance to f32 rounding, the output within the bars above."""
    dt, odt = DTYPES[dtype], DTYPES[out]
    y, r = _rows(16, n, dt, 8), _rows(16, n, dt, 9, -0.5)
    scale, b = _params(n, "tensor" if n % 3 else "none")
    s = (y + r).float()  # the sum rounded to dt, as the kernel forms it
    want = layer_norm_plain(y, scale, b, 1e-5, odt, residual=r)
    mean_t = s.mean(-1)
    var_t = torch.square(s - mean_t[:, None]).mean(-1)
    bias = None if b is None else b.numpy()
    sn = s.numpy()
    for vector in ([True, False] if n % 8 == 0 else [False]):
        per_lane = max(len(lane) for lane in lane_walk(n, vector, dt.itemsize))
        mean, var, yy = walk_model(sn, n, vector, dt.itemsize, scale.numpy(), bias, 1e-5)
        assert (np.abs(mean - mean_t.numpy()) <= _sum_tol(sn, n, per_lane)).all()
        # the same bound over the squared deviations, doubled: each side has its own mean
        d2 = (sn - mean_t.numpy()[:, None]) ** 2
        assert (np.abs(var - var_t.numpy()) <= 2 * _sum_tol(d2, n, per_lane)).all()
        close(torch.from_numpy(yy).to(odt), want)


# --- on the card ----------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


IN_OUT = [("bf16", "bf16"), ("f32", "bf16"), ("bf16", "f32"), ("f32", "f32")]


def _counted(fn):
    before = (layer_norm.launches, layer_norm.plain_calls)
    out = fn()
    torch.cuda.synchronize()
    return out, (layer_norm.launches - before[0], layer_norm.plain_calls - before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True], ids=["x", "x+res"])
@pytest.mark.parametrize("io", IN_OUT, ids=["-".join(io) for io in IN_OUT])
@pytest.mark.parametrize("n", WIDTHS + (300, 1000, 2047, 2048))
def test_kernel_matches_plain_on_the_card(dev, n, io, residual):
    """Every family width, the scalar path (300, 2047) and the widest row;
    the bias a tensor or none (ModernBERT's)."""
    dt, odt = DTYPES[io[0]], DTYPES[io[1]]
    x = _rows(77, n, dt, 10).to(dev)
    r = _rows(77, n, dt, 11, -0.4).to(dev) if residual else None
    scale, b = _params(n, ("tensor", "none")[n % 2])
    scale = scale.to(dev)
    b = None if b is None else b.to(dev)
    got, (launches, plain) = _counted(lambda: layer_norm(x, scale, b, 1e-5, odt, residual=r))
    assert (launches, plain) == (1, 0) and got.dtype == odt and got.shape == x.shape
    close(got, layer_norm_plain(x, scale, b, 1e-5, odt, residual=r))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,residual,bias,out", [
    (262144, 1024, True, "tensor", "bf16"),  # bge-large.corpus: add + norm, 48 a forward
    (524288, 768, False, "none", "bf16"),  # ModernBERT's pre-norms
    (524288, 768, False, "none", "f32"),  # ModernBERT's final norm
    (524288, 768, True, "none", "bf16"),
])
def test_kernel_at_the_cells_shapes(dev, m, n, residual, bias, out):
    g = torch.Generator(dev).manual_seed(m + n)
    x = (0.3 + torch.randn((m, n), device=dev, generator=g)).to(torch.bfloat16)
    r = torch.randn((m, n), device=dev, generator=g).to(torch.bfloat16) if residual else None
    scale, b = _params(n, bias)
    scale = scale.to(dev)
    b = None if b is None else b.to(dev)
    odt = DTYPES[out]
    got, counts = _counted(lambda: layer_norm(x, scale, b, 1e-12, odt, residual=r))
    assert counts == (1, 0)
    close(got, layer_norm_plain(x, scale, b, 1e-12, odt, residual=r))


@pytest.mark.cuda
def test_kernel_scalar_path_and_what_it_leaves(dev):
    """A row stride off 16 bytes takes the scalar path and a transposed x
    a contiguous copy, both launched; f16 raises; rows past the widest
    instance take the plain version, counted under "auto", raise under
    "kernel"; "plain" launches nothing."""
    scale, b = _params(768, "tensor")
    scale, b = scale.to(dev), b.to(dev)
    base = _rows(40, 769, torch.bfloat16, 13).to(dev)
    x = base[:, 1:]  # rows of 768 at a stride of 769, 2 bytes off
    got, counts = _counted(lambda: layer_norm(x, scale, b, 1e-5, torch.bfloat16, residual=x))
    assert counts == (1, 0)
    close(got, layer_norm_plain(x, scale, b, 1e-5, torch.bfloat16, residual=x))
    xt = _rows(768, 8, torch.bfloat16, 16).to(dev).T  # last dim not contiguous
    got, counts = _counted(lambda: layer_norm(xt, scale, b, 1e-5, torch.bfloat16))
    assert counts == (1, 0)
    close(got, layer_norm_plain(xt, scale, b, 1e-5, torch.bfloat16))
    with pytest.raises(ValueError, match="no kernel instance"):
        layer_norm(_rows(8, 768, torch.half, 14).to(dev), scale, b, 1e-5, torch.half)
    wide = _rows(8, 2056, torch.bfloat16, 15).to(dev)
    sc, bb = (t.to(dev) for t in _params(2056, "tensor"))
    got, counts = _counted(lambda: layer_norm(wide, sc, bb, 1e-5, torch.bfloat16))
    assert counts == (0, 1)
    assert torch.equal(got, layer_norm_plain(wide, sc, bb, 1e-5, torch.bfloat16))
    with kernel_impls(q4="kernel"), pytest.raises(ValueError, match="impl 'kernel'"):
        layer_norm(wide, sc, bb, 1e-5, torch.bfloat16)
    with kernel_impls(q4="plain"):
        got, counts = _counted(lambda: layer_norm(x, scale, b, 1e-5, torch.bfloat16, residual=x))
    assert counts == (0, 0)
    assert torch.equal(got, layer_norm_plain(x, scale, b, 1e-5, torch.bfloat16, residual=x))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bge-large", "modernbert"])
def test_forward_norms_all_launch_the_kernel(dev, name):
    """A bf16 forward at the published width (2 or 3 layers, vocab cut):
    one launch for the embedding norm, two a layer (ModernBERT: none
    before layer 0's attention, one final norm), no plain call; none with
    `q4_impl="plain"`."""
    from dataclasses import replace

    from embedding_cpp_tpu_torch.models import BGE_LARGE_EN, MODERNBERT_BASE, ComputeOptions
    from embedding_cpp_tpu_torch.models import random_params
    from embedding_cpp_tpu_torch.models.bert import bert_embed_batch

    config, ftype, layers = {"bge-large": (BGE_LARGE_EN, "q8_0", 2),
                             "modernbert": (MODERNBERT_BASE, "q4_0", 3)}[name]
    config = replace(config, n_layer=layers, n_vocab=1000)
    opts = ComputeOptions(dtype="bfloat16")
    params = random_params(config, ftype, seed=1, dense_dtype=opts.tdtype, device=dev)
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(4, 1000, (4, 256)).astype(np.int32)).to(dev)
    mask = (torch.arange(256, device=dev)[None] < torch.tensor([256, 200, 31, 1],
                                                               device=dev)[:, None]).int()
    got, counts = _counted(lambda: bert_embed_batch(params, ids, mask, config, opts))
    assert counts == (2 * layers + 1, 0)
    assert torch.isfinite(got.float()).all()
    plain = ComputeOptions(dtype="bfloat16", q4_impl="plain")
    ref, counts = _counted(lambda: bert_embed_batch(params, ids, mask, config, plain))
    assert counts == (0, 0)
    assert torch.isfinite(ref.float()).all()
