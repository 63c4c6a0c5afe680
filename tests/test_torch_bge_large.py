"""The port's BERT-large slice (bge-large-en-v1.5 geometry, Q8_0 weights)
against the JAX package, on the CPU with inputs made from numpy seeds.

Covered: K8's plain version against the JAX package's N-tiled kernel
`_q4_matmul_2d` in interpret mode at bge-large's FFN shapes; the port's
`route` against the JAX `q4_matmul`'s dispatch over every preset's linears
(the JAX kernels replaced by recording stubs); K1's residual + LayerNorm
epilogue against JAX `q4_matmul(residual=, ln=)` on its fused 1-D kernel and
on its composed f32 path; the full-width forward (1024 wide, 16 heads of
64, FFN 4096) at 2 layers against the JAX forward with its Pallas kernels,
while JAX provably runs `_q4_matmul_2d` on every FFN linear; the Engine
against the JAX Engine; a Q8_0 GGUF through both loaders; the retrieval
helpers (`encode_queries`, `encode_documents`, `encode_with_counts`,
`truncate=False`).

Tolerances: f32 2e-5 absolute (the JAX package's own bar; its kernels
build erf from a polynomial and sum in another order); bf16 relative 1e-2
(one bf16 rounding) for single products and min cosine 0.999 for whole
forwards; parameters and configs bit-exact.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_params import assert_params_equal

import embedding_cpp_tpu.ops.q4_matmul as jq4
import embedding_cpp_tpu.ops.qtensor as jqtensor
from embedding_cpp_tpu.gguf import GGMLType as JGGMLType
from embedding_cpp_tpu.gguf.quant import quantize as jax_quantize
from embedding_cpp_tpu.models.bert import ComputeOptions as JOpts
from embedding_cpp_tpu.models.bert import bert_embed_batch as jax_embed_batch
from embedding_cpp_tpu.models.bert import bert_embed_packed as jax_embed_packed
from embedding_cpp_tpu.models.config import BertConfig as JConfig
from embedding_cpp_tpu.models.convert import FTYPE_NAMES as J_FTYPES
from embedding_cpp_tpu.models.params import random_params as jax_random_params
from embedding_cpp_tpu.ops import qtensor as jqt
from embedding_cpp_tpu_torch.gguf import GGMLType
from embedding_cpp_tpu_torch.models import (
    BGE_LARGE_EN,
    BertConfig,
    ComputeOptions,
    bert_embed_batch,
    bert_embed_packed,
    from_jax_params,
    random_params,
)
from embedding_cpp_tpu_torch.ops import qtensor as tqt
from embedding_cpp_tpu_torch.ops.q4_matmul import (
    Route,
    _q4_matmul_1d,
    _q4_matmul_2d,
    q4_matmul,
    q4_matmul_plain,
    route,
)

F32_ATOL = 2e-5
BF16_REL = 1e-2
COSINE = 0.999
M = 64  # one JAX M tile: the interpret runs stay short
# bge-large at 2 layers, the vocab cut to 1000 words
BGE2 = dict(n_vocab=1000, n_ctx=512, n_embd=1024, n_layer=2, n_head=16, n_ff=4096,
            layer_norm_eps=1e-12, gelu="erf", pooling="cls", name="bge-large-2l")
PALLAS = dict(q4_impl="pallas", attn_impl="pallas")


def _weights(qtype: str, k: int, n: int, seed: int = 0):
    """(JAX QTensor, port QTensor) of one random [k, n] weight (scale 0.02,
    as the random state dicts draw it)."""
    w = np.random.default_rng(seed).normal(scale=0.02, size=(n, k)).astype(np.float32)
    raw = jax_quantize(w, JGGMLType[qtype])
    if qtype == "Q8_0":
        return jqt.pack_q8_matmul(raw, (n, k)), tqt.pack_q8_matmul(raw, (n, k))
    return (jqt.pack_q4_matmul(raw, (n, k), JGGMLType[qtype]),
            tqt.pack_q4_matmul(raw, (n, k), GGMLType[qtype]))


def _normal(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(got: torch.Tensor, ref, dtype: str) -> None:
    got = got.to(torch.float32).numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)
    else:
        assert np.abs(got - ref).max() / np.abs(ref).max() <= BF16_REL


# --- K8: the N-tiled kernel's plain version ---------------------------------

@pytest.mark.parametrize("qtype,dtype,k,n,act,bias,gated", [
    ("Q8_0", "bfloat16", 1024, 4096, "gelu_erf", True, False),
    ("Q8_0", "bfloat16", 4096, 1024, None, True, False),
    ("Q8_0", "float32", 1024, 4096, "gelu_erf", True, False),
    ("Q8_0", "float32", 4096, 1024, None, False, False),
    ("Q4_0", "float32", 1024, 4096, "gelu_erf", True, False),
    ("Q4_0", "float32", 4096, 1024, None, True, False),
    ("Q4_1", "float32", 4096, 1024, "silu", False, False),
    ("Q8_0", "bfloat16", 4096, 1024, None, False, True),
    ("Q8_0", "float32", 1024, 4096, "gelu_tanh", True, True),
], ids=lambda v: str(v))
def test_n_tiled_matches_pallas_kernel(qtype, dtype, k, n, act, bias, gated):
    """bge-large's up (1024 -> 4096) and down (4096 -> 1024) projections at
    M = 64 on the route's 2-D tiles: the port's `_q4_matmul_2d` (on the
    CPU, its plain version) against JAX's `_q4_matmul_2d` in interpret mode."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    r = route(M, k, n, GGMLType[qtype], td, prologue=gated)
    assert r.kernel == "2d" and (r.tm, r.tn) == (64, 512)
    jw, tw = _weights(qtype, k, n, seed=k + n)
    x = _normal(1, M, k)
    b = _normal(2, n, scale=0.1) if bias else None
    g = _normal(3, M, k) if gated else None
    ref = jq4._q4_matmul_2d(
        jnp.asarray(x, jd), jw.qs, jw.scales, jw.mins, None if b is None else jnp.asarray(b),
        None if g is None else jnp.asarray(g, jd), tm=r.tm, tn=r.tn, activation=act)
    got = _q4_matmul_2d(torch.from_numpy(x).to(td), tw,
                        None if b is None else torch.from_numpy(b),
                        None if g is None else torch.from_numpy(g).to(td), activation=act)
    assert got.dtype == td
    _close(got, ref, dtype)


def test_n_tiled_plain_is_the_one_function():
    """K8 and K1 compute one function: on the CPU both launchers give
    `q4_matmul_plain`'s result bit for bit, and neither counts a launch."""
    _, tw = _weights("Q8_0", 256, 384)
    x = torch.from_numpy(_normal(4, 40, 256)).to(torch.bfloat16)
    b = torch.from_numpy(_normal(5, 384, scale=0.1))
    counts = (q4_matmul.launches, q4_matmul.n_tiled_launches, q4_matmul.ln_launches)
    ref = q4_matmul_plain(x, tw, b, "gelu_erf")
    assert torch.equal(_q4_matmul_2d(x, tw, b, activation="gelu_erf"), ref)
    assert torch.equal(_q4_matmul_1d(x, tw, b, activation="gelu_erf"), ref)
    assert torch.equal(q4_matmul(x, tw, b, "gelu_erf"), ref)
    assert (q4_matmul.launches, q4_matmul.n_tiled_launches, q4_matmul.ln_launches) == counts


# --- the route against the JAX dispatch ---------------------------------------

class _FellBack(Exception):
    pass


@pytest.fixture
def jax_dispatch(monkeypatch):
    """JAX `q4_matmul` with its two kernels and its XLA fallback replaced by
    recording stubs: returns a function of a call's shapes that gives the
    kernel JAX chose ("1d", "2d" or "xla") and its tiles."""
    seen = []

    def one_d(*args, tm, **kw):
        seen.append(("1d", tm, 0))
        return jnp.zeros((1,))

    def two_d(*args, tm, tn, **kw):
        seen.append(("2d", tm, tn))
        return jnp.zeros((1,))

    def fell_back(*args, **kw):
        raise _FellBack

    monkeypatch.setattr(jq4, "_q4_matmul_1d", one_d)
    monkeypatch.setattr(jq4, "_q4_matmul_2d", two_d)
    monkeypatch.setattr(jqtensor, "dequantize", fell_back)

    def dispatch(m, k, n, qtype, dtype, prologue, residual, ln):
        q8 = qtype == "Q8_0"
        w = SimpleNamespace(qtype=JGGMLType[qtype], qs=SimpleNamespace(shape=(k if q8 else k // 2, n)),
                            scales=None, mins=object() if qtype == "Q4_1" else None)
        seen.clear()
        try:
            jq4.q4_matmul(jax.ShapeDtypeStruct((m, k), getattr(jnp, dtype)), w,
                          prologue_mul=object() if prologue else None,
                          residual=object() if residual else None,
                          ln=(jnp.ones(n), jnp.zeros(n), 1e-12) if ln else None)
        except _FellBack:
            return ("xla", 0, 0)
        (choice,) = seen
        return choice

    return dispatch


# each preset's linears per layer: (K, N, prologue, residual + LayerNorm tail)
_LINEARS = {
    "minilm-l6": [(384, 384, False, True), (384, 1536, False, False),
                  (1536, 384, False, True)],
    "modernbert-base": [(768, 768, False, True), (768, 1152, False, False),
                        (1152, 768, True, True)],
    "deberta-v3-base": [(768, 768, False, True), (768, 3072, False, False),
                        (3072, 768, False, True)],
    "nomic-embed-text-v1.5": [(768, 768, False, True), (768, 3072, False, False),
                              (3072, 768, True, True)],
    "bge-large-en-v1.5": [(1024, 1024, False, True), (1024, 4096, False, False),
                          (4096, 1024, False, True)],
}


@pytest.mark.parametrize("qtype", ["Q4_0", "Q4_1", "Q8_0"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("model", sorted(_LINEARS))
def test_route_matches_jax_dispatch(jax_dispatch, model, dtype, qtype):
    """Every preset's linears at M = 128, 4096 and 16384 (DeBERTa's relative
    table projection at M = 512 too), with and without the residual and the
    LayerNorm tail where the model has one: the port's route names the
    kernel and the tiles JAX chose, or its fallback."""
    cases = [(m, k, n, p, res, res) for m in (128, 4096, 16384)
             for k, n, p, tail in _LINEARS[model] for res in {False, tail}]
    if model == "deberta-v3-base":
        cases.append((512, 768, 768, False, False, False))
    for m, k, n, prologue, residual, ln in cases:
        r = route(m, k, n, GGMLType[qtype], getattr(torch, dtype), prologue=prologue,
                  residual=residual, ln=ln)
        want = jax_dispatch(m, k, n, qtype, dtype, prologue, residual, ln)
        got = ("xla" if r.kernel == "composed" else r.kernel, r.tm, r.tn)
        assert got == want, (m, k, n, prologue, residual, ln)
        if r.kernel == "composed":
            assert residual or ln


@pytest.mark.parametrize("m,k,n,qtype,dtype,prologue,residual,ln", [
    (40, 384, 384, "Q4_0", "bfloat16", False, False, False),    # no bf16 M tile
    (40, 384, 384, "Q4_0", "float32", False, True, True),       # f32 tiles of 8
    (1, 1024, 4096, "Q8_0", "bfloat16", False, False, False),   # one row
    (64, 1024, 1000, "Q8_0", "float32", False, False, False),   # N % 128
    (64, 4096, 1024, "Q8_0", "bfloat16", False, False, True),   # LayerNorm alone
    (64, 4096, 1024, "Q8_0", "bfloat16", True, False, False),   # prologue
    (16384, 1024, 4096, "Q4_0", "bfloat16", True, False, False),
    (96, 4096, 384, "Q4_1", "float32", False, False, False),
], ids=lambda v: str(v))
def test_route_matches_jax_dispatch_at_edges(jax_dispatch, m, k, n, qtype, dtype, prologue,
                                             residual, ln):
    r = route(m, k, n, GGMLType[qtype], getattr(torch, dtype), prologue=prologue,
              residual=residual, ln=ln)
    got = ("xla" if r.kernel == "composed" else r.kernel, r.tm, r.tn)
    assert got == jax_dispatch(m, k, n, qtype, dtype, prologue, residual, ln)


def test_route_budget_is_inclusive(jax_dispatch):
    """DeBERTa's and nomic's down projection (3072 -> 768) in f32 Q8_0 at M
    = 16384: the 1-D estimate at tm 16 is exactly 12 MiB, which the TPU
    rule (`<=`) still takes; bge-large's FFN in bf16 Q8_0 is over it at any
    tile."""
    r = route(16384, 3072, 768, GGMLType.Q8_0, torch.float32)
    assert r == ("1d", 16, 0)
    assert (3072 * 768 * 4 + 2 * 16 * (3072 + 768) * 4 + 3072 * 768 + 96 * 768 * 4
            == 12 * 1024 * 1024)
    assert jax_dispatch(16384, 3072, 768, "Q8_0", "float32", False, False, False) == r
    for k, n in ((1024, 4096), (4096, 1024)):
        assert route(16384, k, n, GGMLType.Q8_0, torch.bfloat16) == ("2d", 256, 512)
        assert route(16384, k, n, GGMLType.Q4_0, torch.bfloat16).kernel == "1d"
        assert route(16384, k, n, GGMLType.Q4_0, torch.float32).kernel == "2d"


def test_bge_large_launch_counts_per_forward():
    """What chip_smoke.py asserts on the card, from the route alone: a Q8_0
    bge-large forward in bf16 runs q, k, v, o on K1 and up, down on K8 at
    every M the Engine's buckets give (powers of two from 16 to 32768)."""
    c = BGE_LARGE_EN
    per_layer = [(c.n_embd, c.n_embd)] * 4 + [(c.n_embd, c.n_ff), (c.n_ff, c.n_embd)]
    for dtype in (torch.bfloat16, torch.float32):
        for m in (2 ** i for i in range(4, 16)):
            kernels = [route(m, k, n, GGMLType.Q8_0, dtype).kernel for k, n in per_layer]
            assert kernels == ["1d"] * 4 + ["2d"] * 2, (dtype, m, kernels)


# --- K1's residual + LayerNorm epilogue -----------------------------------------

def _epilogue_case(qtype, dtype, m, k, n, residual, ln, seed=0):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jw, tw = _weights(qtype, k, n, seed=seed)
    x, b = _normal(seed + 1, m, k), _normal(seed + 2, n, scale=0.1)
    res = _normal(seed + 3, m, n) if residual else None
    scale, bias_ln = 1.0 + _normal(seed + 4, n, scale=0.1), _normal(seed + 5, n, scale=0.1)
    ref = jq4.q4_matmul(
        jnp.asarray(x, jd), jw, bias=jnp.asarray(b), activation="gelu_erf",
        residual=None if res is None else jnp.asarray(res, jd),
        ln=(jnp.asarray(scale), jnp.asarray(bias_ln), 1e-12) if ln else None)
    got = q4_matmul(
        torch.from_numpy(x).to(td), tw, torch.from_numpy(b), "gelu_erf",
        residual=None if res is None else torch.from_numpy(res).to(td),
        ln=(torch.from_numpy(scale), torch.from_numpy(bias_ln), 1e-12) if ln else None)
    assert got.dtype == td
    _close(got, ref, dtype)
    return route(m, k, n, GGMLType[qtype], td, residual=residual, ln=ln)


@pytest.mark.parametrize("qtype", ["Q4_0", "Q4_1", "Q8_0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_epilogue_matches_pallas_kernel(qtype, dtype):
    """bias, gelu, residual and LayerNorm in the 1-D kernel's f32 epilogue
    (JAX `_q4_matmul_1d` with `residual` and `ln_sb`, interpret mode)."""
    assert _epilogue_case(qtype, dtype, 64, 256, 384, True, True).kernel == "1d"


@pytest.mark.parametrize("residual,ln", [(True, False), (False, True)])
def test_fused_epilogue_parts_match_pallas_kernel(residual, ln):
    assert _epilogue_case("Q8_0", "float32", 32, 128, 256, residual, ln).kernel == "1d"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_composed_epilogue_matches_jax(dtype):
    """bge-large's down projection with the tail (4096 -> 1024, Q8_0): too
    large for the 1-D kernel, so JAX composes the tail in f32 after an XLA
    product and the port after K8's f32 output."""
    assert _epilogue_case("Q8_0", dtype, 64, 4096, 1024, True, True).kernel == "composed"


def test_wide_rows_take_the_fused_route_and_match_the_pallas_kernel():
    """F6: `route` sends a residual + LayerNorm tail on rows of 4096 to
    the 1-D kernel, as the JAX dispatch does (e.g. [16384, 1024] x [1024,
    4096] Q4_0 bf16 at tm 32), and the JAX `q4_matmul` answers there
    through its fused Pallas kernel (interpret mode): the port's
    `q4_matmul` on the CPU matches it within the f32 bar.  On the card
    those rows run the cluster epilogue (tests/test_torch_cuda.py)."""
    assert route(16384, 1024, 4096, GGMLType.Q4_0, torch.bfloat16, residual=True,
                 ln=True) == Route("1d", 32)
    assert _epilogue_case("Q8_0", "float32", 64, 256, 4096, True, True) == Route("1d", 64)


def test_epilogue_on_a_shape_no_kernel_tiles_matches_jax():
    """N = 200 (not a multiple of 128): JAX composes the whole epilogue
    with XLA; the port runs K1 into f32 and the same tail."""
    assert _epilogue_case("Q4_0", "float32", 24, 128, 200, True, True).kernel == "xla"


# --- the slice: bge-large at full width, 2 layers ------------------------------

def test_preset_matches_jax_config():
    """BGE_LARGE_EN is the port's preset only; the JAX side builds the same
    BertConfig field by field."""
    ours = BGE_LARGE_EN
    theirs = JConfig(n_vocab=30522, n_ctx=512, n_embd=1024, n_layer=24, n_head=16,
                     n_ff=4096, layer_norm_eps=1e-12, gelu="erf", pooling="cls",
                     name="bge-large-en-v1.5")
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert (ours.head_dim, ours.arch, ours.normalize) == (64, "bert", True)


@pytest.fixture(scope="module")
def bge2():
    """(JAX Q8_0 parameters in f32, the port's carried across)."""
    jp = jax_random_params(JConfig(**BGE2), J_FTYPES["q8_0"], seed=0)
    return jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp))


def test_q8_params_load_as_jax_does(bge2):
    """Every BERT tensor of the full-width Q8_0 model, the word table's rows
    included, built by the port from the same seed equals JAX's leaf for
    leaf."""
    _, tp = bge2
    ours = random_params(BertConfig(**BGE2), "q8_0", seed=0)
    assert_params_equal(ours, tp)
    for key in ("q_w", "ffn_up_w", "ffn_down_w"):
        assert ours["layers"][key].qtype == GGMLType.Q8_0
    assert ours["embeddings"]["word"].qtype == GGMLType.Q8_0


@pytest.fixture
def k8_calls(monkeypatch):
    """JAX's `_q4_matmul_2d` wrapped by a spy that counts its executions
    (a debug callback after each call runs once per layer of the scan)."""
    calls = []
    real = jq4._q4_matmul_2d

    def spy(*args, **kw):
        out = real(*args, **kw)
        jax.debug.callback(lambda _: calls.append(1), out[0, 0])
        return out

    monkeypatch.setattr(jq4, "_q4_matmul_2d", spy)
    return calls


def _batch(b: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, BGE2["n_vocab"], (b, s)).astype(np.int32)
    lens = [s] + [int(n) for n in rng.integers(1, s, b - 1)]
    mask = (np.arange(s)[None, :] < np.array(lens)[:, None]).astype(np.int32)
    ids[mask == 0] = 0
    return ids, mask


def _packed(s: int, seed: int):
    """Two packed rows of 3..40-token segments with padded tails."""
    rng = np.random.default_rng(seed)
    seg = np.full((2, s), -1, np.int32)
    pos = np.zeros((2, s), np.int32)
    for row in range(2):
        c = g = 0
        while True:
            n = int(rng.integers(3, 41))
            if c + n > s - 8:
                break
            seg[row, c:c + n], pos[row, c:c + n] = g, np.arange(n)
            c, g = c + n, g + 1
    ids = rng.integers(5, BGE2["n_vocab"], (2, s)).astype(np.int32)
    ids[seg < 0] = 0
    return ids, seg, pos, int(seg.max()) + 1


def test_embed_batch_matches_jax(bge2, k8_calls):
    jp, tp = bge2
    ids, mask = _batch(2, 128, seed=1)
    ref = np.asarray(jax_embed_batch(jp, jnp.asarray(ids), jnp.asarray(mask),
                                     JConfig(**BGE2), JOpts(dtype="float32", **PALLAS)))
    jax.effects_barrier()
    assert len(k8_calls) == 2 * BGE2["n_layer"]  # up and down in every layer
    got = bert_embed_batch(tp, torch.from_numpy(ids), torch.from_numpy(mask),
                           BertConfig(**BGE2)).numpy()
    assert got.shape == (2, 1024)
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_embed_packed_matches_jax(bge2, k8_calls):
    jp, tp = bge2
    ids, seg, pos, n_seg = _packed(128, seed=2)
    ref = np.asarray(jax_embed_packed(jp, *map(jnp.asarray, (ids, seg, pos)), JConfig(**BGE2),
                                      JOpts(dtype="float32", **PALLAS), n_seg=n_seg))
    jax.effects_barrier()
    assert len(k8_calls) == 2 * BGE2["n_layer"]
    got = bert_embed_packed(tp, *map(torch.from_numpy, (ids, seg, pos)), BertConfig(**BGE2),
                            n_seg=n_seg).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)


def _cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, -1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def test_bf16_tracks_jax():
    """bf16 activations on both sides, each on its own route (the port's
    K8 plain version, JAX's `_q4_matmul_2d`): min cosine 0.999."""
    config = BertConfig(**BGE2)
    jp = jax_random_params(JConfig(**BGE2), J_FTYPES["q8_0"], seed=0, dense_dtype=jnp.bfloat16)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    ids, mask = _batch(2, 128, seed=3)
    ref = np.asarray(jax_embed_batch(jp, jnp.asarray(ids), jnp.asarray(mask), JConfig(**BGE2),
                                     JOpts(dtype="bfloat16", **PALLAS)))
    got = bert_embed_batch(tp, torch.from_numpy(ids), torch.from_numpy(mask), config,
                           ComputeOptions(dtype="bfloat16")).numpy()
    assert _cosines(got, ref).min() >= COSINE


# --- the Engine ------------------------------------------------------------------

def _texts(n: int, lo: int, hi: int, seed: int) -> list[str]:
    from embedding_cpp_tpu_torch.tokenizer.testvocab import _COMMON_WORDS

    rng = np.random.default_rng(seed)
    words = np.array(_COMMON_WORDS)
    return [" ".join(rng.choice(words, size=int(rng.integers(lo, hi)))) for _ in range(n)]


def _write_gguf(path: str, config: JConfig, **kw) -> str:
    from embedding_cpp_tpu.models.convert import write_bert_gguf
    from embedding_cpp_tpu.models.params import random_state_dict
    from embedding_cpp_tpu.tokenizer.testvocab import build_tokenizer_json

    write_bert_gguf(path, config, random_state_dict(config, seed=0),
                    build_tokenizer_json(config.n_vocab), J_FTYPES["q8_0"], **kw)
    return path


@pytest.fixture(scope="module")
def bge2_engines(tmp_path_factory):
    """bge-large at 2 layers in a Q8_0 GGUF through both engines (the JAX
    engine with fewer row buckets: its CPU attention holds whole [B, H, S,
    S] score tensors, and a padded row changes no result)."""
    from embedding_cpp_tpu.runtime.engine import Engine as JEngine
    from embedding_cpp_tpu_torch import Engine

    path = _write_gguf(str(tmp_path_factory.mktemp("gguf") / "bge2-q8_0.gguf"),
                       JConfig(**BGE2))
    return (Engine.from_gguf(path, device="cpu"),
            JEngine.from_gguf(path, batch_buckets=(1, 2, 8, 64, 512, 2048)))


@pytest.mark.parametrize("n,lo,hi", [(40, 3, 14), (6, 20, 90)], ids=["packed", "plain"])
def test_engine_matches_jax(bge2_engines, n, lo, hi):
    ours, theirs = bge2_engines
    assert ours.config.pooling == "cls" and ours.config.n_embd == 1024
    texts = _texts(n, lo, hi, seed=n)
    ids = ours.tokenize_batch(texts)
    assert ids == theirs.tokenize_batch(texts)
    plan = ours._pack_plan(ids)
    assert plan == theirs._pack_plan(ids) and bool(plan) == (n >= 32)
    got, ref = ours.encode(texts), theirs.encode(texts)
    assert got.shape == ref.shape == (n, 1024)
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)


# a tiny CLS-pooled BERT in Q8_0 with e5's named prompts
TINY = dict(n_vocab=1000, n_ctx=64, n_embd=64, n_layer=2, n_head=4, n_ff=256, pooling="cls",
            name="tiny-q8-cls")
PROMPTS = {"query": "query: ", "passage": "passage: "}


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    return _write_gguf(str(tmp_path_factory.mktemp("gguf") / "tiny-q8_0.gguf"),
                       JConfig(**TINY), prompts=PROMPTS)


@pytest.fixture(scope="module")
def tiny_engines(tiny_gguf):
    from embedding_cpp_tpu.runtime.engine import Engine as JEngine
    from embedding_cpp_tpu_torch import Engine

    return Engine.from_gguf(tiny_gguf, device="cpu"), JEngine.from_gguf(tiny_gguf)


def test_q8_gguf_round_trip(tiny_engines):
    """The same Q8_0 file through both loaders: the same config, the same
    QTensor leaves bit for bit, embeddings within 2e-5."""
    ours, theirs = tiny_engines
    for f in dataclasses.fields(ours.config):
        assert getattr(ours.config, f.name) == getattr(theirs.config, f.name), f.name
    assert_params_equal(ours.params, from_jax_params(
        jax.tree_util.tree_map(np.asarray, theirs.params)))
    assert ours.params["layers"]["ffn_up_w"].qtype == GGMLType.Q8_0
    texts = _texts(5, 2, 30, seed=3)
    np.testing.assert_allclose(ours.encode(texts), theirs.encode(texts), rtol=0, atol=F32_ATOL)


def test_prompt_prefixes_match_jax(tiny_engines):
    ours, theirs = tiny_engines
    assert ours.prompts == PROMPTS and ours.default_prompt_name == ""
    assert ours.query_prompt_prefix() == theirs.query_prompt_prefix() == "query: "
    assert ours.document_prompt_prefix() == theirs.document_prompt_prefix() == "passage: "
    plain = type(ours)(ours.params, ours.config, ours.tokenizer, ours.special_ids,
                       device="cpu", prompts={"document": "doc: ", "other": "x "},
                       default_prompt_name="other")
    assert plain.query_prompt_prefix() == "x " and plain.document_prompt_prefix() == "doc: "


@pytest.mark.parametrize("helper", ["encode_queries", "encode_documents"])
def test_retrieval_helpers_match_jax(tiny_engines, helper):
    ours, theirs = tiny_engines
    texts = _texts(4, 2, 20, seed=5)
    for kw in ({}, {"dimensions": 32}):
        got, ref = getattr(ours, helper)(texts, **kw), getattr(theirs, helper)(texts, **kw)
        assert got.shape == ref.shape == (4, kw.get("dimensions", 64))
        np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)
    prefix = PROMPTS["query" if helper == "encode_queries" else "passage"]
    np.testing.assert_array_equal(getattr(ours, helper)(texts),
                                  ours.encode([prefix + t for t in texts]))


def test_encode_with_counts_matches_jax(tiny_engines):
    ours, theirs = tiny_engines
    texts = _texts(5, 1, 80, seed=7)  # the longest cut to the 64-token context
    for kw in ({}, {"prompt_name": "query"}, {"prompt": "x: ", "dimensions": 16}):
        got, counts = ours.encode_with_counts(texts, **kw)
        ref, ref_counts = theirs.encode_with_counts(texts, **kw)
        assert counts == ref_counts
        assert counts == [len(t) for t in ours.tokenize_batch(
            [ours.resolve_prompt(kw.get("prompt_name"), kw.get("prompt")) + t for t in texts])]
        np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)
    assert max(ours.encode_with_counts(texts)[1]) == 64
    one, n = ours.encode_with_counts("hello world")
    assert one.shape == (1, 64) and n == theirs.encode_with_counts("hello world")[1]


def test_truncate_false_raises_as_jax_does(tiny_engines):
    ours, theirs = tiny_engines
    fits = " ".join(["word"] * 62)   # 62 + [CLS] + [SEP] = 64 tokens
    over = " ".join(["word"] * 63)
    for eng in (ours, theirs):
        assert len(eng.tokenize_batch([fits], truncate=False)[0]) == 64
        with pytest.raises(ValueError, match="input 1 is 65 tokens"):
            eng.encode(["a b", over], truncate=False)
        with pytest.raises(ValueError, match="over the model's 64-token context"):
            eng.encode_queries([fits], truncate=False)  # the prefix pushes it over
    np.testing.assert_allclose(ours.encode([fits], truncate=False),
                               theirs.encode([fits], truncate=False), rtol=0, atol=F32_ATOL)
    assert ours.encode([over]).shape == (1, 64)  # truncate=True cuts it
