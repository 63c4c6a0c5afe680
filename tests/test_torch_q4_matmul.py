"""The port's q4_matmul (its plain version, on the CPU) against the JAX
package's q4_matmul through the `_q4_matmul_1d` Pallas kernel, which runs in
interpret mode on the CPU.

Tolerances: f32 to 2e-5 absolute — the JAX kernel builds erf from the
Abramowitz & Stegun polynomial (max error 1.5e-7) where the port uses the
exact erf, and the two sum the K products in different orders.  bf16 by
relative error <= 1e-2 (max |err| / max |ref|): both round the same f32
accumulator to bf16, so an order difference can flip one bf16 rounding
(2^-8 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embedding_cpp_tpu.gguf import GGMLType as JGGMLType
from embedding_cpp_tpu.gguf.quant import quantize as jax_quantize
from embedding_cpp_tpu.ops import qtensor as jqt
from embedding_cpp_tpu.ops.q4_matmul import q4_matmul as jax_q4_matmul
from embedding_cpp_tpu_torch.gguf import GGMLType
from embedding_cpp_tpu_torch.ops import qtensor as tqt
from embedding_cpp_tpu_torch.ops.q4_matmul import dequant_weight, q4_matmul

F32_ATOL = 2e-5
BF16_REL = 1e-2
ACTS = [None, "gelu_erf", "gelu_tanh", "silu"]


def _weights(qtype: str, k: int, n: int, seed: int = 0):
    w = np.random.default_rng(seed).normal(scale=0.05, size=(n, k)).astype(np.float32)
    raw = jax_quantize(w, JGGMLType[qtype])
    if qtype == "Q8_0":
        return jqt.pack_q8_matmul(raw, (n, k)), tqt.pack_q8_matmul(raw, (n, k))
    return (jqt.pack_q4_matmul(raw, (n, k), JGGMLType[qtype]),
            tqt.pack_q4_matmul(raw, (n, k), GGMLType[qtype]))


def _inputs(m: int, k: int, n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    bias = rng.normal(scale=0.1, size=(n,)).astype(np.float32)
    return x, bias


def _run(qtype, m, k, n, act, dtype="float32", out_f32=False, with_bias=True):
    jw, tw = _weights(qtype, k, n)
    x, bias = _inputs(m, k, n)
    jb = jnp.asarray(bias) if with_bias else None
    tb = torch.from_numpy(bias) if with_bias else None
    ref = jax_q4_matmul(jnp.asarray(x, getattr(jnp, dtype)), jw, bias=jb,
                        activation=act, out_f32=out_f32)
    got = q4_matmul(torch.from_numpy(x).to(getattr(torch, dtype)), tw, bias=tb,
                    activation=act, out_f32=out_f32)
    return (np.asarray(jnp.asarray(ref, jnp.float32)), got.to(torch.float32).numpy(),
            ref.dtype, got.dtype)


@pytest.mark.parametrize("qtype", ["Q4_0", "Q4_1", "Q8_0"])
@pytest.mark.parametrize("act", ACTS)
def test_f32_matches_pallas_kernel(qtype, act):
    ref, got, _, dt = _run(qtype, 64, 128, 128, act)
    assert dt == torch.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("qtype", ["Q4_0", "Q4_1", "Q8_0"])
@pytest.mark.parametrize("m,k,n", [(64, 384, 128), (40, 128, 128), (40, 384, 128)])
def test_f32_shapes_match_pallas_kernel(qtype, m, k, n):
    """M = 40 is five JAX tiles of 8 rows (a ragged edge for the CUDA
    kernel's 64-row tiles)."""
    ref, got, _, _ = _run(qtype, m, k, n, "gelu_erf")
    assert got.shape == (m, n)
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("qtype", ["Q4_0", "Q4_1", "Q8_0"])
@pytest.mark.parametrize("act", [None, "gelu_erf"])
def test_bf16_matches_pallas_kernel(qtype, act):
    ref, got, rdt, gdt = _run(qtype, 64, 384, 128, act, dtype="bfloat16")
    assert gdt == torch.bfloat16 and rdt == jnp.bfloat16
    assert np.abs(got - ref).max() / np.abs(ref).max() <= BF16_REL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_out_f32_returns_the_accumulator(dtype):
    ref, got, rdt, gdt = _run("Q4_0", 64, 128, 128, "gelu_tanh", dtype=dtype,
                              out_f32=True)
    assert gdt == torch.float32 and rdt == jnp.float32
    tol = F32_ATOL if dtype == "float32" else 1e-4
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_no_bias_matches_pallas_kernel():
    ref, got, _, _ = _run("Q4_1", 64, 128, 128, "silu", with_bias=False)
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)


def test_dequant_weight_matches_pallas_dequant_tile():
    """The plain version stages the weight as `_dequant_tile` does: f32
    math, one rounding to the compute dtype."""
    from embedding_cpp_tpu.ops.q4_matmul import _dequant_tile

    for qtype in ("Q4_0", "Q4_1", "Q8_0"):
        jw, tw = _weights(qtype, 128, 128)
        for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            ref = _dequant_tile(jw.qs, jw.scales, jw.mins, jd)
            got = dequant_weight(tw, td)
            np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                          np.asarray(jnp.asarray(ref, jnp.float32)))


def test_cpu_tensors_never_launch_and_bad_shapes_raise():
    _, tw = _weights("Q4_0", 128, 128)
    before = q4_matmul.launches
    q4_matmul(torch.zeros(8, 128), tw)
    assert q4_matmul.launches == before
    with pytest.raises(ValueError):
        q4_matmul(torch.zeros(8, 96), tw)  # K does not match the weight
    with pytest.raises(ValueError):
        q4_matmul(torch.zeros(8, 128), tw, activation="relu")


@pytest.mark.parametrize("qtype", ["Q4_0", "Q4_1", "Q8_0"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prologue_mul_matches_pallas_kernel(qtype, dtype):
    """The gated FFN's down projection: (x * g) @ W, the multiply in x's
    dtype on the loaded tiles (JAX `_q4_matmul_1d` with prologue_mul; N a
    multiple of 128 so JAX reaches that kernel)."""
    m, k, n = 64, 256, 128
    jw, tw = _weights(qtype, k, n)
    x, bias = _inputs(m, k, n)
    g = np.random.default_rng(2).normal(size=(m, k)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_q4_matmul(jnp.asarray(x, jd), jw, bias=jnp.asarray(bias),
                        prologue_mul=jnp.asarray(g, jd))
    got = q4_matmul(torch.from_numpy(x).to(td), tw, bias=torch.from_numpy(bias),
                    prologue_mul=torch.from_numpy(g).to(td))
    assert got.dtype == td
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)
    else:
        assert np.abs(got - ref).max() / np.abs(ref).max() <= BF16_REL


def test_prologue_rounds_once_to_the_activation_dtype():
    """bf16 x * bf16 g is exact in f32, so one rounding equals bf16's own
    multiply."""
    from embedding_cpp_tpu_torch.ops.q4_matmul import prologue

    rng = np.random.default_rng(3)
    x, g = (torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    assert torch.equal(prologue(x, g), x * g)
    assert prologue(x, None) is x
    with pytest.raises(ValueError):
        q4_matmul(torch.zeros(8, 128), _weights("Q4_0", 128, 128)[1],
                  prologue_mul=torch.zeros(8, 64))


def test_linear_prologue_on_dense_weights_matches_jax():
    from embedding_cpp_tpu.ops.linear import linear as jax_linear
    from embedding_cpp_tpu_torch.ops.linear import linear

    rng = np.random.default_rng(4)
    x, g = (rng.normal(size=(2, 8, 64)).astype(np.float32) for _ in range(2))
    w = rng.normal(scale=0.05, size=(64, 32)).astype(np.float32)
    res = rng.normal(size=(2, 8, 32)).astype(np.float32)
    ref = jax_linear(jnp.asarray(x), jnp.asarray(w), residual=jnp.asarray(res),
                     prologue_mul=jnp.asarray(g))
    got = linear(torch.from_numpy(x), torch.from_numpy(w), residual=torch.from_numpy(res),
                 prologue_mul=torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=F32_ATOL)
