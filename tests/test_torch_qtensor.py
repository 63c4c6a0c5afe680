"""The port's QTensor packing, dequantize and gather_rows against the JAX
package's, bit for bit, on Q4_0 / Q4_1 / Q8_0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embedding_cpp_tpu.gguf import GGMLType as JGGMLType
from embedding_cpp_tpu.gguf.quant import quantize as jax_quantize
from embedding_cpp_tpu.ops import qtensor as jqt
from embedding_cpp_tpu_torch.gguf import GGMLType
from embedding_cpp_tpu_torch.ops import qtensor as tqt

QTYPES = ["Q4_0", "Q4_1", "Q8_0"]


def _raw(qtype: str, shape, seed: int) -> np.ndarray:
    w = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jax_quantize(w, JGGMLType[qtype])


def _pack(mod, kind: str, qtype: str, raw, shape):
    gt = (JGGMLType if mod is jqt else GGMLType)[qtype]
    if qtype == "Q8_0":
        return getattr(mod, f"pack_q8_{kind}")(raw, shape)
    return getattr(mod, f"pack_q4_{kind}")(raw, shape, gt)


def _fields_equal(j, t):
    assert t.shape == j.shape and int(t.qtype) == int(j.qtype)
    np.testing.assert_array_equal(t.qs.numpy(), np.asarray(j.qs))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    assert (t.mins is None) == (j.mins is None)
    if t.mins is not None:
        np.testing.assert_array_equal(t.mins.numpy(), np.asarray(j.mins))


def _as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_pack_and_dequantize_match_jax(qtype, dtype):
    shape = (96, 128)  # [out, in]; blocks along in
    raw = _raw(qtype, shape, seed=0)
    j = _pack(jqt, "matmul", qtype, raw, shape)
    t = _pack(tqt, "matmul", qtype, raw, shape)
    _fields_equal(j, t)
    got = tqt.dequantize(t, dtype=getattr(torch, dtype))
    ref = jqt.dequantize(j, dtype=getattr(jnp, dtype))
    assert got.shape == (128, 96)
    np.testing.assert_array_equal(_as_f32(got), _as_f32(ref))


@pytest.mark.parametrize("qtype", QTYPES)
def test_stacked_dequantize_matches_jax(qtype):
    """Layer-stacked leaves (leading layer axis) dequantize identically."""
    shape = (64, 64)
    js, ts = [], []
    for seed in range(3):
        raw = _raw(qtype, shape, seed)
        js.append(_pack(jqt, "matmul", qtype, raw, shape))
        ts.append(_pack(tqt, "matmul", qtype, raw, shape))
    j = jqt.QTensor(
        qs=jnp.stack([x.qs for x in js]), scales=jnp.stack([x.scales for x in js]),
        mins=None if js[0].mins is None else jnp.stack([x.mins for x in js]),
        shape=js[0].shape, qtype=js[0].qtype,
    )
    t = tqt.QTensor(
        qs=torch.stack([x.qs for x in ts]), scales=torch.stack([x.scales for x in ts]),
        mins=None if ts[0].mins is None else torch.stack([x.mins for x in ts]),
        shape=ts[0].shape, qtype=ts[0].qtype,
    )
    np.testing.assert_array_equal(tqt.dequantize(t).numpy(), np.asarray(jqt.dequantize(j)))
    np.testing.assert_array_equal(tqt.dequantize(t[1]).numpy(),
                                  np.asarray(jqt.dequantize(js[1])))


@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_pack_and_gather_match_jax(qtype, dtype):
    shape = (50, 64)  # [vocab, n_embd]
    raw = _raw(qtype, shape, seed=1)
    j = _pack(jqt, "rows", qtype, raw, shape)
    t = _pack(tqt, "rows", qtype, raw, shape)
    _fields_equal(j, t)
    ids = np.array([[0, 3, 49], [7, 7, 1]], dtype=np.int32)
    got = tqt.gather_rows(t, torch.from_numpy(ids).long(), dtype=getattr(torch, dtype))
    ref = jqt.gather_rows(j, jnp.asarray(ids), dtype=getattr(jnp, dtype))
    assert got.shape == (2, 3, 64)
    np.testing.assert_array_equal(_as_f32(got), _as_f32(ref))


def test_qtensor_map_and_index():
    raw = _raw("Q4_1", (64, 64), seed=2)
    t = _pack(tqt, "matmul", "Q4_1", raw, (64, 64))
    stacked = t.map(lambda x: torch.stack([x, x]))
    one = stacked[1]
    assert one.shape == t.shape and one.qtype == t.qtype
    assert torch.equal(one.qs, t.qs) and torch.equal(one.mins, t.mins)
