"""The port's native codec (`gguf/native_codec.py` over `native/gguf/
codec.cpp`) against the JAX package's native codec, bit for bit, over f32,
f16, Q4_0, Q4_1 and Q8_0 (quantize, dequantize and every requantize
pair), and against the port's numpy codecs, which it equals but for the
sign of a zero; its short-buffer guards and its off switch."""
import numpy as np
import pytest
from torch_native import jax_native, needs_compiler

from embedding_cpp_tpu_torch.gguf import native_codec as nc
from embedding_cpp_tpu_torch.gguf.constants import GGMLType
from embedding_cpp_tpu_torch.gguf.quant import dequantize, quantize

pytestmark = needs_compiler

TYPES = ("F32", "F16", "Q4_0", "Q4_1", "Q8_0")


@pytest.fixture(scope="module")
def jnc():
    with jax_native("codec") as module:
        yield module


def _values(seed: int, n: int = 1 << 12) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * np.float32(10.0) ** rng.integers(-6, 5, n)
    x[:64] = 0.0  # all-zero blocks
    x[64:96] = -x[64:96]
    return x.astype(np.float32)


@pytest.mark.parametrize("qtype", TYPES)
def test_quantize_and_dequantize_match_jax(jnc, qtype):
    from embedding_cpp_tpu.gguf.constants import GGMLType as JType

    x = _values(1)
    got = nc.quantize(x, GGMLType[qtype])
    assert np.array_equal(got, jnc.quantize(x, JType[qtype]))
    back = nc.dequantize(got, GGMLType[qtype], x.size)
    assert np.array_equal(back.view(np.uint32),
                          jnc.dequantize(got, JType[qtype], x.size).view(np.uint32))


@pytest.mark.parametrize("dst", TYPES)
@pytest.mark.parametrize("src", TYPES)
def test_requantize_matches_jax(jnc, src, dst):
    from embedding_cpp_tpu.gguf.constants import GGMLType as JType

    x = _values(2)
    raw = nc.quantize(x, GGMLType[src])
    got = nc.requantize(raw, GGMLType[src], x.size, GGMLType[dst], n_threads=3)
    want = jnc.requantize(raw, JType[src], x.size, JType[dst], n_threads=3)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("qtype", TYPES)
def test_equals_numpy_codec_but_for_the_sign_of_zero(qtype):
    """Quantizing is bit-exact with numpy; dequantizing too, except that a
    Q4 code of 8 under a negative scale is -0.0 in numpy and +0.0 here."""
    x = _values(3)
    raw = quantize(x, GGMLType[qtype])
    assert np.array_equal(nc.quantize(x, GGMLType[qtype]), raw)
    got = nc.dequantize(raw, GGMLType[qtype], x.size).view(np.uint32)
    want = dequantize(raw, GGMLType[qtype], x.size).view(np.uint32)
    differ = got != want
    assert np.all(got[differ] == 0) and np.all(want[differ] == 0x80000000)
    if qtype == "Q4_0":
        assert differ.any()  # this data meets a code of 8 under a negative scale
    elif qtype != "Q4_1":
        assert not differ.any()


def test_q4_to_f16_differs_from_numpy_only_in_the_sign_of_zero():
    """The quantizer's Q4_0 -> f16 through each codec: the native codec
    writes +0.0 where numpy writes -0.0, and nothing else differs."""
    x = _values(4)
    raw = quantize(x, GGMLType.Q4_0)
    got = nc.requantize(raw, GGMLType.Q4_0, x.size, GGMLType.F16).view(np.uint16)
    want = quantize(dequantize(raw, GGMLType.Q4_0, x.size), GGMLType.F16).view(np.uint16)
    differ = got != want
    assert differ.any()
    assert np.all(got[differ] == 0) and np.all(want[differ] == 0x8000)


def test_short_buffers_are_refused():
    x = _values(5, 256)
    raw = nc.quantize(x, GGMLType.Q4_0)
    with pytest.raises(ValueError, match="too small"):
        nc.dequantize(raw[:-1], GGMLType.Q4_0, x.size)
    with pytest.raises(ValueError, match="too small"):
        nc.requantize(raw[:-1], GGMLType.Q4_0, x.size, GGMLType.F16)
    with pytest.raises(ValueError):
        nc.quantize(np.zeros(33, np.float32), GGMLType.Q4_0)


def test_off_switch(monkeypatch):
    """Where the library cannot be built, `available()` is false and a call
    raises ImportError (the quantizer then takes the numpy codecs)."""
    from embedding_cpp_tpu_torch.utils import native_build

    def unavailable(name):
        raise ImportError(f"native {name} library unavailable")

    assert nc.available()
    with monkeypatch.context() as m:
        m.setattr(native_build, "load", unavailable)
        m.setattr(nc, "_lib", None)
        assert not nc.available()
        with pytest.raises(ImportError):
            nc.quantize(np.zeros(32, np.float32), GGMLType.Q8_0)
    assert nc.available()
