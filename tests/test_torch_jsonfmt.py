"""The port's HTTP float-mode renderer (`utils/jsonfmt.py` over
`native/jsonfmt/jsonfmt.cpp`) against the JAX package's: the same bytes
from the library, every number parsing back bit-identical as f32,
non-finite values as null, the worst-case widths inside the buffer, and
the Python rendering (library switched off) equal to the JAX package's."""
import json

import numpy as np
import pytest
from torch_native import jax_native, needs_compiler

from embedding_cpp_tpu_torch.utils import jsonfmt

pytestmark = needs_compiler


@pytest.fixture(scope="module")
def jfmt():
    with jax_native("jsonfmt") as module:
        assert module.available()
        yield module


def _matrix(seed: int, n: int = 64, d: int = 96) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) * 10.0 ** rng.integers(-38, 38, (n, d))).astype(
        np.float32)


def _parsed(blob: bytes) -> tuple[list, np.ndarray]:
    data = json.loads(blob)
    return data, np.array([d["embedding"] for d in data], np.float32)


@pytest.mark.parametrize("shape,base", [((64, 96), 0), ((1, 384), 7), ((300, 3), 1 << 40)])
def test_native_bytes_equal_jax_and_parse_back(jfmt, shape, base):
    assert jsonfmt.available()
    v = _matrix(shape[0] + shape[1], *shape)
    got = jsonfmt.embedding_data_json(v, index_base=base)
    assert got == jfmt.embedding_data_json(v, index_base=base)
    data, back = _parsed(got)
    assert [d["index"] for d in data] == list(range(base, base + shape[0]))
    assert np.array_equal(back.view(np.uint32), v.view(np.uint32))


def test_non_finite_values_are_null(jfmt):
    v = np.array([[np.inf, -np.inf, np.nan, 1.5, np.finfo(np.float32).max]], np.float32)
    got = jsonfmt.embedding_data_json(v)
    assert got == jfmt.embedding_data_json(v)
    assert json.loads(got)[0]["embedding"][:4] == [None, None, None, 1.5]


def test_worst_case_widths_fit(jfmt):
    """The widest f32 text and the widest index on every row stay inside
    the buffer the library sizes."""
    v = np.full((50, 200), -1.17549435e-38, np.float32)
    v[:, ::2] = -3.4028235e38
    base = -(1 << 62)
    got = jsonfmt.embedding_data_json(v, index_base=base)
    assert got == jfmt.embedding_data_json(v, index_base=base)
    cap = jsonfmt._load().tpuembed_json_data_cap(*v.shape)
    assert len(got) <= cap
    _, back = _parsed(got)
    assert np.array_equal(back, v)


def test_python_rendering_when_switched_off(jfmt, monkeypatch):
    """Where the library cannot be built, the array is rendered in Python,
    as the JAX package renders it without its library."""
    from embedding_cpp_tpu_torch.utils import native_build

    def unavailable(name):
        raise ImportError(f"native {name} library unavailable")

    v = _matrix(3, 5, 17)
    with monkeypatch.context() as m:
        m.setattr(native_build, "load", unavailable)
        m.setattr(jsonfmt, "_lib", None)
        m.setattr(jsonfmt, "_lib_failed", False)
        assert not jsonfmt.available()
        got = jsonfmt.embedding_data_json(v, index_base=2)
    assert got == jfmt._py_embedding_data(v, 2)
    _, back = _parsed(got)
    assert np.array_equal(back, v)
    assert jsonfmt.available()
    assert np.array_equal(_parsed(jsonfmt.embedding_data_json(v, index_base=2))[1], back)


def test_zero_width_and_bad_shapes():
    assert jsonfmt.embedding_data_json(np.zeros((2, 0), np.float32)) == (
        b'[{"object":"embedding","index":0,"embedding":[]},'
        b'{"object":"embedding","index":1,"embedding":[]}]')
    assert jsonfmt.embedding_data_json(np.zeros((0, 4), np.float32)) == b"[]"
    with pytest.raises(ValueError):
        jsonfmt.embedding_data_json(np.zeros(4, np.float32))
