"""The port's GGUF writer against the JAX package's: for the same kv pairs
and tensors the two files are equal byte for byte, and each package's
reader reads the other's file to the same kvs and tensor bytes."""
import filecmp

import numpy as np
import pytest

from embedding_cpp_tpu.gguf import constants as jconst
from embedding_cpp_tpu.gguf.reader import GGUFReader as JReader
from embedding_cpp_tpu.gguf.writer import GGUFWriter as JWriter
from embedding_cpp_tpu_torch.gguf import constants as tconst
from embedding_cpp_tpu_torch.gguf.quant import quantize
from embedding_cpp_tpu_torch.gguf.reader import GGUFReader as TReader
from embedding_cpp_tpu_torch.gguf.writer import GGUFWriter as TWriter

V = tconst.GGUFValueType


def _fill(w, jax: bool) -> None:
    """Every value type, typed and inferred, arrays of each element type,
    and f32 / f16 / int / Q4_0 / Q8_0 tensors of odd sizes (the alignment
    padding between them)."""
    const = jconst if jax else tconst
    vt = const.GGUFValueType
    rng = np.random.default_rng(0)
    scalars = {vt.UINT8: 200, vt.INT8: -7, vt.UINT16: 60000, vt.INT16: -300,
               vt.UINT32: 4_000_000_000, vt.INT32: -5, vt.FLOAT32: 0.125, vt.BOOL: True,
               vt.UINT64: 2**40, vt.INT64: -(2**40), vt.FLOAT64: 1e-300}
    for t, v in scalars.items():
        w.add_kv(f"typed.{t.name.lower()}", v, t)
    for key, v in (("inferred.bool", False), ("inferred.uint", 7), ("inferred.int", -7),
                   ("inferred.float", 2.5), ("inferred.str", "héllo"),
                   ("inferred.bytes", b"\x00raw")):
        w.add_kv(key, v)
    w.add_uint32("u32", 3)
    w.add_float32("f32", 1.5)
    w.add_string("s", "x" * 33)
    w.add_bool("b", True)
    w.add_array("arr.str", ["a", "", "ünï"], vt.STRING)
    w.add_array("arr.f32", [0.0, -1.5, 3.25], vt.FLOAT32)
    w.add_array("arr.i32", [1, -2, 3], vt.INT32)
    w.add_array("arr.u8", [1, 2, 255], vt.UINT8)
    w.add_array("arr.empty", [], vt.UINT32)
    w.add_tensor("t.f32", rng.standard_normal((3, 5)).astype(np.float32))
    w.add_tensor("t.f16", rng.standard_normal((7,)).astype(np.float16))
    w.add_tensor("t.i32", np.arange(5, dtype=np.int32))
    w.add_tensor("t.i8", np.arange(-3, 2, dtype=np.int8))
    w.add_tensor("t.i16", np.arange(3, dtype=np.int16))
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w.add_tensor_raw("t.q4_0", (4, 64), const.GGMLType.Q4_0,
                     quantize(x.reshape(-1), tconst.GGMLType.Q4_0))
    w.add_tensor_raw("t.q8_0", (2, 32), const.GGMLType.Q8_0,
                     quantize(x[:2, :32].reshape(-1), tconst.GGMLType.Q8_0))


def _kv_equal(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b)) and np.asarray(a).dtype == np.asarray(b).dtype
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("alignment", [32, 64, 8])
def test_file_is_byte_identical_and_read_both_ways(tmp_path, alignment):
    jpath, tpath = tmp_path / "j.gguf", tmp_path / "t.gguf"
    jw, tw = JWriter(alignment=alignment), TWriter(alignment=alignment)
    _fill(jw, True)
    _fill(tw, False)
    if alignment != 32:  # the key the readers take a file's alignment from
        jw.add_uint32("general.alignment", alignment)
        tw.add_uint32("general.alignment", alignment)
    jw.write(str(jpath))
    tw.write(str(tpath))
    assert filecmp.cmp(jpath, tpath, shallow=False)
    for reader_cls, path in ((TReader, jpath), (JReader, tpath)):
        with reader_cls(path) as r, JReader(jpath) as ref:
            assert r.version == tconst.GGUF_WRITE_VERSION == jconst.GGUF_WRITE_VERSION == 2
            assert list(r.kv) == list(ref.kv)
            assert all(_kv_equal(r.kv[k], ref.kv[k]) for k in ref.kv)
            assert list(r.tensors) == list(ref.tensors)
            for name, info in ref.tensors.items():
                got = r.tensors[name]
                assert (got.shape, int(got.ggml_type), got.offset) == (
                    info.shape, int(info.ggml_type), info.offset)
                assert np.array_equal(r.tensor_raw(name), ref.tensor_raw(name))
                assert got.offset % alignment == 0


@pytest.mark.parametrize("value,vtype", [(True, V.BOOL), (False, V.BOOL), (0, V.UINT32),
                                         (2**31, V.UINT32), (-1, V.INT32), (0.0, V.FLOAT32),
                                         ("", V.STRING), (b"x", V.STRING)])
def test_infer_type_tests_bool_before_int(value, vtype):
    assert TWriter._infer_type(value) == vtype
    assert int(JWriter._infer_type(value)) == int(vtype)


def test_unknown_value_type_and_bad_payload_raise(tmp_path):
    w = TWriter()
    with pytest.raises(TypeError):
        w.add_kv("k", [1, 2])
    with pytest.raises(ValueError, match="payload"):
        w.add_tensor_raw("t", (2, 32), tconst.GGMLType.Q4_0, np.zeros(35, np.uint8))


def test_constants_match_the_jax_package():
    assert tconst.GGUF_WRITE_VERSION == jconst.GGUF_WRITE_VERSION
    assert {t.name: int(t) for t in tconst.GGUFTokenType} == {
        t.name: int(t) for t in jconst.GGUFTokenType}
    for key in ("SOURCE_HF_REPO", "TENSOR_DATA_LAYOUT", "HEAD_COUNT_KV", "ROPE_DIMENSION_COUNT",
                "TOKENIZER_MODEL", "TOKENIZER_TOKEN_TYPE", "TOKENIZER_SCORES", "FILE_TYPE"):
        assert getattr(tconst.Keys, key) == getattr(jconst.Keys, key)
