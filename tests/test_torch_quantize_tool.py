"""The port's GGUF requantizer against the JAX package's `quantize_gguf`:
the same output bytes for f32 -> q4_0 / q4_1 / q8_0 / f16 and q4_0 ->
q8_0 / f16 (every kv copied with its type, `general.file_type` updated;
the eligibility rule; tensors passed through), the same stats and 16-bin
histogram, with both tools on the native codec and both on numpy; and the
quantize CLI with names and numeric codes."""
import contextlib
import dataclasses
import filecmp

import numpy as np
import pytest
from torch_native import has_compiler, jax_native

from embedding_cpp_tpu.cli.make_test_model import make_test_model
from embedding_cpp_tpu.gguf.reader import GGUFReader as JReader
from embedding_cpp_tpu.models.quantize_tool import quantize_gguf as jquantize
from embedding_cpp_tpu_torch.cli.quantize import main as quantize_main
from embedding_cpp_tpu_torch.gguf.reader import GGUFReader
from embedding_cpp_tpu_torch.models.quantize_tool import _q_histogram
from embedding_cpp_tpu_torch.models.quantize_tool import quantize_gguf as tquantize


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """tiny (WordPiece) and tiny-mpnet (its [32, H] bias table is 2-D but not
    a whole number of blocks wide: it must stay f32) at f32 and q4_0."""
    root = tmp_path_factory.mktemp("q")
    out = {}
    for preset in ("tiny", "tiny-mpnet"):
        for ftype in ("f32", "q4_0"):
            out[(preset, ftype)] = root / f"{preset}-{ftype}.gguf"
            make_test_model(str(out[(preset, ftype)]), preset, ftype, seed=1)
    return out


CASES = [("f32", "q4_0"), ("f32", "q4_1"), ("f32", "q8_0"), ("f32", "f16"), ("q4_0", "q8_0"),
         ("q4_0", "f16")]


@pytest.mark.parametrize("preset", ["tiny", "tiny-mpnet"])
@pytest.mark.parametrize("src,target", CASES, ids=[f"{a}-{b}" for a, b in CASES])
def test_output_stats_and_histogram_match_jax(sources, tmp_path, preset, src, target,
                                              monkeypatch):
    """Both tools take the same codec: the native one where a C++ compiler
    builds it, else numpy (the two differ in the sign of a zero from a Q4
    code of 8 under a negative scale)."""
    from embedding_cpp_tpu.gguf import native_codec

    path = str(sources[(preset, src)])
    with contextlib.ExitStack() as stack:
        if has_compiler():
            stack.enter_context(jax_native("codec"))
        else:
            monkeypatch.setattr(native_codec, "available", lambda: False)
        got = tquantize(path, str(tmp_path / "t.gguf"), target, verbose=False)
        want = jquantize(path, str(tmp_path / "j.gguf"), target, verbose=False)
    assert filecmp.cmp(tmp_path / "t.gguf", tmp_path / "j.gguf", shallow=False)
    assert dataclasses.astuple(got)[:4] == dataclasses.astuple(want)[:4]
    assert np.array_equal(got.hist_all, want.hist_all)
    if target in ("q4_0", "q4_1", "q8_0"):
        assert got.hist_all.sum() > 0
    with GGUFReader(tmp_path / "t.gguf") as r, JReader(path) as ref:
        assert r.kv["general.file_type"] == {"q4_0": 2, "q4_1": 3, "q8_0": 7, "f16": 1}[target]
        # every other kv in its order, then the new file type
        assert list(r.kv) == [k for k in ref.kv if k != "general.file_type"] + [
            "general.file_type"]
        # a 2-D weight whose rows are not whole blocks keeps its type
        for name, info in r.tensors.items():
            if not name.endswith("weight") or len(info.shape) != 2:
                assert info.ggml_type == ref.tensors[name].ggml_type


def test_kv_types_are_preserved(sources, tmp_path):
    """Every kv reads back with the same value and type after the copy."""
    path = str(sources[("tiny", "f32")])
    tquantize(path, str(tmp_path / "t.gguf"), "q4_0", verbose=False)
    with GGUFReader(tmp_path / "t.gguf") as a, GGUFReader(path) as b:
        for k, v in b.kv.items():
            if k == "general.file_type":
                continue
            w = a.kv[k]
            if isinstance(v, np.ndarray):
                assert w.dtype == v.dtype and np.array_equal(w, v)
            else:
                assert type(w) is type(v) and w == v


CODECS = [pytest.param("native", marks=pytest.mark.skipif(not has_compiler(),
                                                         reason="no C++ compiler")),
          "numpy"]


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("src,target", [("q4_0", "f16"), ("f32", "q4_0")],
                         ids=["q4_0-f16", "f32-q4_0"])
def test_both_tools_write_the_same_bytes_with_either_codec(sources, tmp_path, monkeypatch,
                                                           codec, src, target):
    """Given the same codec, the port's tool writes the JAX tool's bytes;
    the native codec is each package's own build."""
    from embedding_cpp_tpu.gguf import native_codec as jcodec
    from embedding_cpp_tpu_torch.gguf import native_codec as tcodec

    path = str(sources[("tiny", src)])
    with contextlib.ExitStack() as stack:
        if codec == "native":
            stack.enter_context(jax_native("codec"))
            assert jcodec.available() and tcodec.available()
        else:
            monkeypatch.setattr(jcodec, "available", lambda: False)
            monkeypatch.setattr(tcodec, "available", lambda: False)
        tquantize(path, str(tmp_path / "t.gguf"), target, verbose=False)
        jquantize(path, str(tmp_path / "j.gguf"), target, verbose=False)
    assert filecmp.cmp(tmp_path / "t.gguf", tmp_path / "j.gguf", shallow=False)


@pytest.mark.parametrize("qtype", ["Q4_0", "Q4_1", "Q8_0"])
def test_histogram_matches_jax(qtype):
    from embedding_cpp_tpu.models.quantize_tool import _q_histogram as j_hist
    from embedding_cpp_tpu_torch.gguf.constants import GGMLType
    from embedding_cpp_tpu_torch.gguf.quant import quantize

    x = np.random.default_rng(2).standard_normal(32 * 40).astype(np.float32)
    raw = quantize(x, GGMLType[qtype])
    got = _q_histogram(raw, GGMLType[qtype])
    assert got.sum() == x.size
    assert np.array_equal(got, j_hist(raw, GGMLType[qtype]))


@pytest.mark.parametrize("code,name", [("2", "q4_0"), ("3", "q4_1"), ("7", "q8_0"),
                                       ("q8_0", "q8_0"), ("f16", "f16")])
def test_cli_accepts_names_and_numeric_codes(sources, tmp_path, code, name, capsys):
    path = str(sources[("tiny", "f32")])
    quantize_main([path, str(tmp_path / "t.gguf"), code])
    assert "quantized" in capsys.readouterr().err
    jquantize(path, str(tmp_path / "j.gguf"), name, verbose=False)
    assert filecmp.cmp(tmp_path / "t.gguf", tmp_path / "j.gguf", shallow=False)
    quantize_main([path, str(tmp_path / "q.gguf"), code, "-q"])
    assert capsys.readouterr().err == ""


def test_f16_to_f32_where_the_jax_tool_raises(tmp_path):
    """A deliberate difference: the JAX package's histogram reads the f32
    output as Q4_1 records and raises; the port histograms block types
    only, and writes the f16 weights back as their exact f32 values."""
    from embedding_cpp_tpu_torch.gguf.quant import dequantize

    src = str(tmp_path / "f16.gguf")
    make_test_model(src, "tiny", "f16", seed=1)
    with pytest.raises(ValueError):
        jquantize(src, str(tmp_path / "j.gguf"), "f32", verbose=False)
    stats = tquantize(src, str(tmp_path / "t.gguf"), "f32", verbose=False)
    assert stats.n_quantized > 0 and stats.hist_all.sum() == 0
    with GGUFReader(tmp_path / "t.gguf") as out, GGUFReader(src) as ref:
        assert out.kv["general.file_type"] == 0
        for name, info in ref.tensors.items():
            want = dequantize(ref.tensor_raw(name), info.ggml_type, info.n_elements)
            got = dequantize(out.tensor_raw(name), out.tensors[name].ggml_type, info.n_elements)
            assert out.tensors[name].ggml_type.name == "F32" and np.array_equal(got, want)
