"""The port's breakdown and A/B scripts and its C ABI example on the CPU
(`embedding_cpp_tpu_torch.benchmarks.{forward_breakdown,
modernbert_breakdown, packed_bse_ab, attn_bias_smoke}`, the kernel suite's
five full-forward modes, `embedding_cpp_tpu_torch.examples.sample_dylib`
with `dylib.cpp`): each `main` at tiny sizes with `--device cpu`, its last
stdout line the JSON it returns with the JAX script's keys and a device
entry; the bias smoke's references against the JAX script's (`_xla_attn`
and its DeBERTa einsum sequence); the C ABI client and the C driver
against the port's CPU server, within 2e-5 of `Engine.encode`."""
import importlib.util
import json
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from embedding_cpp_tpu_torch.benchmarks import (
    attn_bias_smoke,
    forward_breakdown,
    kernels,
    modernbert_breakdown,
    packed_bse_ab,
)
from embedding_cpp_tpu_torch.examples import sample_dylib

REPO = Path(__file__).resolve().parents[1]
CUT = ["--device", "cpu", "--layers", "2", "--vocab", "1000"]
ATOL = 2e-5  # the f32 bar of the JAX package's engine tests


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs: the test workers
    share the host's cores (as tests/test_torch_bench_scripts.py does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _line(capsys, result: dict) -> None:
    """The script printed `result` as its last stdout line, with a device
    entry naming the CPU."""
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(result))
    assert result["device"] == "cpu"


def _jax_script(name: str):
    """The JAX package's benchmarks/<name>.py, loaded under its own name."""
    spec = importlib.util.spec_from_file_location(f"jax_benchmarks_{name}",
                                                  REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scripts_need_a_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (forward_breakdown.main, modernbert_breakdown.main, packed_bse_ab.main,
                 attn_bias_smoke.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--results", ""])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernels.main(["--forward-only"])


def test_results_go_to_an_ignored_directory_outside_benchmarks(tmp_path):
    assert forward_breakdown.RESULTS == REPO / "bench_results"
    assert "bench_results/" in (REPO / ".gitignore").read_text().splitlines()
    kernels.write_result(tmp_path / "r", "x", {"a": 1})
    assert json.loads((tmp_path / "r" / "x.json").read_text()) == {"a": 1}


# --- the breakdowns ----------------------------------------------------------------------

def test_forward_breakdown_main(capsys, tmp_path):
    result = forward_breakdown.main([*CUT, "--batch", "2", "--seq", "32", "--samples", "1",
                                     "--results", str(tmp_path)])
    _line(capsys, result)
    # the JAX script's pieces, K5's named for its layout
    assert set(result["pieces"]) == {"embed+ln", "qkv_proj", "attention_bhsd", "attention",
                                     "o_proj+add&ln", "ffn_pair+add&ln", "pool+head",
                                     "whole_layer", "layers_x2"}
    per_layer = sum(p["us"] * p["per_layer_count"] for p in result["pieces"].values())
    assert result["per_layer_us"] == pytest.approx(per_layer)
    assert result["accounted_pct"] == pytest.approx(
        100 * result["accounted_us"] / result["full_forward_us"])
    assert result["pieces"]["qkv_proj"]["per_layer_count"] == 3
    assert json.loads((tmp_path / "forward_breakdown.json").read_text()) == result


def test_modernbert_breakdown_main(capsys):
    result = modernbert_breakdown.main([*CUT, "--batch", "2", "--seq", "64", "--samples", "1",
                                        "--ab-samples", "1", "--ab-shapes", "2", "64",
                                        "--results", ""])
    _line(capsys, result)
    assert set(result["pieces"]) == {"qkv_proj", "rope(q or k)", "attention_bse", "o_proj+res",
                                     "layernorm", "geglu_trio+res", "whole_layer_global",
                                     "whole_layer_local", "layers_x2"}
    assert result["accounted_pct"] > 0
    for key in ("forward_b2_s64", "forward_b2_s64_packed"):
        ab = result[key]
        assert set(ab) >= {"auto", "plain", "max_abs_diff"}
        assert ab["max_abs_diff"] == 0.0  # both arms are the plain versions on the CPU


# --- packed attention's layouts ------------------------------------------------------------

def test_packed_bse_ab_main(capsys):
    result = packed_bse_ab.main([*CUT, "--batch", "2", "--seq", "128", "--samples", "1",
                                 "--forward-samples", "1", "--results", ""])
    _line(capsys, result)
    assert set(result) == {"platform", "device", "packed_kernel_b2_s128_minilm_geom",
                           "q4_forward_packed_b2_s128", "nomic_forward_packed_b2_s128",
                           "mpnet-base_forward_packed_b2_s128",
                           "gtr-base_forward_packed_b2_s128"}
    k = result["packed_kernel_b2_s128_minilm_geom"]
    assert k["max_err_valid"] <= 1e-6 and k["bse_vs_plain"] <= 1e-6
    assert set(k) >= {"bse", "bhsd"}
    for key in ("q4_forward_packed_b2_s128", "nomic_forward_packed_b2_s128"):
        assert result[key]["max_abs_diff"] <= 1e-5, key
        assert result[key]["bse"]["sentences_per_sec"] > 0


def test_packed_route_is_restored():
    from embedding_cpp_tpu_torch.models import bert, nomic
    from embedding_cpp_tpu_torch.ops.attention import flash_attention_packed_bse

    with pytest.raises(KeyError):
        with packed_bse_ab.packed_route(packed_bse_ab.bhsd_route):
            assert bert.flash_attention_packed_bse is packed_bse_ab.bhsd_route
            assert nomic.flash_attention_packed_bse is packed_bse_ab.bhsd_route
            raise KeyError
    assert bert.flash_attention_packed_bse is flash_attention_packed_bse
    assert nomic.flash_attention_packed_bse is flash_attention_packed_bse


# --- the bias and window smoke -----------------------------------------------------------

def test_attn_bias_smoke_main(capsys):
    result = attn_bias_smoke.main(["--device", "cpu", "--scale", "8", "--results", ""])
    _line(capsys, result)
    assert result["ok"] and result["tolerance"] == 0.06
    assert set(result["cases"]) == {
        "bias_h_mpnet_base", "bias_h_mpnet_base_s384", "bias_h_minilm_d32",
        "bias_bse_mpnet_base", "bias_bse_s384", "bias_1_head_invariant", "local_s1024_w128",
        "local_s2048_w128", "deberta_v3_base_s512", "deberta_v3_base_s384",
        "deberta_small_span_s128"}


def test_attn_bias_smoke_references_match_jax():
    """The einsum references against the JAX script's `_xla_attn` and its
    DeBERTa einsum sequence, on the same bf16 inputs (f32 on both sides up
    to the one p cast)."""
    import jax.numpy as jnp

    from embedding_cpp_tpu.models.deberta import _gather_indices
    from embedding_cpp_tpu.models.deberta import deberta_log_bucket as jax_bucket

    jax_smoke = _jax_script("attn_bias_smoke")
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 48, 3, 16
    f32 = [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3)]
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in f32]
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in bf)
    mb = np.zeros((b, s), np.float32)
    mb[:, 40:] = -1e9
    pb = rng.normal(size=(h, s, s)).astype(np.float32)
    for kw, jkw in (({"pos_bias": torch.from_numpy(pb)}, {"pos_bias": jnp.asarray(pb)}),
                    ({"window": 16}, {"window": 16}), ({}, {})):
        got = attn_bias_smoke.reference_attention(*bf, torch.from_numpy(mb), **kw)
        ref = np.asarray(jax_smoke._xla_attn(jq, jk, jv, jnp.asarray(mb), **jkw), np.float32)
        assert np.abs(got.float().numpy() - ref)[:, :40].max() <= 1e-2, kw  # one bf16 ulp

    span, max_dist = 8, 32
    pk, pq = (rng.normal(size=(2 * span, h, d)).astype(np.float32) for _ in range(2))
    got = attn_bias_smoke.reference_deberta(*bf, torch.from_numpy(mb),
                                            torch.from_numpy(pk).to(torch.bfloat16),
                                            torch.from_numpy(pq).to(torch.bfloat16), span,
                                            max_dist)
    rel = jax_bucket(np.arange(s)[:, None] - np.arange(s)[None, :], span, max_dist, xp=np)
    c2p_pos, p2c_pos = _gather_indices(rel, span, xp=np)
    jpk, jpq = (jnp.asarray(a, jnp.bfloat16) for a in (pk, pq))
    scale = 1.0 / float(np.sqrt(d * 3))
    sc = jnp.einsum("bqhd,bkhd->bhqk", jq, jk, preferred_element_type=jnp.float32) * scale
    c2p = jnp.einsum("bqhd,rhd->bhqr", jq, jpk, preferred_element_type=jnp.float32)
    sc = sc + jnp.take_along_axis(c2p, jnp.asarray(c2p_pos)[None, None], axis=-1) * scale
    p2c = jnp.einsum("bkhd,rhd->bhkr", jk, jpq, preferred_element_type=jnp.float32)
    gathered = jnp.take_along_axis(p2c, jnp.asarray(p2c_pos)[None, None], axis=-1)
    sc = sc + jnp.swapaxes(gathered, -1, -2) * scale + jnp.asarray(mb)[:, None, None, :]
    import jax

    p = jax.nn.softmax(sc, axis=-1).astype(jnp.bfloat16)
    ref = np.asarray(jnp.einsum("bhqk,bkhd->bqhd", p, jv, preferred_element_type=jnp.float32)
                     .astype(jnp.bfloat16), np.float32)
    assert np.abs(got.float().numpy() - ref)[:, :40].max() <= 1e-2


# --- the kernel suite's full-forward modes ----------------------------------------------

# each mode's JAX keys at the cut shape [2, 16] (`--shape` makes a mode's
# shapes one), beside the kernel-against-library entries of the card
MODE_KEYS = {
    "forward_only": {"forward_b2_s16"},
    "mpnet_forward": {"mpnet_forward_b2_s16"},
    "bias_ab": {"mpnet-base_forward_b2_s16", "gtr-base_forward_b2_s16",
                "modernbert-base_forward_b2_s16"},
    "nomic_ab": {"nomic_forward_b2_s16"},
    "deberta_ab": {"deberta-base_forward_b2_s16"},
}


@pytest.fixture(scope="module")
def modes_run():
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = kernels.main([*CUT, "--shape", "2", "16", "--samples", "1",
                               *(f"--{m.replace('_', '-')}" for m in kernels.FORWARD_MODES)])
    return result, out.getvalue()


def test_forward_modes_print_their_json(modes_run):
    result, out = modes_run
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(result))
    assert result["device"] == "cpu" and set(result) == {"platform", "device", *MODE_KEYS}


@pytest.mark.parametrize("mode", sorted(MODE_KEYS))
def test_forward_mode_keys(modes_run, mode):
    """The JAX suite's keys; each entry the two arms ("auto" and "plain" on
    the CPU: both the plain versions, equal outputs) in ms and tokens/s."""
    got = modes_run[0][mode]
    assert set(got) == MODE_KEYS[mode]
    for entry in got.values():
        assert entry["max_abs_diff"] == 0.0
        for arm in kernels.ab_impls("cpu"):
            assert entry[arm]["ms"] > 0 and entry[arm]["tokens_per_sec"] > 0


def test_forward_mode_shapes_are_the_jax_suites():
    jax_kernels = _jax_script("kernels")
    import inspect

    src = inspect.getsource(jax_kernels.main)
    for mode, (_, _, cases) in kernels.FORWARD_MODES.items():
        for preset, b, s, _ in cases:
            assert re.search(rf"\({b}, {s}[,)]", src), (mode, b, s)
            assert mode != "bias_ab" or f'"{preset}"' in src


# --- the C ABI example --------------------------------------------------------------------

# what examples/dylib.cpp indexes
DEMO_CORPUS = ["The quick brown fox jumps over the lazy dog",
               "Quantum entanglement cannot transmit information",
               "A fast auburn fox leaps above the sleepy hound"]


def test_sample_dylib_and_dylib_cpp_match_engine_encode(tmp_path, capsys):
    """The port's server (f32, on the CPU, started by the example's
    `start_server`), then the example attached to it: the ctypes client
    and the C driver return what `Engine.encode` returns, within 2e-5 (the
    C driver prints 6 decimals); the client's bert.h calls (tokenize,
    eval, vocab) and the index calls answer as the engine does."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler (g++)")
    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.cli.make_test_model import make_test_model

    gguf = str(tmp_path / "tiny.gguf")
    make_test_model(gguf, "tiny", "f32", seed=0)
    engine = Engine.from_gguf(gguf, device="cpu")
    port = sample_dylib._free_port()
    server = sample_dylib.start_server(gguf, port, "cpu", "float32", tmp_path / "server.log")
    try:
        build = tmp_path / "build"
        result = sample_dylib.main(["--connect", f"127.0.0.1:{port}", "--demo",
                                    "--build-dir", str(build)])
        last = capsys.readouterr().out.strip().splitlines()[-1]
        assert json.loads(last) == json.loads(json.dumps(result))
        assert result["device"] == f"the server at 127.0.0.1:{port}"
        with sample_dylib.TpuEmbedModel("127.0.0.1", port,
                                        str(sample_dylib.build_library(build))) as model:
            ids = model.tokenize("hello tokenized world")
            assert ids == engine.tokenize("hello tokenized world")
            np.testing.assert_allclose(model.eval_tokens([ids]), engine.embed_tokens([ids]),
                                       rtol=0, atol=ATOL)
            assert model.id_to_token(ids[1]) == engine.tokenizer.id_to_token(ids[1])
            # the C driver indexed its 3 documents; 3 more, then the top-2 of a query
            assert model.index(sample_dylib.SENTENCES) == 6
            corpus = engine.encode([*DEMO_CORPUS, *sample_dylib.SENTENCES])
            query = "a speedy fox"
            top, scores = model.search([query], k=2)
            want = np.argsort(-(corpus @ engine.encode([query])[0]))[:2]
            assert top[0].tolist() == want.tolist()
    finally:
        server.terminate()
        server.wait(timeout=30)
    np.testing.assert_allclose(np.asarray(result["embeddings"]),
                               engine.encode(sample_dylib.SENTENCES), rtol=0, atol=ATOL)
    demo = result["demo"]
    assert f"n_embd = {engine.config.n_embd}" in demo
    ref = engine.encode(["Hello from the C ABI", "Embeddings over a GPU engine"])
    rows = re.findall(r"^\[\d\] .*?->((?: [+-]\d\.\d+)+)", demo, re.M)
    assert len(rows) == 2
    for i, row in enumerate(rows):
        np.testing.assert_allclose([float(x) for x in row.split()], ref[i, :6], rtol=0,
                                   atol=5e-7 + ATOL)
    assert re.search(r"^search a speedy fox +-> #\d", demo, re.M)


# --- the nvcc cost of a source -------------------------------------------------------------

def test_nvcc_cost_variant_adds_switch_cases():
    """The variant `nvcc_cost` times: attention_bse.cu with a `case D:` for
    each extra head dim after the switch's last, none twice, the rest of
    the source unchanged."""
    from embedding_cpp_tpu_torch.benchmarks import nvcc_cost
    from embedding_cpp_tpu_torch.ops.attention import HEAD_DIM_INSTANCES

    text = (REPO / "embedding_cpp_tpu_torch" / "csrc" / "attention_bse.cu").read_text()
    got = nvcc_cost.with_dims(text, [48, 96, 80, 112])
    cases = [int(d) for d in re.findall(r"case (\d+): return run", got)]
    assert cases == [*HEAD_DIM_INSTANCES["attention_bse.cu"], 48, 80, 112]
    assert got.replace("\n    case 48: return run(tc::launch<48, SEG>, simt::launch<48, SEG>);"
                       "\n    case 80: return run(tc::launch<80, SEG>, simt::launch<80, SEG>);"
                       "\n    case 112: return run(tc::launch<112, SEG>, simt::launch<112, SEG>);",
                       "") == text
