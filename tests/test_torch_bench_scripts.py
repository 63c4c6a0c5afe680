"""The port's user-level measurement scripts and examples on the CPU
(`embedding_cpp_tpu_torch.benchmarks.{bench, serving, scaling, search,
sparse, maxsim_bench}` and `embedding_cpp_tpu_torch.examples`): the
headline corpus against the JAX package's bench.py, each script's `main`
at tiny sizes printing its JSON line with the JAX script's keys, the
served replies against `Engine.encode` over TCP (f32 and int8 wire) and
HTTP, the examples against a direct index search, and `run_eval`'s sbert
mode against its f32 mode on an HF directory built in code."""
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

from embedding_cpp_tpu_torch.benchmarks import (  # noqa: E402
    bench,
    maxsim_bench,
    run_eval,
    scaling,
    search,
    serving,
    sparse,
)
from embedding_cpp_tpu_torch.benchmarks.serving import embed_http, serving as served  # noqa: E402

# The keys of each JAX script's JSON line (bench.py, benchmarks/*.py).
JAX_KEYS = {
    "headline": {"metric", "value", "unit", "vs_baseline", "transfer",
                 "f32_sentences_per_sec", "f32_vs_baseline", "int8_cosine_vs_f32_mean",
                 "int8_cosine_vs_f32_min"},
    "bench": {"metric", "value", "unit", "vs_baseline"},
    "ab_transfer": {"metric", "value", "unit", "vs_baseline", "platform", "per_output_dtype"},
    "serving": {"metric", "value", "unit", "clients", "platform", "wire"},
    "overhead_ab": {"metric", "direct_sentences_per_sec", "served_sentences_per_sec", "tax_pct",
                    "rounds", "direct_all", "served_all"},
    "scaling": {"metric", "platform", "processes", "batch_per_device", "seq", "results"},
    "search": {"metric", "value", "unit", "corpus", "dim", "k", "kernel_us_per_batch_exact",
               "kernel_us_per_batch_approx", "approx_queries_per_sec",
               "end_to_end_ms_per_batch", "ingest_docs_per_sec", "platform"},
    "sparse": {"metric", "value", "unit", "batch", "seq", "k", "ftype", "kernel_ms_per_batch",
               "platform", "end_to_end_sentences_per_sec", "maxsim_docs_per_sec"},
    "sparse_search": {"platform", "docs", "nnz", "n_vocab", "queries", "k", "host_s_per_batch",
                      "device_kernel_ms_per_batch", "speedup_vs_host", "device_end_to_end_ms",
                      "ingest_s", "topk_agreement", "candidates_256", "candidates_1024"},
    "maxsim": {"platform", "docs", "doc_maxlen", "corpus_tokens", "dim", "queries", "q_tokens",
               "k", "kernel_ms_per_batch", "kernel_tflops", "queries_per_sec", "end_to_end_ms",
               "index_add_s", "ingest_docs_per_sec"},
}
TINY = ["--device", "cpu", "--preset", "tiny"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs: the test workers
    share the host's cores, and the plain versions' many small ops only
    contend for them (as tests/test_torch_attention_tiles.py does)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _line(capsys, result: dict, keys: str) -> None:
    """The script printed `result` as its last stdout line, with the JAX
    script's keys and a device entry."""
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(result))
    assert JAX_KEYS[keys] <= set(result), JAX_KEYS[keys] - set(result)
    assert result["device"] == "cpu"


# --- the headline bench --------------------------------------------------------------

@pytest.mark.parametrize("profile", ["stsb", "long"])
def test_synthetic_sentences_equal_jax_bench(profile):
    sys.path.insert(0, str(REPO))
    import bench as jax_bench

    for seed in (0, 3):
        assert bench.synthetic_sentences(200, seed, profile) == jax_bench.synthetic_sentences(
            200, seed, profile)


def test_baselines_equal_jax_bench():
    sys.path.insert(0, str(REPO))
    import bench as jax_bench

    assert bench.BASELINES == jax_bench.BASELINES
    assert bench.LENGTH_PROFILES == jax_bench.LENGTH_PROFILES
    assert "CPU" in bench.BASELINE_SOURCE


def test_chip_smoke_uses_the_headline_corpus_and_inputs():
    import chip_smoke

    assert chip_smoke.synthetic_sentences is bench.synthetic_sentences
    assert chip_smoke.forward_inputs is bench.forward_inputs


def test_forward_inputs_are_the_serving_rows():
    from embedding_cpp_tpu_torch.benchmarks.profiles import serving_segments

    ids, mask, pids, seg, pos = bench.forward_inputs(1000, "cpu", b=4, s=64, seed=5)
    rng = np.random.default_rng(5)
    assert np.array_equal(ids.numpy(), rng.integers(0, 1000, (4, 64)))
    want_seg, want_pos = serving_segments(rng, 4, 64)
    assert np.array_equal(seg.numpy(), want_seg) and np.array_equal(pos.numpy(), want_pos)
    assert (pids.numpy()[want_seg < 0] == 0).all() and (pids.numpy()[want_seg >= 0] > 0).all()
    assert mask.shape == (4, 64) and int(mask.min()) == 1


def test_headline_main(capsys):
    result = bench.main([*TINY, "--sentences", "48", "--repeats", "1"])
    _line(capsys, result, "headline")
    assert result["metric"] == "sentences_per_sec_chip_tiny_q4_0"
    assert result["int8_cosine_vs_f32_min"] > 0.99 and result["value"] > 0
    assert "forward_ms_in_device_b32_s512" not in result  # the card only


def test_bench_forced_output_dtype_main(capsys):
    result = bench.main([*TINY, "--sentences", "32", "--repeats", "1", "--output-dtype",
                         "float16", "--length-profile", "long"])
    _line(capsys, result, "bench")
    assert result["metric"] == "sentences_per_sec_chip_tiny_q4_0_long"


def test_ab_transfer_main(capsys):
    result = bench.main([*TINY, "--sentences", "32", "--repeats", "1", "--ab-transfer"])
    _line(capsys, result, "ab_transfer")
    assert set(result["per_output_dtype"]) == {"float32", "float16", "int8"}


def test_scripts_need_a_card_without_device():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (bench.main, serving.main, search.main, sparse.main, maxsim_bench.main,
                 scaling.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])


# --- serving ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,keys", [
    ([], "serving"),
    (["--wire", "int8"], "serving"),
    (["--protocol", "http", "--http-encoding", "base64"], "serving"),
    (["--protocol", "http"], "serving"),
    (["--overhead-ab", "--rounds", "1"], "overhead_ab"),
    (["--dp", "2", "--tp", "2"], "serving"),
])
def test_serving_main(capsys, argv, keys):
    result = serving.main([*TINY, "--clients", "2", "--batch", "16", "--sentences", "48", *argv])
    _line(capsys, result, keys)
    bar = 0.999 if "int8" in argv else 0.9999
    assert result["min_cosine_vs_encode"] >= bar
    if keys == "serving":
        assert result["value"] > 0 and result["served"] == 2 * 48
    if "--dp" in argv:
        assert result["metric"].endswith("_dp2_tp2")
    if "http" in argv:
        assert "_http" in result["metric"]


@pytest.fixture(scope="module")
def tiny_engine():
    from embedding_cpp_tpu_torch.cli.make_test_model import PRESETS
    from embedding_cpp_tpu_torch.runtime.engine import Engine

    return Engine.synthetic(PRESETS["tiny"], "q4_0", device="cpu")


def test_served_replies_equal_engine_encode(tiny_engine):
    """Every reply of the serving script's paths against Engine.encode of the
    same texts: TCP f32 and int8 wire, HTTP float and base64."""
    import http.client

    from embedding_cpp_tpu_torch.runtime.client import EmbeddingClient

    texts = bench.synthetic_sentences(96, seed=4)
    chunks = [texts[i: i + 32] for i in range(0, len(texts), 32)]
    want = tiny_engine.encode(texts)
    http_port = serving.free_port()
    with served(tiny_engine, http_port=http_port) as port:
        with EmbeddingClient("127.0.0.1", port) as c:
            got = {w: np.concatenate([c.embed(ch, wire=w) for ch in chunks])
                   for w in ("f32", "int8")}
        conn = http.client.HTTPConnection("127.0.0.1", http_port, timeout=60)
        for enc in ("float", "base64"):
            got[enc] = np.concatenate([embed_http(conn, ch, enc) for ch in chunks])
        conn.close()
    for key, vecs in got.items():
        cos = np.sum(vecs * want, -1) / np.linalg.norm(vecs, axis=-1)
        assert cos.min() >= (0.999 if key == "int8" else 0.9999), key
    np.testing.assert_array_equal(got["base64"], got["f32"])


# --- scaling, search, sparse, maxsim --------------------------------------------------------

def test_scaling_main(capsys):
    result = scaling.main(["--device", "cpu", "--batch-per-device", "2", "--seq", "16",
                           "--iters", "1", "--dp", "1", "2", "--tp", "2"])
    _line(capsys, result, "scaling")
    assert set(result["results"]) == {1, 2}
    assert all("efficiency" not in r for r in result["results"].values())
    assert "one after another" in result["slots"] and result["tp"] == 2


def test_search_main(capsys):
    result = search.main(["--device", "cpu", "--corpus", "2048", "--queries", "8", "--iters",
                          "2", "--ingest-docs", "64"])
    _line(capsys, result, "search")
    assert "exact selection" in result["approx"]


def test_sparse_main(capsys):
    result = sparse.main(["--device", "cpu", "--batch", "2", "--seq", "16", "--layers", "1",
                          "--vocab", "1000", "--iters", "1", "--texts", "8", "--k", "32"])
    _line(capsys, result, "sparse")
    assert result["kernel_ms_per_batch"] > 0 and result["maxsim_docs_per_sec"] > 0


def test_sparse_search_main(capsys):
    result = sparse.main(["--device", "cpu", "--search", "--docs", "3000", "--nnz", "16",
                          "--vocab", "2000", "--iters", "1"])
    _line(capsys, result, "sparse_search")
    assert result["topk_agreement"] == 1.0
    assert result["candidates_1024"]["recall_at_k_vs_exact"] > 0.5


def test_maxsim_bench_main(capsys):
    result = maxsim_bench.main(["--device", "cpu", "--docs", "128", "--doc-maxlen", "16",
                                "--dim", "32", "--queries", "4", "--q-tokens", "8", "--iters",
                                "1"])
    _line(capsys, result, "maxsim")
    assert result["corpus_tokens"] > 0


# --- the examples -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    from embedding_cpp_tpu_torch.cli.make_test_model import make_test_model

    root = tmp_path_factory.mktemp("examples")
    out = {}
    for preset in ("tiny", "tiny-splade", "tiny-colbert"):
        out[preset] = str(root / f"{preset}.gguf")
        make_test_model(out[preset], preset, "q4_0")
    return out


def _corpus():
    from embedding_cpp_tpu_torch.examples.semantic_search import DEFAULT_CORPUS

    return [ln.strip() for ln in open(DEFAULT_CORPUS) if ln.strip()]


def test_example_corpus_is_the_jax_one():
    from embedding_cpp_tpu_torch.examples.semantic_search import DEFAULT_CORPUS

    assert Path(DEFAULT_CORPUS).read_bytes() == (
        REPO / "examples" / "sample_client_texts.txt").read_bytes()


QUERIES = ["the weather is nice", "a dog and a cat"]


@pytest.mark.parametrize("remote", [False, True])
def test_semantic_search_returns_the_index_search(ggufs, capsys, monkeypatch, remote):
    from embedding_cpp_tpu_torch.examples import semantic_search
    from embedding_cpp_tpu_torch.runtime.engine import Engine
    from embedding_cpp_tpu_torch.runtime.search import VectorIndex

    engine = Engine.from_gguf(ggufs["tiny"], device="cpu")
    corpus = _corpus()
    index = VectorIndex(engine)
    index.add(corpus)
    want = []
    for q in QUERIES:
        ids, scores = index.search([q], 4)
        want += [f"{r}. [{s:+.4f}] {corpus[i]}" for r, (i, s) in enumerate(zip(ids[0], scores[0]),
                                                                            1)]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(QUERIES) + "\n\n"))
    if remote:
        with served(engine) as port:
            assert semantic_search.main(["--server", f"127.0.0.1:{port}", "-k", "4"]) == 0
    else:
        assert semantic_search.main([ggufs["tiny"], "-k", "4", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().splitlines() == want


def test_sparse_retrieval_returns_the_index_searches(ggufs, capsys, monkeypatch):
    from embedding_cpp_tpu_torch.examples import sparse_retrieval
    from embedding_cpp_tpu_torch.runtime.engine import Engine
    from embedding_cpp_tpu_torch.runtime.search import VectorIndex
    from embedding_cpp_tpu_torch.runtime.sparse_search import SparseIndex, rrf_fuse

    engine = Engine.from_gguf(ggufs["tiny-splade"], device="cpu")
    docs = _corpus()
    dense, sp = VectorIndex(engine), SparseIndex(engine)
    dense.add(docs)
    sp.add(docs)
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(QUERIES) + "\n"))
    assert sparse_retrieval.main([ggufs["tiny-splade"], "-k", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for q in QUERIES:
        d = dense.search([q], 3)
        s = sp.search([q], 3)
        f = rrf_fuse([d[0], s[0]], 3)
        for name, (idx, scores) in (("dense", d), ("sparse", s), ("hybrid", f)):
            rows = "; ".join(f"[{int(i)}] {docs[int(i)][:40]!r} ({float(v):.3f})"
                             for i, v in zip(idx[0], scores[0]) if i >= 0)
            assert f"  {name:6s}: {rows}" in out
    (ids, w), = engine.encode_sparse(docs[:1], k=8)
    assert ", ".join(f"{engine.id_to_token(int(t))}:{x:.2f}" for t, x in zip(ids, w)) in out


def test_late_interaction_returns_the_index_search(ggufs, capsys):
    from embedding_cpp_tpu_torch.examples import late_interaction_search as li
    from embedding_cpp_tpu_torch.runtime.engine import Engine
    from embedding_cpp_tpu_torch.runtime.maxsim_search import MaxSimIndex

    engine = Engine.from_gguf(ggufs["tiny-colbert"], device="cpu")
    docs = _corpus()
    index = MaxSimIndex(engine, doc_maxlen=128)
    index.add(docs)
    ids, scores = index.search(li.QUERIES, k=3)
    assert li.main([ggufs["tiny-colbert"], "-k", "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "ColBERT checkpoint" in out
    for qi in range(len(li.QUERIES)):
        for rank, (i, s) in enumerate(zip(ids[qi], scores[qi]), 1):
            assert f"  {rank}. [{s:7.3f}] {docs[i]}" in out
    for r in engine.maxsim_rerank(li.QUERIES[0], docs[:5], top_n=3):
        assert f"  [{r['relevance_score']:7.3f}] {docs[r['index']]}" in out


@pytest.mark.parametrize("raw", [False, True])
def test_sample_client_returns_the_cosine_top_k(ggufs, capsys, monkeypatch, raw):
    from embedding_cpp_tpu_torch.examples import sample_client
    from embedding_cpp_tpu_torch.runtime.engine import Engine

    engine = Engine.from_gguf(ggufs["tiny"], device="cpu")
    lines = _corpus()
    corpus = engine.encode(lines)
    monkeypatch.setattr(sys, "stdin", io.StringIO(QUERIES[0] + "\n\n"))
    with served(engine) as port:
        sample_client.main(["--port", str(port), "-k", "3"] + (["--raw"] if raw else []))
    out = capsys.readouterr().out.splitlines()
    sims = corpus @ engine.encode([QUERIES[0]])[0]
    top = np.argsort(-sims)[:3]
    got = [ln for ln in out if ln.startswith("  ")]
    assert [ln.split("  ", 2)[2] for ln in got] == [lines[i] for i in top]
    for ln, i in zip(got, top):
        assert abs(float(ln.split()[0]) - sims[i]) <= 1e-4


# --- run_eval's sbert mode ----------------------------------------------------------------------

def test_sbert_mode_matches_the_f32_engine(tmp_path, monkeypatch):
    """An HF BERT directory built in code, converted by the port: its f32
    mode and sentence-transformers on the same directory give STSB
    Spearman within 1e-3."""
    pytest.importorskip("sentence_transformers")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("USE_TF", "0")
    sys.path.insert(0, str(REPO / "tests"))
    from torch_hf_dirs import make_hf_dir

    d = make_hf_dir(tmp_path, "bert")
    out = run_eval.main(["--hf-dir", str(d), "--device", "cpu", "--dtype", "float32",
                         "--modes", "f32", "sbert", "--tasks", "STSBenchmark",
                         "--synthetic-data", "--results", str(tmp_path / "r")])
    f32 = out["scores"]["f32"]["STSBenchmark"]
    sbert = out["scores"]["sbert"]["STSBenchmark"]
    assert abs(f32 - sbert) <= 1e-3
    assert (tmp_path / "r" / f"{d.name}_sbert" / "STSBenchmark.json").exists()
