"""The port's evaluation harness (`embedding_cpp_tpu_torch.benchmarks.tasks`,
`run_eval`, `print_tables`) against the JAX package's `benchmarks/tasks.py`
and `benchmarks/run_eval.py` on the CPU: the same synthetic task data for
the same seeds, the same metrics on the same encoder outputs, the port's
own logistic regression against scikit-learn's, `run_eval --synthetic`
against the JAX `run_mode` on the same tiny GGUFs (the JAX results go to a
temporary directory), and its sources and mode rules.  The sbert mode's
parity is in test_torch_bench_scripts.py."""
import json
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "benchmarks"))
sys.path.insert(0, str(REPO))

import run_eval as jax_run_eval  # noqa: E402
import tasks as jax_tasks  # noqa: E402

from embedding_cpp_tpu_torch.benchmarks import print_tables, run_eval, tasks  # noqa: E402

MODES = ("f32", "q4_0")

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



def _bag_of_words(texts, width: int = 64) -> np.ndarray:
    """Deterministic toy encoder: crc32-hashed bag of words."""
    out = np.zeros((len(texts), width), np.float32)
    for i, t in enumerate(texts):
        for w in t.split():
            out[i, zlib.crc32(w.encode()) % width] += 1.0
    return out


# --- task data ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["synthetic_sts", "synthetic_classification",
                                  "synthetic_retrieval"])
def test_synthetic_data_equals_jax(name, seed):
    got = getattr(tasks, name)(seed=seed)
    want = getattr(jax_tasks, name)(seed=seed)
    assert got.__dict__ == want.__dict__


def test_load_sts_local_equals_jax(tmp_path):
    rows = [{"sentence1": "a b", "sentence2": "a b", "score": 5.0},
            {"sentence1": "a b", "sentence2": "c d", "score": 0}]
    p = tmp_path / "sts.json"
    p.write_text(json.dumps(rows))
    assert tasks.load_sts_local(p).__dict__ == jax_tasks.load_sts_local(p).__dict__


# --- metrics ----------------------------------------------------------------------

def test_ndcg_and_recall_equal_jax():
    rng = np.random.default_rng(0)
    data = tasks.synthetic_retrieval(seed=0)
    for qrels in data.qrels:
        for k in (1, 5, 10):
            ranked = rng.permutation(len(data.corpus))[:k]
            ranked[rng.random(k) < 0.2] = -1  # padding slots
            for fn in ("ndcg_at_k", "recall_at_k"):
                got = getattr(tasks, fn)(ranked, qrels, k)
                want = getattr(jax_tasks, fn)(ranked, qrels, k)
                assert abs(got - want) <= 1e-9, (fn, k)


def test_eval_sts_equals_jax():
    data = tasks.synthetic_sts(seed=1)
    got = tasks.eval_sts(_bag_of_words, data)["test"]["cos_sim"]
    want = jax_tasks.eval_sts(_bag_of_words, data)["test"]["cos_sim"]
    for key in ("spearman", "pearson"):
        assert abs(got[key] - want[key]) <= 1e-9
    assert got["spearman"] > 0.5


def test_eval_retrieval_equals_jax():
    data = tasks.synthetic_retrieval(seed=0)
    corpus = _bag_of_words(data.corpus)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)

    def search(queries, k):
        q = _bag_of_words(queries)
        s = q @ corpus.T
        ids = np.argsort(-s, axis=1, kind="stable")[:, :k]
        return ids, np.take_along_axis(s, ids, 1)

    got = tasks.eval_retrieval(search, data)["test"]
    want = jax_tasks.eval_retrieval(search, data)["test"]
    for key in ("ndcg_at_10", "recall_at_10", "main_score"):
        assert abs(got[key] - want[key]) <= 1e-9


# --- the classifier -------------------------------------------------------------------

def _random_task(seed: int, n_classes: int, width: int):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((width, n_classes))
    x = rng.standard_normal((400, width)).astype(np.float32)
    y = (x @ w + 2.0 * rng.standard_normal((400, n_classes))).argmax(1)
    return x[:256], y[:256], x[256:], y[256:]


@pytest.mark.parametrize("seed,n_classes,width", [(0, 4, 64), (1, 2, 32), (2, 6, 384),
                                                   (3, 3, 16)])
def test_classifier_matches_sklearn_on_random_features(seed, n_classes, width):
    from sklearn.linear_model import LogisticRegression

    x, y, xt, yt = _random_task(seed, n_classes, width)
    want = LogisticRegression(max_iter=100).fit(x, y)
    got = tasks.LogisticRegression(max_iter=100).fit(x, y)
    assert abs(got.score(xt, yt) - want.score(xt, yt)) <= 0.01
    assert got.coef_.shape == want.coef_.shape


def test_classifier_matches_sklearn_on_the_synthetic_task():
    data = tasks.synthetic_classification(seed=0)
    got = tasks.eval_classification(_bag_of_words, data)["test"]
    want = jax_tasks.eval_classification(_bag_of_words, data)["test"]
    assert abs(got["accuracy"] - want["accuracy"]) <= 0.01
    assert got["main_score"] == got["accuracy"] > 0.5


# --- run_eval against the JAX run ---------------------------------------------------------

def test_constants_equal_jax():
    assert run_eval.EXPECTED_SCORES == jax_run_eval.EXPECTED_SCORES
    assert run_eval.SCORE_TOLERANCE == jax_run_eval.SCORE_TOLERANCE
    assert run_eval.RETRIEVAL_MIN_NDCG == jax_run_eval.RETRIEVAL_MIN_NDCG
    assert run_eval.ENGINE_MODES == jax_run_eval.ENGINE_MODES
    assert run_eval.ALL_MODES == jax_run_eval.ALL_MODES
    assert run_eval.ALL_TASKS == jax_run_eval.ALL_TASKS
    for key, score in run_eval.EXPECTED_SCORES.items():
        assert run_eval.check_baseline(*key, score + 0.01) == jax_run_eval.check_baseline(
            *key, score + 0.01)


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    """The port's `run_eval --synthetic --preset tiny` (f32 and q4_0, f32
    activations, on the CPU) and the JAX `run_mode` on the JAX package's
    make_test_model of the same preset and ftypes."""
    from embedding_cpp_tpu.cli.make_test_model import make_test_model

    root = tmp_path_factory.mktemp("eval")
    port = run_eval.main(["--synthetic", "--preset", "tiny", "--device", "cpu", "--dtype",
                          "float32", "--modes", *MODES, "--results", str(root / "port")])
    old = jax_run_eval.RESULTS
    jax_run_eval.RESULTS = root / "jax"  # nothing is written under benchmarks/results
    try:
        sts, clf, ret = jax_run_eval.get_datasets(True, None)
        jax_scores, failures = {}, []
        for mode in MODES:
            path = str(root / f"jax-{mode}.gguf")
            make_test_model(path, "tiny", mode)
            jax_scores[mode] = jax_run_eval.run_mode(
                mode, "synthetic-tiny", jax_run_eval.make_engine_encoder(path, "float32"),
                sts, clf, list(jax_run_eval.ALL_TASKS), ret=ret)
            jax_run_eval._gate_baseline(failures, "synthetic-tiny", mode, jax_scores[mode],
                                        False, synthetic_model=True)
    finally:
        jax_run_eval.RESULTS = old
    return {"port": port, "jax": jax_scores, "jax_failures": failures, "root": root}


RETRIEVAL = ("dense", "maxsim", "sparse_lex", "maxsim_lex", "hybrid_lex")


@pytest.mark.parametrize("mode", MODES)
def test_run_eval_sts_and_accuracy_match_jax(eval_runs, mode):
    got, want = eval_runs["port"]["scores"][mode], eval_runs["jax"][mode]
    assert abs(got["STSBenchmark"] - want["STSBenchmark"]) <= 1e-3
    assert abs(got["EmotionClassification"] - want["EmotionClassification"]) <= 0.01


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("modality", RETRIEVAL)
def test_run_eval_retrieval_matches_jax(eval_runs, mode, modality):
    key = f"retrieval_{modality}"
    got, want = eval_runs["port"]["scores"][mode][key], eval_runs["jax"][mode][key]
    assert abs(got - want) <= 1e-3
    floor = run_eval.RETRIEVAL_MIN_NDCG.get(modality)
    if floor is not None:
        assert got >= floor and want >= floor


def test_run_eval_gates_pass_on_both_sides(eval_runs):
    assert eval_runs["port"]["failures"] == []
    assert eval_runs["jax_failures"] == []
    assert set(eval_runs["port"]["scores"]) == set(MODES)


def test_results_layout_and_device_entry(eval_runs):
    port_dir = eval_runs["root"] / "port"
    jax_dir = eval_runs["root"] / "jax"
    for mode in MODES:
        names = sorted(p.name for p in (port_dir / f"synthetic-tiny_{mode}").iterdir())
        assert names == sorted(p.name for p in (jax_dir / f"synthetic-tiny_{mode}").iterdir())
        for f in (port_dir / f"synthetic-tiny_{mode}").glob("*.json"):
            data = json.loads(f.read_text())
            assert data["device"] == "cpu"
            want = json.loads((jax_dir / f"synthetic-tiny_{mode}" / f.name).read_text())
            assert data["mteb_dataset_name"] == want["mteb_dataset_name"]
            assert set(data["test"]) == set(want["test"])
    assert eval_runs["port"]["device"] == "cpu"
    assert eval_runs["port"]["results"] == str(port_dir)


def test_print_tables_reads_run_eval_results(eval_runs, capsys):
    port_dir = eval_runs["root"] / "port"
    models = print_tables.collect(port_dir)
    assert set(models) == {"synthetic-tiny"} and set(models["synthetic-tiny"]) == set(MODES)
    scores = eval_runs["port"]["scores"]
    for mode in MODES:
        row = models["synthetic-tiny"][mode]
        assert row["STSBenchmark"][0] == pytest.approx(scores[mode]["STSBenchmark"])
        assert row["SyntheticRetrieval"][0] == pytest.approx(scores[mode]["retrieval_dense"])
        assert row["STSBenchmark"][2] == "cpu"
    print_tables.main(["--results", str(port_dir)])
    out = capsys.readouterr().out
    assert "### synthetic-tiny" in out and "| f32 |" in out and "| q4_0 |" in out
    assert "device: cpu" in out


def test_run_eval_writes_nothing_under_benchmarks():
    assert run_eval.DEFAULT_RESULTS == REPO / "eval_results"
    assert "eval_results/" in (REPO / ".gitignore").read_text().splitlines()


# --- modes, sources ----------------------------------------------------------------------

def test_default_modes_leave_out_sbert_with_the_reason(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(run_eval, "sbert_available", lambda: False)
    import argparse

    p = argparse.ArgumentParser()
    args = argparse.Namespace(modes=None, hf_dir=str(tmp_path))
    modes, skipped = run_eval._resolve_modes(p, args)
    assert modes == list(run_eval.ENGINE_MODES)
    assert set(skipped) == set(run_eval.SBERT_MODES)
    assert "sentence_transformers" in skipped["sbert"]
    modes, skipped = run_eval._resolve_modes(p, argparse.Namespace(modes=None, hf_dir=None))
    assert modes == list(run_eval.ENGINE_MODES) and "--hf-dir" in skipped["sbert"]


@pytest.mark.parametrize("argv", [
    ["--synthetic", "--modes", "sbert"],
    ["--hf-dir", "x", "--modes", "sbert-batchless"],
    ["--synthetic", "--modes", "q5_1"],
])
def test_a_named_mode_that_cannot_run_exits_nonzero(monkeypatch, argv):
    monkeypatch.setattr(run_eval, "sbert_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run_eval.main([*argv, "--device", "cpu"])
    assert e.value.code != 0


def test_gguf_and_server_sources_agree(tmp_path):
    """--gguf on a tiny file and --server in front of the same engine give
    the same STSB score (the server's replies are the engine's vectors)."""
    from embedding_cpp_tpu_torch.benchmarks.serving import serving
    from embedding_cpp_tpu_torch.cli.make_test_model import make_test_model
    from embedding_cpp_tpu_torch.models.bert import ComputeOptions
    from embedding_cpp_tpu_torch.runtime.engine import Engine

    path = tmp_path / "tiny.gguf"
    make_test_model(str(path), "tiny", "q8_0")
    common = ["--synthetic-data", "--tasks", "STSBenchmark", "--results", str(tmp_path / "r")]
    gguf = run_eval.main(["--gguf", str(path), "--device", "cpu", "--dtype", "float32",
                          *common])
    engine = Engine.from_gguf(str(path), device="cpu", opts=ComputeOptions(dtype="float32"))
    with serving(engine) as port:
        server = run_eval.main(["--server", f"127.0.0.1:{port}", *common])
    assert abs(gguf["scores"]["gguf"]["STSBenchmark"]
               - server["scores"]["server"]["STSBenchmark"]) <= 1e-6
    assert server["device"] == "server"


def test_sparse_encode_mode_runs(tmp_path):
    out = run_eval.main(["--synthetic", "--preset", "tiny-splade", "--sparse-encode",
                         "--device", "cpu", "--dtype", "float32", "--modes", "f32",
                         "--results", str(tmp_path)])
    scores = out["scores"]["f32"]
    assert np.isfinite(scores["STSBenchmark"]) and "retrieval_sparse" in scores
    assert "retrieval_hybrid" in scores and out["failures"] == []
