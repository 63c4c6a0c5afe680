"""Evaluation harness: modes x tasks -> <results>/<model>_<mode>/<task>.json.

The port's copy of the JAX package's `benchmarks/run_eval.py`, itself the
mirror of the reference's benchmarks/run_mteb.py loop (modes [q4_0, q4_1,
f32, f16, sbert, sbert-batchless] x tasks [STSBenchmark,
EmotionClassification], run_mteb.py:23-28,104-123): the same results
layout, so `print_tables` lines the numbers up against the reference's
published ones (BASELINE.md).  Each result JSON also carries a `device`
entry (`utils.profiling.device_block`): "cpu", or the card's name and
power limit.  The last line of standard output is one JSON object: the
scores by mode, the device, the modes left out and any gate failures.

Model sources:
  --hf-dir DIR     local HF checkpoint: converted to GGUF per ftype first
                   (`models.convert.convert_hf_dir`)
  --gguf PATH      a prebuilt GGUF (single mode)
  --server H:P     a running embedding server (`runtime.client`)
  --synthetic      random-weight synthetic model (`cli.make_test_model`)
                   + synthetic datasets (hermetic pipeline test; scores are
                   only meaningful relative to each other)

`--device` picks where the engine runs: the GPU by default, `cpu` runs the
kernels' plain PyTorch versions.  Results go to `--results DIR` (default
`eval_results/` at the repository root, which git ignores).

Usage:
  python -m embedding_cpp_tpu_torch.benchmarks.run_eval --synthetic [--device cpu]
  python -m embedding_cpp_tpu_torch.benchmarks.run_eval --hf-dir /path/to/all-MiniLM-L6-v2 \\
      --modes f32 q4_0 sbert --tasks STSBenchmark
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import tempfile
import zlib
from pathlib import Path

import numpy as np

from . import tasks

DEFAULT_RESULTS = Path(__file__).resolve().parents[2] / "eval_results"
# q8_0 is the JAX package's extension beyond the reference's four modes
ENGINE_MODES = ("f32", "f16", "q4_0", "q4_1", "q8_0")
SBERT_MODES = ("sbert", "sbert-batchless")
ALL_MODES = ENGINE_MODES + SBERT_MODES
ALL_TASKS = ("STSBenchmark", "EmotionClassification", "SyntheticRetrieval")

# Ranking-quality regression gates for the synthetic retrieval task (fixed
# seeds -> deterministic corpus), the JAX package's.  Two kinds of row:
# - "dense": the model-based dense ranking.  Random-weight synthetic models
#   still clear it easily (mean-pooled embeddings reflect bag-of-words
#   overlap even untrained) and real checkpoints score ~0.9+.
# - "*_lex": the same SparseIndex / MaxSimIndex / RRF machinery driven by
#   DETERMINISTIC lexical vectors (hashed term ids / per-word unit vectors)
#   instead of the encoder, so the gate tests the ranking PLUMBING — COO
#   padding, scatter scoring, top-k, rank fusion — independent of model
#   quality.  Within-topic order is arbitrary by construction, so ~1.0 is
#   not achievable; a broken path collapses toward ~0.1.
# Model-based maxsim/sparse/hybrid nDCG is REPORTED per modality for real-
# checkpoint use but not gated (random-weight scores there measure the
# weights, not the plumbing).
RETRIEVAL_MIN_NDCG = {"dense": 0.55, "sparse_lex": 0.70, "maxsim_lex": 0.70,
                      "hybrid_lex": 0.70}

# Pinned reference scores (BASELINE.md; reference benchmarks/results/
# <model>_<mode>/<task>.json).  --assert-baseline gates a real-model run
# against these: STSB = Spearman of cosine, Emotion = main accuracy score.
# Tolerance matches the reference's own quantization delta class (~±0.01
# Spearman, README.origin.md:143) plus bf16-activation headroom.
EXPECTED_SCORES = {
    # (model, mode, task): score
    ("all-MiniLM-L6-v2", "f32", "STSBenchmark"): 0.8201,
    ("all-MiniLM-L6-v2", "f16", "STSBenchmark"): 0.8201,
    ("all-MiniLM-L6-v2", "q4_0", "STSBenchmark"): 0.8175,
    ("all-MiniLM-L6-v2", "q4_1", "STSBenchmark"): 0.8223,
    ("all-MiniLM-L6-v2", "f32", "EmotionClassification"): 0.4082,
    ("all-MiniLM-L6-v2", "f16", "EmotionClassification"): 0.4085,
    ("all-MiniLM-L6-v2", "q4_0", "EmotionClassification"): 0.3911,
    ("all-MiniLM-L6-v2", "q4_1", "EmotionClassification"): 0.4027,
    ("all-MiniLM-L12-v2", "f32", "STSBenchmark"): 0.8306,
    ("all-MiniLM-L12-v2", "f16", "STSBenchmark"): 0.8306,
    ("all-MiniLM-L12-v2", "q4_0", "STSBenchmark"): 0.8310,
    ("all-MiniLM-L12-v2", "q4_1", "STSBenchmark"): 0.8325,
    ("bert-base-uncased", "f32", "STSBenchmark"): 0.4738,
    ("bert-base-uncased", "f16", "STSBenchmark"): 0.4739,
    ("bert-base-uncased", "q4_0", "STSBenchmark"): 0.4940,
    ("bert-base-uncased", "q4_1", "STSBenchmark"): 0.4612,
}
SCORE_TOLERANCE = 0.015


def check_baseline(model_name: str, mode: str, task: str, score: float):
    """Return (ok, expected) — ok=None when no pinned number exists."""
    exp = EXPECTED_SCORES.get((model_name, mode, task))
    if exp is None:
        return None, None
    return abs(score - exp) <= SCORE_TOLERANCE, exp


def make_engine_encoder(gguf_path: str, dtype: str = "bfloat16",
                        output_dtype: str = "float32", sparse: bool = False,
                        device=None):
    from ..models.bert import ComputeOptions
    from ..runtime.engine import Engine

    engine = Engine.from_gguf(
        gguf_path, device=device,
        opts=ComputeOptions(dtype=dtype, output_dtype=output_dtype),
    )
    if sparse:
        # SPLADE mode (needs an MLM-head model, e.g. --preset tiny-splade):
        # the eval similarity runs over densified sparse lexical vectors —
        # cosine over SPLADE vectors is the standard STS proxy for sparse
        # encoders (sentence-transformers SparseEncoder evaluators)
        def encode(texts):
            pairs = engine.encode_sparse(list(texts))
            out = np.zeros((len(pairs), engine.config.n_vocab), np.float32)
            for i, (idx, val) in enumerate(pairs):
                out[i, idx] = val
            return out

        encode.engine = engine
        return encode

    def encode(texts):
        return engine.encode(texts)

    encode.engine = engine  # retrieval tasks build indexes off the engine
    return encode


def make_sbert_encoder(model_name_or_dir: str, batch_size: int = 32, device=None):
    from sentence_transformers import SentenceTransformer

    model = SentenceTransformer(model_name_or_dir, device=device)

    def encode(texts):
        return model.encode(texts, batch_size=batch_size)

    return encode


def get_datasets(synthetic: bool, sts_json: str | None):
    if synthetic:
        return (tasks.synthetic_sts(), tasks.synthetic_classification(),
                tasks.synthetic_retrieval())
    sts = None
    clf = None
    if sts_json:
        sts = tasks.load_sts_local(sts_json)
    else:
        try:
            sts = tasks.load_stsbenchmark_hf()
        except Exception as e:
            print(f"! STSBenchmark unavailable ({e}); skipping", file=sys.stderr)
    try:
        clf = tasks.load_emotion_hf()
    except Exception as e:
        print(f"! EmotionClassification unavailable ({e}); skipping",
              file=sys.stderr)
    # no public retrieval dataset ships with the harness (zero-egress);
    # the synthetic retrieval task still runs with real checkpoints via
    # --synthetic-data
    return sts, clf, None


_LEX_VOCAB = 4093  # prime: cheap word-id hashing without clustering


def _term_ids(text: str) -> np.ndarray:
    # crc32, not hash(): Python salts hash() per process, which would make
    # the gate non-deterministic across runs
    return np.asarray([zlib.crc32(w.encode()) % _LEX_VOCAB for w in text.split()], np.int64)


def _tf_pairs(texts) -> list[tuple[np.ndarray, np.ndarray]]:
    out = []
    for t in texts:
        ids, counts = np.unique(_term_ids(t), return_counts=True)
        out.append((ids.astype(np.int32), counts.astype(np.float32)))
    return out


def _token_vecs(texts, dim: int) -> list[np.ndarray]:
    return [np.asarray([np.random.default_rng(int(i)).standard_normal(dim)
                        for i in _term_ids(t)], np.float32) for t in texts]


def _run_retrieval(encoder, ret, outdir: Path, device_info) -> dict[str, float]:
    """SyntheticRetrieval over every modality the model supports: dense
    (VectorIndex) + late-interaction (MaxSimIndex) always, sparse (SPLADE
    SparseIndex) + hybrid dense+sparse RRF when the checkpoint carries an
    MLM head, and the lexical mechanics rows.  Writes ONE JSON with
    per-modality blocks and returns {f"retrieval_{modality}": ndcg} for
    gating."""
    engine = getattr(encoder, "engine", None)
    if engine is None:
        print("! retrieval task needs an engine-backed encoder; skipping",
              file=sys.stderr)
        return {}
    from ..runtime.maxsim_search import MaxSimIndex
    from ..runtime.search import VectorIndex
    from ..runtime.sparse_search import SparseIndex, rrf_fuse

    searchers = {}
    dense = VectorIndex(engine)
    dense.add(ret.corpus)
    searchers["dense"] = dense.search
    maxsim = MaxSimIndex(engine)
    maxsim.add(ret.corpus)
    searchers["maxsim"] = maxsim.search
    if engine.config.mlm_head:
        sparse = SparseIndex(engine)
        sparse.add(ret.corpus)
        searchers["sparse"] = sparse.search

        def hybrid(queries, k):
            di, _ = dense.search(queries, k=2 * k)
            si, _ = sparse.search(queries, k=2 * k)
            return rrf_fuse([di, si], k)

        searchers["hybrid"] = hybrid

    # mechanics gates: the SAME index/fusion machinery driven by
    # deterministic lexical vectors (see RETRIEVAL_MIN_NDCG); the token
    # vectors are as wide as the index validates: the ColBERT projection
    # where the checkpoint has one, else n_embd
    lex_dim = engine.config.colbert_dim or engine.config.n_embd
    lex_sparse = SparseIndex(device=False)
    lex_sparse.add_vectors(_tf_pairs(ret.corpus))
    searchers["sparse_lex"] = lambda qs, k: lex_sparse.search_vectors(_tf_pairs(qs), k)
    lex_maxsim = MaxSimIndex(engine)
    lex_maxsim.add_token_vectors(_token_vecs(ret.corpus, lex_dim))
    searchers["maxsim_lex"] = lambda qs, k: lex_maxsim.search_token_vectors(
        _token_vecs(qs, lex_dim), k)

    def hybrid_lex(queries, k):
        di, _ = searchers["sparse_lex"](queries, 2 * k)
        si, _ = searchers["maxsim_lex"](queries, 2 * k)
        return rrf_fuse([di, si], k)

    searchers["hybrid_lex"] = hybrid_lex
    result = {"mteb_dataset_name": "SyntheticRetrieval", "test": {}}
    scores: dict[str, float] = {}
    for name, fn in searchers.items():
        r = tasks.eval_retrieval(fn, ret, k=10, name=name)
        result["test"][name] = r["test"]
        scores[f"retrieval_{name}"] = r["test"]["main_score"]
    # main_score follows the primary (dense) modality, like MTEB retrieval
    result["test"]["main_score"] = scores.get("retrieval_dense", 0.0)
    result["test"]["evaluation_time"] = round(
        sum(b["evaluation_time"] for b in result["test"].values()
            if isinstance(b, dict)), 2)
    result["device"] = device_info
    (outdir / "SyntheticRetrieval.json").write_text(json.dumps(result, indent=2))
    return scores


def run_mode(mode: str, model_name: str, encoder, sts, clf, task_names,
             warmup: bool = False, ret=None, results: Path = DEFAULT_RESULTS,
             device_info="cpu") -> dict[str, float]:
    """Run the selected tasks; returns {task: score} for baseline gating."""
    scores: dict[str, float] = {}
    outdir = Path(results) / f"{model_name}_{mode}"
    outdir.mkdir(parents=True, exist_ok=True)
    if warmup:
        # run every batch shape the SELECTED tasks will hit once (the
        # kernels build at first use), so reported times measure steady
        # state.  Each corpus list separately: the batch planner derives
        # dispatch shapes from the list it is given.
        if sts is not None and "STSBenchmark" in task_names:
            encoder(list(sts.sentences1))
            encoder(list(sts.sentences2))
        if clf is not None and "EmotionClassification" in task_names:
            encoder(list(clf.train_texts))
            encoder(list(clf.test_texts))
    for task_name in task_names:
        if task_name == "STSBenchmark" and sts is not None:
            result = tasks.eval_sts(encoder, sts)
        elif task_name == "EmotionClassification" and clf is not None:
            result = tasks.eval_classification(encoder, clf)
        elif task_name == "SyntheticRetrieval" and ret is not None:
            for key, sc in _run_retrieval(encoder, ret, outdir, device_info).items():
                scores[key] = sc
                print(f"{model_name}_{mode:16s} {key:24s} nDCG@10={sc:.4f}", file=sys.stderr)
            continue
        else:
            continue
        result["device"] = device_info
        (outdir / f"{task_name}.json").write_text(json.dumps(result, indent=2))
        t = result["test"]
        score = t.get("cos_sim", {}).get("spearman", t.get("main_score"))
        scores[task_name] = score
        print(f"{model_name}_{mode:16s} {task_name:24s} "
              f"score={score:.4f} time={t['evaluation_time']}s", file=sys.stderr)
    return scores


def _gate_baseline(failures: list, model_name: str, mode: str,
                   scores: dict, enabled: bool,
                   synthetic_model: bool = False) -> None:
    # the *_lex mechanics gates are ALWAYS on when the task ran: a drop
    # below the floor means a broken ranking path, not model quality.  The
    # model-based dense floor only applies to synthetic-weights runs (where
    # it was calibrated) or under --assert-baseline — an arbitrary real
    # checkpoint's tokenizer may legitimately fragment the synthetic
    # English vocabulary.
    for key, score in scores.items():
        if key.startswith("retrieval_"):
            name = key.removeprefix("retrieval_")
            if name == "dense" and not (synthetic_model or enabled):
                continue
            floor = RETRIEVAL_MIN_NDCG.get(name)
            if floor is not None and score < floor:
                failures.append(
                    f"{model_name}_{mode} {key}: nDCG@10 {score:.4f} below "
                    f"the ranking-regression floor {floor}"
                )
    if not enabled:
        return
    for task, score in scores.items():
        if task.startswith("retrieval_"):
            continue
        ok, exp = check_baseline(model_name, mode, task, score)
        if ok is None:
            print(f"! no pinned baseline for ({model_name}, {mode}, {task})",
                  file=sys.stderr)
        elif ok:
            print(f"baseline OK: {model_name}_{mode} {task} "
                  f"{score:.4f} vs {exp} (±{SCORE_TOLERANCE})", file=sys.stderr)
        else:
            failures.append(
                f"{model_name}_{mode} {task}: got {score:.4f}, "
                f"expected {exp} ±{SCORE_TOLERANCE}"
            )


def sbert_available() -> bool:
    return importlib.util.find_spec("sentence_transformers") is not None


def _resolve_modes(p, args) -> tuple[list[str], dict[str, str]]:
    """The modes to run and the default ones left out, with why.  A mode
    named on the command line that cannot run is an error."""
    if args.modes is None:
        skipped = {}
        if not args.hf_dir:
            skipped = {m: "sbert modes need --hf-dir" for m in SBERT_MODES}
        elif not sbert_available():
            skipped = {m: "sentence_transformers is not installed" for m in SBERT_MODES}
        return [m for m in ALL_MODES if m not in skipped], skipped
    for m in args.modes:
        if m not in ALL_MODES:
            p.error(f"unknown mode {m!r} (choose from {', '.join(ALL_MODES)})")
        if m in SBERT_MODES and not args.hf_dir:
            p.error(f"mode {m!r} needs --hf-dir")
        if m in SBERT_MODES and not sbert_available():
            p.error(f"mode {m!r} needs sentence_transformers, which is not installed")
    return list(args.modes), {}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--hf-dir")
    src.add_argument("--gguf")
    src.add_argument("--server", metavar="HOST:PORT",
                     help="evaluate through a running embedding server "
                          "(the reference's run_mteb_server.py mode)")
    src.add_argument("--synthetic", action="store_true")
    p.add_argument("--modes", nargs="+", default=None,
                   help=f"default: {' '.join(ALL_MODES)}, less the sbert modes where "
                        "they cannot run (no --hf-dir, or no sentence_transformers)")
    p.add_argument("--tasks", nargs="+", default=list(ALL_TASKS))
    p.add_argument("--sts-json", help="local STS dataset JSON")
    p.add_argument("--synthetic-data", action="store_true",
                   help="use synthetic datasets with any model source")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the plain PyTorch "
                        "versions of the kernels)")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--output-dtype", default="float32",
                   choices=["float32", "float16", "bfloat16", "int8"],
                   help="engine embedding transfer dtype (int8 = packed "
                        "codes+scale; scores shift ~1e-4)")
    p.add_argument("--warmup", action="store_true",
                   help="run every batch shape once before timing (the kernels "
                        "build at first use); in --server mode this warms the "
                        "server through the socket")
    p.add_argument("--assert-baseline", action="store_true",
                   help="gate scores against the pinned reference numbers "
                        "(EXPECTED_SCORES / BASELINE.md); exits nonzero on "
                        "a miss.  Use with a real checkpoint, e.g. "
                        "--hf-dir .../all-MiniLM-L6-v2")
    p.add_argument("--model-name")
    p.add_argument("--sparse-encode", action="store_true",
                   help="evaluate SPLADE sparse vectors (MLM-head model, "
                        "e.g. --preset tiny-splade) instead of dense "
                        "embeddings")
    p.add_argument("--preset", default="minilm-l6",
                   help="synthetic-mode model preset (cli.make_test_model): "
                        "covers every encoder/tokenizer family, e.g. "
                        "tiny-xlmr (Unigram), tiny-mpnet (relative bias)")
    p.add_argument("--results", type=Path, default=DEFAULT_RESULTS,
                   help="directory of the result JSONs (default: eval_results/ at the "
                        "repository root)")
    args = p.parse_args(argv)
    modes, skipped = _resolve_modes(p, args)
    for m, why in skipped.items():
        print(f"# left out mode {m}: {why}", file=sys.stderr)

    from ..runtime.engine import resolve_device
    from ..utils.profiling import device_block

    device = None if args.server else resolve_device(args.device)
    device_info = "server" if args.server else device_block(device)
    sts, clf, ret = get_datasets(args.synthetic or args.synthetic_data, args.sts_json)
    if sts is None and clf is None:
        print("no datasets available; nothing to do", file=sys.stderr)
        raise SystemExit(1)
    failures: list[str] = []
    all_scores: dict[str, dict] = {}
    run = dict(sts=sts, clf=clf, task_names=args.tasks, warmup=args.warmup,
               results=args.results, device_info=device_info)

    def engine_encoder(path):
        return make_engine_encoder(path, args.dtype, args.output_dtype,
                                   sparse=args.sparse_encode, device=device)

    if args.synthetic:
        print("# NOTE: synthetic random weights + synthetic datasets — this "
              "exercises the full pipeline but proves NO score parity with the "
              "pinned reference baselines", file=sys.stderr)
        from ..cli.make_test_model import make_test_model

        model_name = args.model_name or f"synthetic-{args.preset}"
        with tempfile.TemporaryDirectory() as td:
            for mode in modes:
                if mode not in ENGINE_MODES:
                    continue
                path = f"{td}/model-{mode}.gguf"
                make_test_model(path, args.preset, mode)
                scores = run_mode(mode, model_name, engine_encoder(path), ret=ret, **run)
                all_scores[mode] = scores
                _gate_baseline(failures, model_name, mode, scores,
                               args.assert_baseline, synthetic_model=True)
    elif args.server:
        from ..runtime.client import EmbeddingClient

        host, _, port = args.server.rpartition(":")
        client = EmbeddingClient(host or "127.0.0.1", int(port))
        model_name = args.model_name or "server"
        scores = run_mode("server", model_name, client.embed, **run)
        all_scores["server"] = scores
        _gate_baseline(failures, model_name, "server", scores, args.assert_baseline)
        client.close()
    elif args.gguf:
        model_name = args.model_name or Path(args.gguf).stem
        scores = run_mode("gguf", model_name, engine_encoder(args.gguf), ret=ret, **run)
        all_scores["gguf"] = scores
        _gate_baseline(failures, model_name, "gguf", scores, args.assert_baseline)
    else:
        # HF dir: convert once per requested engine mode, plus sbert modes
        from ..models.convert import convert_hf_dir

        model_name = args.model_name or Path(args.hf_dir).name
        with tempfile.TemporaryDirectory() as td:
            for mode in modes:
                if mode in ENGINE_MODES:
                    path = f"{td}/model-{mode}.gguf"
                    # --sparse-encode implies the MLM head must survive
                    # conversion (a SPLADE checkpoint without modules.json
                    # would otherwise auto-detect as dense)
                    convert_hf_dir(args.hf_dir, path, mode,
                                   sparse=True if args.sparse_encode else None)
                    scores = run_mode(mode, model_name, engine_encoder(path), ret=ret, **run)
                    _gate_baseline(failures, model_name, mode, scores, args.assert_baseline)
                else:
                    batch = 32 if mode == "sbert" else 1
                    scores = run_mode(mode, model_name,
                                      make_sbert_encoder(args.hf_dir, batch, str(device)),
                                      **run)
                all_scores[mode] = scores

    summary = {"metric": "mteb_eval", "model": model_name, "device": device_info,
               "dtype": args.dtype, "output_dtype": args.output_dtype,
               "scores": all_scores, "modes_left_out": skipped, "failures": failures,
               "results": str(args.results)}
    print(json.dumps(summary))
    if failures:
        print("BASELINE ASSERTION FAILURES:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        raise SystemExit(1)
    return summary


if __name__ == "__main__":
    main()
