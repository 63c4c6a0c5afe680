"""Late-interaction (MaxSim) retrieval benchmark on the device.

The port's copy of the JAX package's `benchmarks/maxsim_bench.py`.  Corpus
token states resident on the device (`runtime.maxsim_search.MaxSimIndex`);
one call scores a whole query batch against every document.  Reports:

- **kernel**: the blocked exact MaxSim search on the resident rows (f32
  similarity -> masked max -> sum -> `select_topk`), CUDA events
  (`utils.profiling.device_ms`);
- **end_to_end**: `MaxSimIndex.search_token_vectors` wall time including
  the [Q, k] fetch;
- **ingest**: `add_token_vectors` of the whole corpus.

Defaults index 4096 docs x up to 128 tokens (~0.4M corpus tokens) at
ColBERT-width 128-dim token vectors.  `--big-docs N` adds the two-stage
(candidates) section on a clustered corpus of N documents: exact and
candidates search times (`device_ms` of the call, fetch included) and
their agreement, and the device ingest through a small engine.  `--device`
picks the device (the GPU by default; `cpu` runs the same torch code, with
host-clock times).

    python -m embedding_cpp_tpu_torch.benchmarks.maxsim_bench [--docs 4096] [--doc-maxlen 128]
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np


def _holder(dev, sd: int, e: int):
    """The engine fields the index reads on its vector-only calls."""
    from ..models.config import BertConfig

    return SimpleNamespace(config=BertConfig(n_vocab=32, n_ctx=sd, n_embd=e, n_layer=1,
                                             n_head=1, n_ff=8),
                           mesh=None, device=dev)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--docs", type=int, default=4096)
    p.add_argument("--doc-maxlen", type=int, default=128)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--queries", type=int, default=16)
    p.add_argument("--q-tokens", type=int, default=32)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--json-out")
    p.add_argument("--big-docs", type=int, default=0,
                   help=">= 100k-doc two-stage (candidates) section: "
                        "clustered corpus, exact-vs-approx agreement")
    p.add_argument("--big-doc-maxlen", type=int, default=48)
    p.add_argument("--candidates", type=int, nargs="+", default=[128, 512])
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    import torch

    from ..runtime.engine import resolve_device
    from ..runtime.maxsim_search import MaxSimIndex
    from ..runtime.search import exact_f32, select_topk, unit
    from ..utils.profiling import device_block, device_ms

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    n, sd, e = args.docs, args.doc_maxlen, args.dim
    # realistic variable doc lengths: half to full doc_maxlen
    lens = rng.integers(sd // 2, sd + 1, size=n)
    corpus = rng.normal(size=(n, sd, e)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    cmask = np.arange(sd)[None, :] < lens[:, None]
    corpus[~cmask] = 0.0
    corpus_tokens = int(lens.sum())
    q = rng.normal(size=(args.queries, args.q_tokens, e)).astype(np.float32)

    idx = MaxSimIndex(_holder(dev, sd, e), doc_maxlen=sd)
    docs = [corpus[i, : lens[i]] for i in range(n)]
    t0 = time.perf_counter()
    idx.add_token_vectors(docs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    add_s = time.perf_counter() - t0

    # --- the search computation on the resident rows ------------------------
    ((_, rows),) = idx._rows.shards(len(idx))
    qn = unit(torch.from_numpy(q).to(dev))
    qm = torch.ones(args.queries, args.q_tokens, dtype=torch.int32, device=dev)

    def search():
        with exact_f32():
            return select_topk(idx._exact(qn, qm, rows["corpus"], rows["cmask"]), args.k)

    per_ms = device_ms(search, dev, args.iters)
    # the sim matmul dominates: Qb * Sq * E * (N * Sd) MACs
    flops = 2 * args.queries * args.q_tokens * e * n * sd

    # --- end to end through the index ---------------------------------------
    q_list = [q[i] for i in range(args.queries)]
    idx.search_token_vectors(q_list, k=args.k)  # warmup
    t0 = time.perf_counter()
    ids, _ = idx.search_token_vectors(q_list, k=args.k)
    e2e = time.perf_counter() - t0
    assert ids.shape == (args.queries, args.k)

    result = {
        "platform": dev.type,
        "docs": n, "doc_maxlen": sd, "corpus_tokens": corpus_tokens,
        "dim": e, "queries": args.queries, "q_tokens": args.q_tokens,
        "k": args.k,
        "kernel_ms_per_batch": round(per_ms, 3),
        "kernel_tflops": round(flops / (per_ms / 1e3) / 1e12, 2),
        "queries_per_sec": round(args.queries / (per_ms / 1e3)),
        "end_to_end_ms": round(e2e * 1e3, 2),
        "index_add_s": round(add_s, 2),
        "ingest_docs_per_sec": round(n / add_s),
        "device": device_block(dev),
    }
    print(json.dumps(result))
    if args.big_docs:
        result["big"] = bench_big(args, dev)
        print(json.dumps({"big": result["big"]}))
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(result, indent=1))
    return result


def bench_big(args, dev) -> dict:
    """Two-stage candidates mode vs exact at --big-docs, with agreement
    stats.  The corpus is CLUSTERED (tokens = unit(center + noise)) so the
    pooled prefilter is informative, like real embeddings; pure-random
    token vectors would make any prefilter blind.  Also times ingest
    through a small engine (forward + commit, the token states never
    leaving the device)."""
    from ..models import BertConfig, ComputeOptions
    from ..runtime.engine import Engine
    from ..runtime.maxsim_search import MaxSimIndex
    from ..utils.profiling import device_ms

    rng = np.random.default_rng(1)
    n, sd, e = args.big_docs, args.big_doc_maxlen, args.dim
    # ~10 docs per cluster: a query's exact top-k IS its cluster, so
    # approx-vs-exact agreement measures the prefilter
    n_centers = max(1, n // 10)
    centers = rng.normal(size=(n_centers, e)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    assign = rng.integers(0, n_centers, size=n)
    lens = rng.integers(sd // 2, sd + 1, size=n)

    def tokens_near(center, m):
        # UNIT noise: raw gaussian rows have norm ~sqrt(E) and would drown
        # the center signal
        nz = rng.normal(size=(m, e))
        nz /= np.linalg.norm(nz, axis=-1, keepdims=True)
        t = 0.8 * center[None] + 0.6 * nz
        return (t / np.linalg.norm(t, axis=-1, keepdims=True)).astype(np.float32)

    idx = MaxSimIndex(_holder(dev, sd, e), doc_maxlen=sd, capacity=n)
    docs = [tokens_near(centers[assign[i]], lens[i]) for i in range(n)]
    t0 = time.perf_counter()
    idx.add_token_vectors(docs)
    add_s = time.perf_counter() - t0

    q = [tokens_near(centers[rng.integers(n_centers)], args.q_tokens)
         for _ in range(args.queries)]
    k = args.k
    found = {}

    def timed_search(**kw):
        def call():
            found["r"] = idx.search_token_vectors(q, k=k, **kw)

        ms = device_ms(call, dev, samples=3)
        return (*found["r"], ms)

    ie, _, exact_ms = timed_search()
    out = {"docs": n, "doc_maxlen": sd, "ingest_s": round(add_s, 2),
           "ingest_docs_per_sec": round(n / add_s), "exact_search_ms": round(exact_ms, 2)}
    for c in args.candidates:
        ia, _, approx_ms = timed_search(candidates=c)
        overlap = np.mean([len(set(ie[i][ie[i] >= 0]) & set(ia[i][ia[i] >= 0])) / k
                           for i in range(len(q))])
        out[f"candidates_{c}"] = {
            "search_ms": round(approx_ms, 2),
            "recall_at_k_vs_exact": round(float(overlap), 4),
            "top1_agreement": round(float(np.mean(ia[:, 0] == ie[:, 0])), 4),
        }

    cfg = BertConfig(n_vocab=512, n_ctx=64, n_embd=128, n_layer=2, n_head=4, n_ff=256,
                     name="ingest-bench")
    eng = Engine.synthetic(cfg, ftype="f32", opts=ComputeOptions(dtype="bfloat16"),
                           device=dev)
    texts = [f"document number {i} about topic {i % 97}" for i in range(16384)]
    didx = MaxSimIndex(eng, doc_maxlen=16, capacity=2 * len(texts))
    didx.add(texts)  # warm the chunk shapes
    t0 = time.perf_counter()
    didx.add(texts)
    out["device_ingest_docs_per_sec"] = round(len(texts) / (time.perf_counter() - t0))
    return out


if __name__ == "__main__":
    main()
