"""SPLADE sparse-encoding + MaxSim benchmark at splade-base geometry.

The port's copy of the JAX package's `benchmarks/sparse.py`.  Two layers
of numbers, as `search.py`:

- **kernel**: the device time of the full sparse forward
  (`models.bert.bert_sparse_batch`: the encoder, the MLM transform, the
  tied decoder through K1 / K8 as `route` gives it, the chunked
  log1p/relu/max and the top-k + packing) at [--batch, --seq], from CUDA
  events around forwards queued behind a GPU spin (`utils.profiling.device_ms`);
- **end_to_end**: `Engine.encode_sparse` wall time on 256 texts including
  the packed top-k fetch, and `Engine.maxsim` of one query against them.

`--search`: the device `SparseIndex` at `--docs` scale against the host
CSR baseline on the same corpus and queries (exact search, then the
two-stage candidates mode's recall against it); its kernel time is the
scoring gathers plus `select_topk` on the resident rows, CUDA events.

The geometry is naver/splade-cocondenser's (BERT-base, 768 wide, 12
layers, n_vocab 30522); `--layers` and `--vocab` cut it for a run on the
CPU.  `--device` picks the device (the GPU by default; `cpu` runs the
kernels' plain PyTorch versions, with host-clock times).

    python -m embedding_cpp_tpu_torch.benchmarks.sparse [--batch 32] [--seq 128] [--k 256]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _best_s(fn, runs: int = 3) -> float:
    fn()  # warm the exact shapes the timed runs hit
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def bench_search(docs: int, nnz: int, n_vocab: int, queries: int, k: int, iters: int,
                 dev) -> dict:
    """The dp-shardable padded-COO device index vs the single-core host CSR
    baseline, same corpus, same queries, the same exact scores."""
    import torch

    from ..runtime.search import exact_f32, select_topk
    from ..runtime.sparse_search import SparseIndex, _gathered_scores
    from ..utils.profiling import device_block, device_ms

    rng = np.random.default_rng(0)
    # vectorized synthetic corpus: fixed-nnz docs, weight-descending
    didx = rng.integers(0, n_vocab, size=(docs, nnz)).astype(np.int32)
    dval = np.sort(rng.random((docs, nnz)).astype(np.float32), axis=1)[:, ::-1]
    # SPLADE-like impact concentration: log1p(relu(logits)) puts most of a
    # document's mass in a few dominant terms (the regime the candidates
    # mode's weight-prefix prefilter targets)
    dval *= np.exp(-0.08 * np.arange(nnz, dtype=np.float32))[None, :]
    q_pairs = []
    for _ in range(queries):
        qn = int(rng.integers(8, 48))
        q_pairs.append((rng.choice(n_vocab, size=qn, replace=False).astype(np.int32),
                        rng.random(qn).astype(np.float32)))

    # --- host CSR baseline (the host backend's math on the flat arrays) ---
    flat_idx = didx.reshape(-1).astype(np.int64)
    flat_val = dval.reshape(-1)
    doc_ids = np.repeat(np.arange(docs, dtype=np.int64), nnz)
    qd = np.zeros(n_vocab, np.float32)
    t0 = time.perf_counter()
    host_scores = []
    for idx, val in q_pairs:
        qd[idx] = val
        host_scores.append(np.bincount(doc_ids, weights=flat_val * qd[flat_idx],
                                       minlength=docs))
        qd[idx] = 0.0
    host_s = time.perf_counter() - t0
    host_top = np.argsort(-np.asarray(host_scores), axis=1, kind="stable")[:, :k]

    # --- device index (through the production class) ---
    index = SparseIndex(device=dev, nnz_width=nnz)
    t0 = time.perf_counter()
    step = 65536
    for lo in range(0, docs, step):
        index.add_vectors(list(zip(didx[lo: lo + step], dval[lo: lo + step])))
    ingest_s = time.perf_counter() - t0
    ids, scores = index.search_vectors(q_pairs, k=k)  # warmup
    t0 = time.perf_counter()
    ids, scores = index.search_vectors(q_pairs, k=k)
    e2e_s = time.perf_counter() - t0
    agree = float(np.mean(ids == host_top))

    # --- the device scoring alone, on the resident rows ---
    kq = max(len(qi) for qi, _ in q_pairs)
    q_idx = np.full((queries, kq), -1, np.int32)
    q_val = np.zeros((queries, kq), np.float32)
    for i, (qi, qv) in enumerate(q_pairs):
        q_idx[i, : len(qi)] = qi
        q_val[i, : len(qv)] = qv
    ((_, rows),) = index._rows.shards(len(index))
    qdt = index._dense_queries(q_idx, q_val, dev).T.contiguous()

    def score():
        with exact_f32():
            return select_topk(_gathered_scores(qdt, rows["idx"], rows["val"]), k)

    per_ms = device_ms(score, dev, iters)
    result = {
        "platform": dev.type,
        "docs": docs, "nnz": nnz, "n_vocab": n_vocab,
        "queries": queries, "k": k,
        "host_s_per_batch": round(host_s, 3),
        "device_kernel_ms_per_batch": round(per_ms, 3),
        "speedup_vs_host": round(host_s / (per_ms / 1e3), 1),
        "device_end_to_end_ms": round(e2e_s * 1e3, 2),
        "ingest_s": round(ingest_s, 2),
        "topk_agreement": agree,
        "device": device_block(dev),
    }
    # two-stage candidates mode: impact-prefix prefilter + exact rescore
    for c in (256, 1024):
        index.search_vectors(q_pairs, k=k, candidates=c)  # warmup
        t0 = time.perf_counter()
        ia, _ = index.search_vectors(q_pairs, k=k, candidates=c)
        approx_s = time.perf_counter() - t0
        overlap = float(np.mean([
            len(set(ids[i][ids[i] >= 0]) & set(ia[i][ia[i] >= 0])) / k
            for i in range(queries)
        ]))
        result[f"candidates_{c}"] = {
            "end_to_end_ms": round(approx_s * 1e3, 2),
            "recall_at_k_vs_exact": round(overlap, 4),
            "top1_agreement": round(float(np.mean(ia[:, 0] == ids[:, 0])), 4),
        }
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return result


def bench_forward(args, dev) -> dict:
    import torch

    from ..models import BertConfig, ComputeOptions
    from ..models.bert import bert_sparse_batch
    from ..runtime.engine import Engine
    from ..tokenizer.testvocab import _COMMON_WORDS
    from ..utils.profiling import device_block, device_ms

    # naver/splade-cocondenser-* geometry: bert-base + full WordPiece vocab
    cfg = BertConfig(n_vocab=args.vocab, n_ctx=512, n_embd=768, n_layer=args.layers,
                     n_head=12, n_ff=3072, mlm_head=True, name="splade-base-synthetic")
    opts = ComputeOptions(dtype="bfloat16")
    eng = Engine.synthetic(cfg, args.ftype, opts=opts, device=dev)
    b, s, k = args.batch, args.seq, args.k
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.n_vocab, size=(b, s)).astype(np.int32)).to(dev)
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        per_ms = device_ms(lambda: bert_sparse_batch(eng.params, ids, mask, cfg, opts, k=k),
                           dev, args.iters, spin=50_000_000)
    result = {
        "metric": "sparse_sentences_per_sec_device",
        "value": round(b / (per_ms / 1e3), 1),
        "unit": "sentences/s",
        "batch": b, "seq": s, "k": k, "ftype": args.ftype, "layers": args.layers,
        "n_vocab": args.vocab,
        "kernel_ms_per_batch": round(per_ms, 3),
        "platform": dev.type,
        "device": device_block(dev),
    }
    # end to end through the engine (tokenize + dispatch + packed fetch)
    words = np.array(_COMMON_WORDS)
    texts = [" ".join(rng.choice(words, size=12)) for _ in range(args.texts)]
    result["end_to_end_sentences_per_sec"] = round(
        len(texts) / _best_s(lambda: eng.encode_sparse(texts, k=k)), 1)
    # MaxSim: one query against the same texts (the document forward dominates)
    result["maxsim_docs_per_sec"] = round(
        len(texts) / _best_s(lambda: eng.maxsim(texts[0], texts)), 1)
    return result


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--k", type=int, default=256)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--ftype", default="q4_0")
    p.add_argument("--layers", type=int, default=12,
                   help="encoder depth (splade-base: 12)")
    p.add_argument("--texts", type=int, default=256,
                   help="texts of the end-to-end encode_sparse / maxsim calls")
    p.add_argument("--json-out")
    p.add_argument("--search", action="store_true",
                   help="device sparse retrieval at --docs scale vs the "
                        "host CSR baseline")
    p.add_argument("--docs", type=int, default=1048576)
    p.add_argument("--nnz", type=int, default=128)
    p.add_argument("--vocab", type=int, default=30522)
    p.add_argument("--queries", type=int, default=8)
    p.add_argument("--search-k", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the plain PyTorch "
                        "versions of the kernels)")
    args = p.parse_args(argv)
    from ..runtime.engine import resolve_device

    dev = resolve_device(args.device)
    if args.search:
        result = bench_search(args.docs, args.nnz, args.vocab, args.queries, args.search_k,
                              args.iters, dev)
    else:
        result = bench_forward(args, dev)
        print(f"# sparse [{args.batch}, {args.seq}] k={args.k} {args.ftype}: "
              f"{result['kernel_ms_per_batch']:.2f} ms/batch ({result['value']:,.0f} sent/s "
              f"device); e2e {result['end_to_end_sentences_per_sec']} sent/s; maxsim "
              f"{result['maxsim_docs_per_sec']} docs/s", file=sys.stderr)
    print(json.dumps(result))
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
