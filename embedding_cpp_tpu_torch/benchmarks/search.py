"""Vector-search benchmark: brute-force exact top-k cost on the device.

The port's copy of the JAX package's `benchmarks/search.py`.  Numbers:

- **kernel**: the search computation alone on device-resident tensors —
  the scores product (bf16 corpus, f32 sums: `runtime.search.similarity`)
  plus `select_topk` — timed with CUDA events (`utils.profiling.device_ms`;
  the selection's one host check of its tie rule is inside the time);
- **approx**: the JAX package's `exact=False` figure.  Its TPU selection
  (`lax.approx_max_k`) has no torch counterpart, so the port's
  `VectorIndex(exact=False)` runs the exact selection (ROADMAP): this
  figure times the same exact search again and says so;
- **end_to_end**: wall time of `VectorIndex.search_vectors` including the
  [Q, k] fetch (only ids + scores cross to the host);
- **ingest**: documents/s of `VectorIndex.add` through a one-layer model
  (the vectors stay on the device).

`--device` picks the device (the GPU by default; `cpu` runs the same torch
code on the CPU, where the kernel time is a host-clock time).

    python -m embedding_cpp_tpu_torch.benchmarks.search [--corpus 131072] [--queries 64] [--k 10]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--corpus", type=int, default=131072)
    p.add_argument("--queries", type=int, default=64)
    p.add_argument("--dim", type=int, default=384)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--ingest-docs", type=int, default=2048)
    p.add_argument("--json-out")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    import torch

    from ..models import BertConfig, ComputeOptions
    from ..runtime.engine import Engine, resolve_device
    from ..runtime.search import VectorIndex, exact_f32, select_topk, similarity
    from ..tokenizer.testvocab import _COMMON_WORDS
    from ..utils.profiling import device_block, device_ms

    dev = resolve_device(args.device)
    n, q_n, e, k = args.corpus, args.queries, args.dim, args.k
    rng = np.random.default_rng(0)
    corpus = torch.from_numpy(rng.normal(size=(n, e)).astype(np.float32)).to(dev, torch.bfloat16)
    qs = torch.from_numpy(rng.normal(size=(q_n, e)).astype(np.float32)).to(dev, torch.bfloat16)

    def search_once():
        with exact_f32():
            return select_topk(similarity(qs, corpus), k)

    per = device_ms(search_once, dev, args.iters) / 1e3
    per_approx = device_ms(search_once, dev, args.iters) / 1e3  # the same exact selection
    qps_kernel = q_n / per

    # the ingest model: one layer, 4 heads
    cfg = BertConfig(n_vocab=512, n_ctx=64, n_embd=e, n_layer=1, n_head=4, n_ff=4 * e)
    engine = Engine.synthetic(cfg, opts=ComputeOptions(dtype="float32"), device=dev)

    # ingest rate: the vectors go from the forward into the index on the device
    words = np.array(_COMMON_WORDS)
    docs = [" ".join(rng.choice(words, size=9)) for _ in range(args.ingest_docs)]
    VectorIndex(engine).add(docs[:256])  # warm the shapes
    best_ing = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        VectorIndex(engine).add(docs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best_ing = min(best_ing, time.perf_counter() - t0)
    ingest_dps = round(len(docs) / best_ing, 1)

    index = VectorIndex(engine)
    index.add_vectors(np.asarray(rng.normal(size=(n, e)), np.float32))
    qhost = np.asarray(rng.normal(size=(q_n, e)), np.float32)
    index.search_vectors(qhost, k)  # warmup
    best_e2e = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        index.search_vectors(qhost, k)
        best_e2e = min(best_e2e, time.perf_counter() - t0)

    result = {
        "metric": "search_queries_per_sec_device",
        "value": round(qps_kernel, 1),
        "unit": "queries/s",
        "corpus": n,
        "dim": e,
        "k": k,
        "kernel_us_per_batch_exact": round(per * 1e6, 1),
        "kernel_us_per_batch_approx": round(per_approx * 1e6, 1),
        "approx_queries_per_sec": round(q_n / per_approx, 1),
        "approx": "exact selection: torch has no approx_max_k (VectorIndex(exact=False) "
                  "runs the exact one)",
        "end_to_end_ms_per_batch": round(best_e2e * 1e3, 2),
        "ingest_docs_per_sec": ingest_dps,
        "platform": dev.type,
        "device": device_block(dev),
    }
    print(f"# corpus {n} x {e}: exact {per*1e6:.0f} us / {q_n} queries "
          f"({qps_kernel:,.0f} q/s); 'approx' (exact again) {per_approx*1e6:.0f} us; "
          f"end-to-end {best_e2e*1e3:.2f} ms", file=sys.stderr)
    print(json.dumps(result))
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
