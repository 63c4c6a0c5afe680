"""The three retrieval indexes on the GPU at deployment sizes, on synthetic
data from a seed: the latency of an ingest and of a search through the
public calls (`add_vectors` / `add_token_vectors`, `search_vectors` /
`search_token_vectors`).  It runs no model, so it can time two trees of
the port in one call (a parent and a change, each from its own checkout).

    python -m embedding_cpp_tpu_torch.benchmarks.indexes [--runs 20] [--out FILE]

Cases (k = 10; one search of 64 queries unless named):
- `dense_small`: 3,000 unit vectors of 384 (bf16), 512 queries: where a
  search's fixed costs weigh most;
- `dense_1m`: 1,000,000 unit vectors of 384, bf16 and f32;
- `sparse_100k`: 100,000 documents of 256 terms over 30,522 ids, exact
  and `candidates=1000`;
- `maxsim_10k`: 10,000 documents of 256 tokens x 128 (bf16), exact and
  `candidates=256`.

A search's time is the median (`_ms`) and the least (`_min_ms`) of
CUDA-event times over `--runs` calls after one warm-up; each call fetches
its result to the host, so a time is the call's latency, host work
included.  A dense ingest is the least of 3 into a new index, the others
one call.  The last line of standard output is one JSON object with a
`device` entry (the card's name and power limit from nvidia-smi).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..utils.profiling import device_block

K = 10


def _ms(fn, runs: int) -> tuple[float, float]:
    """(median, least) ms of fn() over `runs` calls after a warm-up."""
    fn()
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), float(np.min(times))


def _timed(out: dict, key: str, fn, runs: int) -> None:
    out[f"{key}_ms"], out[f"{key}_min_ms"] = _ms(fn, runs)


def _timed_add(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _host(dev, n_embd: int):
    """The engine fields the indexes read on their vector-only calls."""
    config = SimpleNamespace(n_embd=n_embd, colbert_dim=0, normalize=True)
    return SimpleNamespace(n_embd=n_embd, device=dev, mesh=None, config=config)


def bench_dense(dev, n: int, nq: int, dtypes, runs: int, seed: int) -> dict:
    from ..runtime.search import VectorIndex

    gen = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn(n, 384, device=dev, generator=gen)
    q = torch.randn(nq, 384, device=dev, generator=gen).cpu().numpy()
    out = {"vectors": n, "dim": 384, "queries": nq}
    for dtype in dtypes:
        adds = []
        for _ in range(3):
            index = VectorIndex(_host(dev, 384), dtype=dtype)
            adds.append(_timed_add(lambda: index.add_vectors(v)))
        out[f"add_ms_{dtype}"] = min(adds)
        _timed(out, f"search_{dtype}", lambda: index.search_vectors(q, K), runs)
        del index
        torch.cuda.empty_cache()
    return out


def bench_sparse(dev, runs: int, seed: int, ns: int = 100_000, kd: int = 256,
                 vocab: int = 30522, nq: int = 64) -> dict:
    from ..runtime.sparse_search import SparseIndex

    rng = np.random.default_rng(seed)
    draws = np.sort(rng.integers(0, vocab, (ns, 320)), axis=1)
    dup = np.zeros(draws.shape, bool)
    dup[:, 1:] = draws[:, 1:] == draws[:, :-1]
    ids = np.take_along_axis(draws, np.argsort(dup, axis=1, kind="stable"), 1)[:, :kd]
    ids = np.ascontiguousarray(ids, np.int32)
    weights = rng.random((ns, kd), dtype=np.float32)
    index = SparseIndex(device=dev, nnz_width=kd)
    add_ms = _timed_add(lambda: index.add_vectors(list(zip(ids, weights))))
    queries = [(rng.choice(vocab, 48, replace=False).astype(np.int32),
                rng.random(48, dtype=np.float32)) for _ in range(nq)]
    out = {"documents": ns, "nnz_width": kd, "queries": nq, "add_ms": add_ms}
    _timed(out, "search", lambda: index.search_vectors(queries, K), runs)
    _timed(out, "candidates_1000", lambda: index.search_vectors(queries, K, candidates=1000),
           runs)
    return out


def bench_maxsim(dev, runs: int, seed: int, nm: int = 10_000, sd: int = 256, e: int = 128,
                 nq: int = 64) -> dict:
    from ..runtime.maxsim_search import MaxSimIndex

    rng = np.random.default_rng(seed)
    index = MaxSimIndex(_host(dev, e), doc_maxlen=sd, capacity=nm)
    docs = [list(rng.standard_normal((2000, sd, e), dtype=np.float32))
            for _ in range(0, nm, 2000)]
    add_ms = _timed_add(lambda: [index.add_token_vectors(d) for d in docs])
    queries = list(rng.standard_normal((nq, 32, e), dtype=np.float32))
    out = {"documents": nm, "doc_maxlen": sd, "dim": e, "queries": nq, "add_ms": add_ms}
    _timed(out, "search", lambda: index.search_token_vectors(queries, K), runs)
    _timed(out, "candidates_256",
           lambda: index.search_token_vectors(queries, K, candidates=256), runs)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--runs", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also write the JSON result to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the index timings run only on the GPU")
    dev = torch.device("cuda")
    results = {"device": device_block()}
    for key, fn in (
        ("dense_small", lambda: bench_dense(dev, 3000, 512, ("bfloat16",), args.runs,
                                            args.seed)),
        ("dense_1m", lambda: bench_dense(dev, 1_000_000, 64, ("bfloat16", "float32"),
                                         args.runs, args.seed)),
        ("sparse_100k", lambda: bench_sparse(dev, args.runs, args.seed)),
        ("maxsim_10k", lambda: bench_maxsim(dev, args.runs, args.seed)),
    ):
        results[key] = fn()
        torch.cuda.empty_cache()
        print(f"{key}: {json.dumps(results[key])}", file=sys.stderr, flush=True)
    line = json.dumps(results)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
