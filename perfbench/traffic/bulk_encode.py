"""Bulk ingest: one caller sends back-to-back `Engine.encode` calls (a closed
loop of one), each of `texts_per_call` texts whose lengths follow the
workload file's `length`.  Every call holds the same lengths; call k's
order of them and its words come from (seed, k) alone, so every run of a
seed sends the same calls in the same order and every seed the same work.

The window opens after the warm call and closes at the end of the first
call that ends after `--seconds`: `tokens_per_s` is the framed tokens of
every call completed in it over its length.  The benchmark's own making of
the next call's texts is left out of that length (an indexer has its texts
ready; the program is idle meanwhile, its previous call returned).
"""
from __future__ import annotations

import time
from statistics import NormalDist

import numpy as np

WARM_CALL = 1 << 40  # the warm call's index: no timed call shares its texts
# outside the engine's spans the host is between calls
IDLE = "between_calls"


def lengths(rng, spec: dict, n: int) -> np.ndarray:
    """n framed lengths (words + [CLS] + [SEP]) of the distribution `spec`:
    its n quantiles at (i + 1/2) / n, the same in every call of every seed,
    in an order `rng` draws, so no seed changes the work.  "normal" (mean,
    std, at least `min` words, at most `max`), "uniform" or "loguniform"
    (min..max framed tokens, inclusive)."""
    u = (np.arange(n) + 0.5) / n
    dist = spec["dist"]
    if dist == "normal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        words = np.round(spec["mean"] + spec["std"] * z)
        out = np.clip(words, spec["min"], spec["max"]).astype(np.int64) + 2
    elif dist == "uniform":
        out = spec["min"] + np.floor(u * (spec["max"] - spec["min"] + 1)).astype(np.int64)
    elif dist == "loguniform":
        x = np.exp(np.log(spec["min"]) + u * (np.log(spec["max"] + 1) - np.log(spec["min"])))
        out = np.minimum(x.astype(np.int64), spec["max"])
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    return rng.permutation(out)


def call_texts(run, k: int) -> tuple[list[str], np.ndarray]:
    """Call k's texts and framed lengths."""
    p = run.params
    rng = np.random.default_rng([run.seed, k])
    framed = lengths(rng, p["length"], p["texts_per_call"])
    voc = run.vocab
    words = rng.choice(voc.word_ids, size=int(framed.sum()))
    texts, off = [], 0
    for n in framed - 2:
        texts.append(voc.text(words[off: off + n]))
        off += n
    return texts, framed


def _encode(run, texts: list[str]) -> np.ndarray:
    return run.engine.encode(texts)


def warm(run) -> None:
    """One call of the cell's own traffic: the row and length buckets every
    timed call lands in."""
    texts, _ = call_texts(run, WARM_CALL)
    _encode(run, texts)


def window(run) -> dict:
    calls, answers = [], []
    k, making = 0, 0.0
    texts, framed = call_texts(run, k)
    run.mark("start")
    t0 = time.perf_counter()
    while True:
        with run.span("encode"):
            vecs = _encode(run, texts)
        calls.append(framed)
        answers.append((texts, framed, vecs))
        k += 1
        if time.perf_counter() - t0 - making >= run.seconds:
            break
        t = time.perf_counter()
        with run.span("generate"):
            texts, framed = call_texts(run, k)
        making += time.perf_counter() - t
    seconds = time.perf_counter() - t0 - making
    run.mark("end")
    lens = np.concatenate(calls)
    return {
        "seconds": seconds, "lengths": lens, "attempted": int(lens.size), "failed": 0,
        "answers": answers, "calls": len(calls), "making_s": making,
        "e2e": {"tokens_per_s": float(lens.sum()) / seconds},
    }


def traced_slice(run, min_seconds: float = 1.0, min_calls: int = 2) -> np.ndarray:
    """Calls after the window, at least `min_calls` and `min_seconds` of
    them, while the profiler records; returns their framed lengths."""
    lens, k = [], 1 << 41
    t0 = time.perf_counter()
    while len(lens) < min_calls or time.perf_counter() - t0 < min_seconds:
        with run.span("generate"):
            texts, framed = call_texts(run, k)
        with run.span("encode"):
            _encode(run, texts)
        lens.append(framed)
        k += 1
    return np.concatenate(lens)
