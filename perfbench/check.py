"""The comparison that decides `correct`.

Once the window has closed and the program is freed, a sample of the
answers the timed path returned (the workload's `check.sample` texts,
`SAMPLE` by default, drawn from the seed, the longest text always among
them) is embedded again by the plain f32
reference (`reference/<arch>.py`, TF32 off) from the texts alone: it
derives the ids itself and dequantizes the same raw blocks, drawn again
from the seed.  The number compared is `vec_gap`, the widest Euclidean
distance between a returned vector and the reference's (both unit
vectors), against the cell's limit in its workload file.  An answer the
traffic counts as failed, or a vector that is not finite, is not correct
either.
"""
from __future__ import annotations

import numpy as np
import torch

from . import weights
from .reference import arch_module
from .reference.common import Precision, TextIds, dequantize, embed_texts

SAMPLE = 256


def sample(answers, seed: int, k: int):
    """(texts, vectors) of k answers drawn from the seed, the longest text
    among them; `answers` is [(texts, framed lengths, [n, E] vectors)]."""
    texts, lens, vecs = [], [], []
    for t, n, v in answers:
        texts += list(t)
        lens.append(np.asarray(n))
        vecs.append(np.asarray(v))
    lens = np.concatenate(lens)
    rng = np.random.default_rng([seed, 0xC4EC])
    pick = rng.choice(len(texts), size=min(k, len(texts)), replace=False)
    longest = int(np.argmax(lens))
    if longest not in pick:
        pick[0] = longest
    allv = np.concatenate(vecs)
    return [texts[i] for i in pick], allv[pick]


def reference_weights(config: dict, seed: int, device) -> dict:
    drawn = weights.draw(config, seed, device)
    out = {}
    for name, shape, _ in arch_module(config["arch"]).tensors(config):
        kind, t = drawn.pop(name)
        out[name] = dequantize(t, config["qtype"], shape) if kind == "blocks" else t
    return out


def reference_vectors(config: dict, vocab, seed: int, texts, device,
                      precision: str = "f32") -> np.ndarray:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ids = [TextIds(vocab, config["max_position_embeddings"])(t) for t in texts]
    w = reference_weights(config, seed, device)
    with torch.inference_mode():
        return embed_texts(arch_module(config["arch"]).forward, w, ids, config,
                           Precision(precision), device)


def gaps(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    return np.linalg.norm(got.astype(np.float64) - ref.astype(np.float64), axis=1)


def compare(run, win: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}})."""
    limit = run.workload["check"]["vec_gap"]
    texts, got = sample(win["answers"], run.seed, run.workload["check"].get("sample", SAMPLE))
    ref = reference_vectors(run.config, run.vocab, run.seed, texts, run.device)
    g = gaps(got, ref)
    value = float(g.max()) if np.isfinite(g).all() else float("inf")
    numbers = {"vec_gap": {"value": value, "limit": limit},
               "failed": {"value": win["failed"], "limit": 0}}
    ok = value <= limit and win["failed"] == 0 and len(texts) > 0
    return ok, numbers
