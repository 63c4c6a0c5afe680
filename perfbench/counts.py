"""Operations and bytes of a forward, from the configuration's shapes alone,
so they stay the same whatever kernel does the work.

- Linears: each of the model's matrices, per layer: BERT's q, k, v, o, up
  and down; ModernBERT's Wqkv, Wo, Wi (input and gate) and Wo of the FFN.
  A launch of M rows does 2 M K N operations and moves the weight's
  blocks (Q8_0 34 bytes, Q4_0 18 bytes per 32 weights), M K bf16 inputs
  and M N bf16 outputs.
- Attention: 4 E operations a visible (query, key) pair per layer (QK^T
  and PV, each 2 d a head), over the pairs within each text
  (`pairs.text_pairs`: ModernBERT's local layers only those within the
  window); it moves Q, K and V in and the context out, 4 E bf16 values a
  real token per layer.
- `model_flops` (what `mfu` divides): both, over the texts' real tokens.
"""
from __future__ import annotations

import numpy as np

from .pairs import text_pairs
from .peaks import bound_ms

BYTES_PER_WEIGHT = {"q8_0": 34 / 32, "q4_0": 18 / 32}
ACT_BYTES = 2  # bf16 activations


def linears(c: dict) -> list[tuple[int, int]]:
    """(K, N) of each linear of one layer."""
    e, f = c["hidden_size"], c["intermediate_size"]
    if c["arch"] == "bert":
        return [(e, e)] * 4 + [(e, f), (f, e)]
    if c["arch"] == "modernbert":
        return [(e, 3 * e), (e, e), (e, 2 * f), (f, e)]
    raise ValueError(f"no linear shapes for arch {c['arch']!r}")


def layer_windows(c: dict) -> list[int | None]:
    """Each layer's half window (None: global attention)."""
    n = c["num_hidden_layers"]
    if c["arch"] == "modernbert":
        every = c["global_attn_every_n_layers"]
        return [None if i % every == 0 else c["local_attention"] // 2 for i in range(n)]
    return [None] * n


def linear_flops_per_token(c: dict) -> float:
    return 2.0 * c["num_hidden_layers"] * sum(k * n for k, n in linears(c))


def attention_pairs(c: dict, lengths) -> float:
    """Visible pairs over every layer, for texts of `lengths` tokens."""
    by_window: dict = {}
    for w in layer_windows(c):
        by_window[w] = by_window.get(w, 0) + 1
    return sum(k * text_pairs(lengths, w) for w, k in by_window.items())


def attention_flops(c: dict, lengths) -> float:
    return 4.0 * c["hidden_size"] * attention_pairs(c, lengths)


def model_flops(c: dict, lengths) -> float:
    """Linears and attention over the real tokens of texts of `lengths`."""
    tokens = float(np.sum(lengths))
    return linear_flops_per_token(c) * tokens + attention_flops(c, lengths)


def linear_bound_s(c: dict, shapes, peaks) -> float:
    """Summed roofline bound of every linear launched for batches of
    `shapes` [(rows, seq)], each at M = rows x seq (padding included)."""
    bpw = BYTES_PER_WEIGHT[c["qtype"]]
    total = 0.0
    for rows, seq in shapes:
        m = rows * seq
        for k, n in linears(c):
            nbytes = k * n * bpw + ACT_BYTES * m * (k + n)
            total += bound_ms(nbytes, 2.0 * m * k * n, peaks)[0]
    return total * c["num_hidden_layers"] * 1e-3


def attention_bound_s(c: dict, lengths, peaks) -> float:
    """Summed roofline bound of every layer's attention over texts of
    `lengths` (real pairs and real tokens only)."""
    tokens = float(np.sum(lengths))
    e = c["hidden_size"]
    total = 0.0
    for w in layer_windows(c):
        flops = 4.0 * e * text_pairs(lengths, w)
        total += bound_ms(4 * ACT_BYTES * e * tokens, flops, peaks)[0]
    return total * 1e-3
