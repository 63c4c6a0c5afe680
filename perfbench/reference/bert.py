"""BERT (HF `BertModel`, as bge-large-en-v1.5 runs it): word + position +
token-type-0 embeddings and LayerNorm; post-norm layers of biased q/k/v/o
attention (softmax over the text's own tokens) and an exact-GELU FFN, each
added to its input and LayerNormed; the [CLS] state pooled.  f32
throughout; the products in `prec` (f32, or fp8 for the control)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import attention, layer_norm


def tensors(c: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """(name, shape, kind) of the checkpoint, kind "matrix" (quantized),
    "scale" (a LayerNorm weight) or "bias"."""
    e, f = c["hidden_size"], c["intermediate_size"]
    out = [("embeddings.word_embeddings.weight", (c["vocab_size"], e), "matrix"),
           ("embeddings.token_type_embeddings.weight", (c["type_vocab_size"], e), "matrix"),
           ("embeddings.position_embeddings.weight", (c["max_position_embeddings"], e),
            "matrix"),
           ("embeddings.LayerNorm.weight", (e,), "scale"),
           ("embeddings.LayerNorm.bias", (e,), "bias")]
    for i in range(c["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            out += [(f"{p}attention.self.{name}.weight", (e, e), "matrix"),
                    (f"{p}attention.self.{name}.bias", (e,), "bias")]
        out += [(f"{p}attention.output.dense.weight", (e, e), "matrix"),
                (f"{p}attention.output.dense.bias", (e,), "bias"),
                (f"{p}attention.output.LayerNorm.weight", (e,), "scale"),
                (f"{p}attention.output.LayerNorm.bias", (e,), "bias"),
                (f"{p}intermediate.dense.weight", (f, e), "matrix"),
                (f"{p}intermediate.dense.bias", (f,), "bias"),
                (f"{p}output.dense.weight", (e, f), "matrix"),
                (f"{p}output.dense.bias", (e,), "bias"),
                (f"{p}output.LayerNorm.weight", (e,), "scale"),
                (f"{p}output.LayerNorm.bias", (e,), "bias")]
    return out


def forward(w: dict, ids: torch.Tensor, c: dict, prec) -> torch.Tensor:
    """ids [B, L] (framed, all of length L) -> the [CLS] states [B, E]."""
    b, n = ids.shape
    h = c["num_attention_heads"]
    eps = c["layer_norm_eps"]
    x = (w["embeddings.word_embeddings.weight"][ids]
         + w["embeddings.position_embeddings.weight"][:n][None]
         + w["embeddings.token_type_embeddings.weight"][0])
    x = prec.round(layer_norm(x, w["embeddings.LayerNorm.weight"],
                              w["embeddings.LayerNorm.bias"], eps))

    def lin(x, name):
        return prec.linear(x, w[name + ".weight"]) + w[name + ".bias"]

    def heads(t):
        return t.reshape(b, n, h, -1).transpose(1, 2)

    for i in range(c["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        q, k, v = (heads(lin(x, f"{p}attention.self.{s}")) for s in ("query", "key", "value"))
        ctx = attention(q, k, v, None, prec.round).transpose(1, 2).reshape(b, n, -1)
        a = lin(ctx, f"{p}attention.output.dense")
        x = prec.round(layer_norm(x + a, w[f"{p}attention.output.LayerNorm.weight"],
                                  w[f"{p}attention.output.LayerNorm.bias"], eps))
        f = F.gelu(lin(x, f"{p}intermediate.dense"))
        x = prec.round(layer_norm(x + lin(f, f"{p}output.dense"),
                                  w[f"{p}output.LayerNorm.weight"],
                                  w[f"{p}output.LayerNorm.bias"], eps))
    return x[:, 0]
