"""GGUF tensor-name schema of the BERT encoder.

GGUF files keep the verbatim HF BertModel state-dict names.  This maps
them to the parameter keys the forward reads (q_w, ffn_up_w,
ln_att_scale, ...), with each tensor's expected [out, in] shape — the
BERT entries of the JAX package's `models/schema.py`.
"""
from __future__ import annotations

EMBEDDING_TENSORS = {
    "embeddings.word_embeddings.weight": ("word", lambda c: (c.n_vocab, c.n_embd)),
    "embeddings.token_type_embeddings.weight": (
        "token_type", lambda c: (c.n_token_types, c.n_embd),
    ),
    "embeddings.position_embeddings.weight": (
        "position", lambda c: (c.n_ctx + c.pos_offset, c.n_embd),
    ),
    "embeddings.LayerNorm.weight": ("ln_scale", lambda c: (c.n_embd,)),
    "embeddings.LayerNorm.bias": ("ln_bias", lambda c: (c.n_embd,)),
}

LAYER_TENSORS = {
    "encoder.layer.{i}.attention.self.query.weight": ("q_w", lambda c: (c.n_embd, c.n_embd)),
    "encoder.layer.{i}.attention.self.query.bias": ("q_b", lambda c: (c.n_embd,)),
    "encoder.layer.{i}.attention.self.key.weight": ("k_w", lambda c: (c.n_embd, c.n_embd)),
    "encoder.layer.{i}.attention.self.key.bias": ("k_b", lambda c: (c.n_embd,)),
    "encoder.layer.{i}.attention.self.value.weight": ("v_w", lambda c: (c.n_embd, c.n_embd)),
    "encoder.layer.{i}.attention.self.value.bias": ("v_b", lambda c: (c.n_embd,)),
    "encoder.layer.{i}.attention.output.dense.weight": ("o_w", lambda c: (c.n_embd, c.n_embd)),
    "encoder.layer.{i}.attention.output.dense.bias": ("o_b", lambda c: (c.n_embd,)),
    "encoder.layer.{i}.attention.output.LayerNorm.weight": ("ln_att_scale", lambda c: (c.n_embd,)),
    "encoder.layer.{i}.attention.output.LayerNorm.bias": ("ln_att_bias", lambda c: (c.n_embd,)),
    "encoder.layer.{i}.intermediate.dense.weight": ("ffn_up_w", lambda c: (c.n_ff, c.n_embd)),
    "encoder.layer.{i}.intermediate.dense.bias": ("ffn_up_b", lambda c: (c.n_ff,)),
    "encoder.layer.{i}.output.dense.weight": ("ffn_down_w", lambda c: (c.n_embd, c.n_ff)),
    "encoder.layer.{i}.output.dense.bias": ("ffn_down_b", lambda c: (c.n_embd,)),
    "encoder.layer.{i}.output.LayerNorm.weight": ("ln_out_scale", lambda c: (c.n_embd,)),
    "encoder.layer.{i}.output.LayerNorm.bias": ("ln_out_bias", lambda c: (c.n_embd,)),
}

# Optional sentence-transformers Dense head (present only when
# config.dense_out > 0): pooled @ W.T + b between pooling and L2 norm.
DENSE_TENSORS = {
    "dense.linear.weight": ("dense_w", lambda c: (c.dense_out, c.n_embd)),
    "dense.linear.bias": ("dense_b", lambda c: (c.dense_out,)),
}


def embedding_tensors(config) -> dict:
    """Embedding-level tensor map; a config without token types has no
    token-type table."""
    if config.n_token_types == 0:
        return {k: v for k, v in EMBEDDING_TENSORS.items() if v[0] != "token_type"}
    return EMBEDDING_TENSORS


def layer_tensor_names(i: int) -> dict[str, tuple[str, object]]:
    return {t.format(i=i): v for t, v in LAYER_TENSORS.items()}
