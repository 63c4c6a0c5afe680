"""GGUF tensor-name schema of the BERT and ModernBERT encoders.

GGUF files keep the verbatim HF state-dict names.  This maps them to the
parameter keys the forward reads (q_w, ffn_up_w, ln_att_scale, ...), with
each tensor's expected [out, in] shape — the BERT and ModernBERT entries of
the JAX package's `models/schema.py`.
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

# --- ModernBERT ---------------------------------------------------------------
# HF ModernBertModel names, bias-free throughout, no token-type or position
# table (RoPE).  Wqkv [3E, E] and the GeGLU Wi [2F, E] stay fused on disk
# and are split at load (models/params.py) into q/k/v and up/gate.
MODERNBERT_EMBEDDING_TENSORS = {
    "embeddings.tok_embeddings.weight": ("word", lambda c: (c.n_vocab, c.n_embd)),
    "embeddings.norm.weight": ("ln_scale", lambda c: (c.n_embd,)),
}

MODERNBERT_LAYER_TENSORS = {
    # absent for layer 0, whose attention norm is the identity
    "layers.{i}.attn_norm.weight": ("ln_att_scale", lambda c: (c.n_embd,)),
    "layers.{i}.attn.Wqkv.weight": ("wqkv", lambda c: (3 * c.n_embd, c.n_embd)),
    "layers.{i}.attn.Wo.weight": ("o_w", lambda c: (c.n_embd, c.n_embd)),
    "layers.{i}.mlp_norm.weight": ("ln_out_scale", lambda c: (c.n_embd,)),
    "layers.{i}.mlp.Wi.weight": ("wi", lambda c: (2 * c.n_ff, c.n_embd)),
    "layers.{i}.mlp.Wo.weight": ("ffn_down_w", lambda c: (c.n_embd, c.n_ff)),
}

MODERNBERT_EXTRA_TENSORS = {
    "final_norm.weight": ("final_ln_scale", lambda c: (c.n_embd,)),
}


def embedding_tensors(config) -> dict:
    """Embedding-level tensor map; a BERT config without token types has
    no token-type table."""
    if config.arch == "modernbert":
        return MODERNBERT_EMBEDDING_TENSORS
    if config.n_token_types == 0:
        return {k: v for k, v in EMBEDDING_TENSORS.items() if v[0] != "token_type"}
    return EMBEDDING_TENSORS


def layer_tensor_names(i: int, config=None) -> dict[str, tuple[str, object]]:
    modern = config is not None and config.arch == "modernbert"
    named = {t.format(i=i): v for t, v in
             (MODERNBERT_LAYER_TENSORS if modern else LAYER_TENSORS).items()}
    if modern and i == 0:
        named = {k: v for k, v in named.items() if v[0] != "ln_att_scale"}
    return named


def extra_tensors(config) -> dict:
    """Encoder-level tensors outside embeddings and layers: ModernBERT's
    final LayerNorm scale."""
    return MODERNBERT_EXTRA_TENSORS if config.arch == "modernbert" else {}
