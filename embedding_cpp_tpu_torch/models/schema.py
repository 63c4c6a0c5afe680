"""GGUF tensor-name schema of the BERT-graph (BERT, RoBERTa/XLM-R,
DistilBERT, ELECTRA, MPNet, ALBERT), T5, ModernBERT, DeBERTa and
nomic-bert encoders.

GGUF files keep the verbatim HF state-dict names.  This maps them to the
parameter keys the forward reads (q_w, ffn_up_w, ln_att_scale, ...), with
each tensor's expected [out, in] shape — the JAX package's
`models/schema.py`, and its classification heads but ModernBERT's.
RoBERTa and ELECTRA keep BertModel's names (RoBERTa's position table has
pos_offset extra rows and its token-type table one row; ELECTRA-small's
tables are emb_width wide, projected up by `embeddings_project`);
DistilBERT has its own module names and no token-type table; MPNet its
own attention names and one relative-bias table for every layer; ALBERT
BERT's embedding names at emb_width and one shared layer; T5 the
`shared` word table, bias-free blocks and block 0's relative-bias table.
"""
from __future__ import annotations

# shapes at c.emb_width: n_embd unless the tables are factorized (ELECTRA)
EMBEDDING_TENSORS = {
    "embeddings.word_embeddings.weight": ("word", lambda c: (c.n_vocab, c.emb_width)),
    "embeddings.token_type_embeddings.weight": (
        "token_type", lambda c: (c.n_token_types, c.emb_width),
    ),
    "embeddings.position_embeddings.weight": (
        "position", lambda c: (c.n_ctx + c.pos_offset, c.emb_width),
    ),
    "embeddings.LayerNorm.weight": ("ln_scale", lambda c: (c.emb_width,)),
    "embeddings.LayerNorm.bias": ("ln_bias", lambda c: (c.emb_width,)),
}

# ELECTRA's factorized-embedding projection (HF ElectraModel.
# embeddings_project, present only when embedding_size != hidden_size):
# the LayerNormed emb_width embeddings -> n_embd before layer 0
_ELECTRA_EMB_PROJ_TENSORS = {
    "embeddings_project.weight": ("emb_proj_w", lambda c: (c.n_embd, c.emb_width)),
    "embeddings_project.bias": ("emb_proj_b", lambda c: (c.n_embd,)),
}
# ALBERT's (HF AlbertTransformer.embedding_hidden_mapping_in, always there)
_ALBERT_EMB_PROJ_TENSORS = {
    "encoder.embedding_hidden_mapping_in.weight": ("emb_proj_w",
                                                   lambda c: (c.n_embd, c.emb_width)),
    "encoder.embedding_hidden_mapping_in.bias": ("emb_proj_b", lambda c: (c.n_embd,)),
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

# --- DistilBERT ----------------------------------------------------------------
# HF DistilBertModel: BertModel's embedding names without the token-type
# table, and its own encoder names
_DISTILBERT_PREFIX = "transformer.layer.{i}."
DISTILBERT_LAYER_TENSORS = {
    _DISTILBERT_PREFIX + "attention.q_lin.weight": ("q_w", lambda c: (c.n_embd, c.n_embd)),
    _DISTILBERT_PREFIX + "attention.q_lin.bias": ("q_b", lambda c: (c.n_embd,)),
    _DISTILBERT_PREFIX + "attention.k_lin.weight": ("k_w", lambda c: (c.n_embd, c.n_embd)),
    _DISTILBERT_PREFIX + "attention.k_lin.bias": ("k_b", lambda c: (c.n_embd,)),
    _DISTILBERT_PREFIX + "attention.v_lin.weight": ("v_w", lambda c: (c.n_embd, c.n_embd)),
    _DISTILBERT_PREFIX + "attention.v_lin.bias": ("v_b", lambda c: (c.n_embd,)),
    _DISTILBERT_PREFIX + "attention.out_lin.weight": ("o_w", lambda c: (c.n_embd, c.n_embd)),
    _DISTILBERT_PREFIX + "attention.out_lin.bias": ("o_b", lambda c: (c.n_embd,)),
    _DISTILBERT_PREFIX + "sa_layer_norm.weight": ("ln_att_scale", lambda c: (c.n_embd,)),
    _DISTILBERT_PREFIX + "sa_layer_norm.bias": ("ln_att_bias", lambda c: (c.n_embd,)),
    _DISTILBERT_PREFIX + "ffn.lin1.weight": ("ffn_up_w", lambda c: (c.n_ff, c.n_embd)),
    _DISTILBERT_PREFIX + "ffn.lin1.bias": ("ffn_up_b", lambda c: (c.n_ff,)),
    _DISTILBERT_PREFIX + "ffn.lin2.weight": ("ffn_down_w", lambda c: (c.n_embd, c.n_ff)),
    _DISTILBERT_PREFIX + "ffn.lin2.bias": ("ffn_down_b", lambda c: (c.n_embd,)),
    _DISTILBERT_PREFIX + "output_layer_norm.weight": ("ln_out_scale", lambda c: (c.n_embd,)),
    _DISTILBERT_PREFIX + "output_layer_norm.bias": ("ln_out_bias", lambda c: (c.n_embd,)),
}

# --- MPNet ---------------------------------------------------------------------
# HF MPNetModel: no token-type table, positions numbered from 2, the
# attention's linears under attention.attn.{q,k,v,o} and its LayerNorm
# directly under attention; one encoder-level relative-attention-bias table
# [buckets, H] shared by every layer (MPNetEncoder.relative_attention_bias)
MPNET_EMBEDDING_TENSORS = {
    "embeddings.word_embeddings.weight": ("word", lambda c: (c.n_vocab, c.n_embd)),
    "embeddings.position_embeddings.weight": (
        "position", lambda c: (c.n_ctx + c.pos_offset, c.n_embd),
    ),
    "embeddings.LayerNorm.weight": ("ln_scale", lambda c: (c.n_embd,)),
    "embeddings.LayerNorm.bias": ("ln_bias", lambda c: (c.n_embd,)),
}

MPNET_LAYER_TENSORS = {
    name.replace(".attention.self.query.", ".attention.attn.q.")
        .replace(".attention.self.key.", ".attention.attn.k.")
        .replace(".attention.self.value.", ".attention.attn.v.")
        .replace(".attention.output.dense.", ".attention.attn.o.")
        .replace(".attention.output.LayerNorm.", ".attention.LayerNorm."): spec
    for name, spec in LAYER_TENSORS.items()
}

_REL_ATTN_BIAS = ("rel_attn_bias", lambda c: (c.rel_attn_buckets, c.n_head))
MPNET_EXTRA_TENSORS = {"encoder.relative_attention_bias.weight": _REL_ATTN_BIAS}

# --- ALBERT --------------------------------------------------------------------
# HF AlbertModel: one parameter set serves every layer (num_hidden_groups =
# inner_group_num = 1 in every published checkpoint), so the names carry no
# layer index and the stack has leading dim 1; BERT's post-norm block math
_ALBERT_PREFIX = "encoder.albert_layer_groups.0.albert_layers.0."
ALBERT_LAYER_TENSORS = {
    _ALBERT_PREFIX + "attention.query.weight": ("q_w", lambda c: (c.n_embd, c.n_embd)),
    _ALBERT_PREFIX + "attention.query.bias": ("q_b", lambda c: (c.n_embd,)),
    _ALBERT_PREFIX + "attention.key.weight": ("k_w", lambda c: (c.n_embd, c.n_embd)),
    _ALBERT_PREFIX + "attention.key.bias": ("k_b", lambda c: (c.n_embd,)),
    _ALBERT_PREFIX + "attention.value.weight": ("v_w", lambda c: (c.n_embd, c.n_embd)),
    _ALBERT_PREFIX + "attention.value.bias": ("v_b", lambda c: (c.n_embd,)),
    _ALBERT_PREFIX + "attention.dense.weight": ("o_w", lambda c: (c.n_embd, c.n_embd)),
    _ALBERT_PREFIX + "attention.dense.bias": ("o_b", lambda c: (c.n_embd,)),
    _ALBERT_PREFIX + "attention.LayerNorm.weight": ("ln_att_scale", lambda c: (c.n_embd,)),
    _ALBERT_PREFIX + "attention.LayerNorm.bias": ("ln_att_bias", lambda c: (c.n_embd,)),
    _ALBERT_PREFIX + "ffn.weight": ("ffn_up_w", lambda c: (c.n_ff, c.n_embd)),
    _ALBERT_PREFIX + "ffn.bias": ("ffn_up_b", lambda c: (c.n_ff,)),
    _ALBERT_PREFIX + "ffn_output.weight": ("ffn_down_w", lambda c: (c.n_embd, c.n_ff)),
    _ALBERT_PREFIX + "ffn_output.bias": ("ffn_down_b", lambda c: (c.n_embd,)),
    _ALBERT_PREFIX + "full_layer_layer_norm.weight": ("ln_out_scale", lambda c: (c.n_embd,)),
    _ALBERT_PREFIX + "full_layer_layer_norm.bias": ("ln_out_bias", lambda c: (c.n_embd,)),
}

# --- T5 encoder ----------------------------------------------------------------
# HF T5EncoderModel (sentence-t5 / GTR): bias-free throughout; the word
# table is `shared`; one relative-attention-bias table on block 0 serves
# every layer (T5Attention.has_relative_attention_bias); RMSNorm scales
# only; q/k/v map n_embd -> attn_inner (n_head * d_kv)
T5_EMBEDDING_TENSORS = {"shared.weight": ("word", lambda c: (c.n_vocab, c.n_embd))}

_T5L = "encoder.block.{i}.layer."
T5_LAYER_TENSORS = {
    _T5L + "0.SelfAttention.q.weight": ("q_w", lambda c: (c.attn_inner, c.n_embd)),
    _T5L + "0.SelfAttention.k.weight": ("k_w", lambda c: (c.attn_inner, c.n_embd)),
    _T5L + "0.SelfAttention.v.weight": ("v_w", lambda c: (c.attn_inner, c.n_embd)),
    _T5L + "0.SelfAttention.o.weight": ("o_w", lambda c: (c.n_embd, c.attn_inner)),
    _T5L + "0.layer_norm.weight": ("ln_att_scale", lambda c: (c.n_embd,)),
    _T5L + "1.DenseReluDense.wo.weight": ("ffn_down_w", lambda c: (c.n_embd, c.n_ff)),
    _T5L + "1.layer_norm.weight": ("ln_out_scale", lambda c: (c.n_embd,)),
}
# v1.0: wo(act(wi x)); v1.1 gated: wo(act(wi_0 x) * wi_1 x)
_T5_WI = {_T5L + "1.DenseReluDense.wi.weight": ("ffn_up_w", lambda c: (c.n_ff, c.n_embd))}
_T5_WI_GATED = {
    _T5L + "1.DenseReluDense.wi_0.weight": ("ffn_up_w", lambda c: (c.n_ff, c.n_embd)),
    _T5L + "1.DenseReluDense.wi_1.weight": ("ffn_gate_w", lambda c: (c.n_ff, c.n_embd)),
}

T5_EXTRA_TENSORS = {
    "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": _REL_ATTN_BIAS,
    "encoder.final_layer_norm.weight": ("final_ln_scale", lambda c: (c.n_embd,)),
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

# --- DeBERTa-v3 ---------------------------------------------------------------
# HF DebertaV2Model names (no absolute-position or token-type table; the
# q/k/v projections are *_proj; otherwise BERT's post-norm block).
# Encoder-level: the shared relative-position table [2*buckets, E] and its
# LayerNorm (norm_rel_ebd="layer_norm", encoder.LayerNorm).
DEBERTA_EMBEDDING_TENSORS = {
    "embeddings.word_embeddings.weight": ("word", lambda c: (c.n_vocab, c.n_embd)),
    "embeddings.LayerNorm.weight": ("ln_scale", lambda c: (c.n_embd,)),
    "embeddings.LayerNorm.bias": ("ln_bias", lambda c: (c.n_embd,)),
}

DEBERTA_LAYER_TENSORS = {
    name.replace(".self.query.", ".self.query_proj.")
        .replace(".self.key.", ".self.key_proj.")
        .replace(".self.value.", ".self.value_proj."): spec
    for name, spec in LAYER_TENSORS.items()
}

DEBERTA_EXTRA_TENSORS = {
    "encoder.rel_embeddings.weight": ("rel_emb", lambda c: (2 * c.rel_attn_buckets, c.n_embd)),
    "encoder.LayerNorm.weight": ("rel_ln_scale", lambda c: (c.n_embd,)),
    "encoder.LayerNorm.bias": ("rel_ln_bias", lambda c: (c.n_embd,)),
}

# --- nomic-bert ----------------------------------------------------------------
# HF NomicBertModel names (nomic-embed-text-v1/v1.5): a fused attn.Wqkv
# [3E, E] split at load into q/k/v like ModernBERT's, post-norm blocks
# (norm1 after attention, norm2 after the MLP), and the SwiGLU MLP
# fc2(fc11(x) * silu(fc12(x))).  fc12 is the activated half, so it maps to
# ffn_up_w (the linear that carries the activation); fc11, the raw
# multiplicand, to ffn_gate_w.  The bias rows join only when
# config.attn_bias / config.ffn_bias say so (published checkpoints have
# none); Wqkv's bias splits into q/k/v thirds.
NOMIC_EMBEDDING_TENSORS = {
    "embeddings.word_embeddings.weight": ("word", lambda c: (c.n_vocab, c.n_embd)),
    "embeddings.token_type_embeddings.weight": (
        "token_type", lambda c: (c.n_token_types, c.n_embd),
    ),
    "emb_ln.weight": ("ln_scale", lambda c: (c.n_embd,)),
    "emb_ln.bias": ("ln_bias", lambda c: (c.n_embd,)),
}

_NOMIC_PREFIX = "encoder.layers.{i}."
NOMIC_LAYER_TENSORS = {
    _NOMIC_PREFIX + "attn.Wqkv.weight": ("wqkv", lambda c: (3 * c.n_embd, c.n_embd)),
    _NOMIC_PREFIX + "attn.out_proj.weight": ("o_w", lambda c: (c.n_embd, c.n_embd)),
    _NOMIC_PREFIX + "norm1.weight": ("ln_att_scale", lambda c: (c.n_embd,)),
    _NOMIC_PREFIX + "norm1.bias": ("ln_att_bias", lambda c: (c.n_embd,)),
    _NOMIC_PREFIX + "norm2.weight": ("ln_out_scale", lambda c: (c.n_embd,)),
    _NOMIC_PREFIX + "norm2.bias": ("ln_out_bias", lambda c: (c.n_embd,)),
    _NOMIC_PREFIX + "mlp.fc11.weight": ("ffn_gate_w", lambda c: (c.n_ff, c.n_embd)),
    _NOMIC_PREFIX + "mlp.fc12.weight": ("ffn_up_w", lambda c: (c.n_ff, c.n_embd)),
    _NOMIC_PREFIX + "mlp.fc2.weight": ("ffn_down_w", lambda c: (c.n_embd, c.n_ff)),
}
_NOMIC_ATTN_BIAS_TENSORS = {
    _NOMIC_PREFIX + "attn.Wqkv.bias": ("wqkv_b", lambda c: (3 * c.n_embd,)),
    _NOMIC_PREFIX + "attn.out_proj.bias": ("o_b", lambda c: (c.n_embd,)),
}
_NOMIC_FFN_BIAS_TENSORS = {
    _NOMIC_PREFIX + "mlp.fc11.bias": ("ffn_gate_b", lambda c: (c.n_ff,)),
    _NOMIC_PREFIX + "mlp.fc12.bias": ("ffn_up_b", lambda c: (c.n_ff,)),
    _NOMIC_PREFIX + "mlp.fc2.bias": ("ffn_down_b", lambda c: (c.n_embd,)),
}

# --- sequence-classification heads (present only when n_labels > 0) ----------
# logits = out(act(dense(h_cls))): BERT's pooler + classifier; DeBERTa's
# ContextPooler (dense + gelu on the first token) has the same names.
# RoBERTa's ClassificationHead (dense + tanh + out_proj; XLM-R rerankers
# such as bge-reranker-base share it) and ELECTRA's (the same names, gelu);
# DistilBERT's pre_classifier + relu + classifier; MPNet's
# ClassificationHead has RoBERTa's names; ALBERT's pooler is a bare linear
# (pooler.weight) + tanh before the classifier.
_BERT_HEAD_TENSORS = {
    "pooler.dense.weight": ("head_dense_w", lambda c: (c.n_embd, c.n_embd)),
    "pooler.dense.bias": ("head_dense_b", lambda c: (c.n_embd,)),
    "classifier.weight": ("head_out_w", lambda c: (c.n_labels, c.n_embd)),
    "classifier.bias": ("head_out_b", lambda c: (c.n_labels,)),
}
_ROBERTA_HEAD_TENSORS = {
    "classifier.dense.weight": ("head_dense_w", lambda c: (c.n_embd, c.n_embd)),
    "classifier.dense.bias": ("head_dense_b", lambda c: (c.n_embd,)),
    "classifier.out_proj.weight": ("head_out_w", lambda c: (c.n_labels, c.n_embd)),
    "classifier.out_proj.bias": ("head_out_b", lambda c: (c.n_labels,)),
}
_DISTILBERT_HEAD_TENSORS = {
    "pre_classifier.weight": ("head_dense_w", lambda c: (c.n_embd, c.n_embd)),
    "pre_classifier.bias": ("head_dense_b", lambda c: (c.n_embd,)),
    "classifier.weight": ("head_out_w", lambda c: (c.n_labels, c.n_embd)),
    "classifier.bias": ("head_out_b", lambda c: (c.n_labels,)),
}
_ALBERT_HEAD_TENSORS = {
    "pooler.weight": ("head_dense_w", lambda c: (c.n_embd, c.n_embd)),
    "pooler.bias": ("head_dense_b", lambda c: (c.n_embd,)),
    "classifier.weight": ("head_out_w", lambda c: (c.n_labels, c.n_embd)),
    "classifier.bias": ("head_out_b", lambda c: (c.n_labels,)),
}
# ModernBERT's PredictionHead: dense and LayerNorm without biases, then a
# biased classifier, after pooling per `pooling` (cls or mean)
_MODERNBERT_HEAD_TENSORS = {
    "head.dense.weight": ("head_dense_w", lambda c: (c.n_embd, c.n_embd)),
    "head.norm.weight": ("head_norm_scale", lambda c: (c.n_embd,)),
    "classifier.weight": ("head_out_w", lambda c: (c.n_labels, c.n_embd)),
    "classifier.bias": ("head_out_b", lambda c: (c.n_labels,)),
}
_HEAD_TENSORS_BY_ARCH = {"bert": _BERT_HEAD_TENSORS, "roberta": _ROBERTA_HEAD_TENSORS,
                         "distilbert": _DISTILBERT_HEAD_TENSORS,
                         "electra": _ROBERTA_HEAD_TENSORS, "deberta": _BERT_HEAD_TENSORS,
                         "mpnet": _ROBERTA_HEAD_TENSORS, "albert": _ALBERT_HEAD_TENSORS,
                         "modernbert": _MODERNBERT_HEAD_TENSORS}


def head_tensors(config) -> dict:
    """Classification-head tensor map (empty for embedding models)."""
    if not config.n_labels:
        return {}
    return _HEAD_TENSORS_BY_ARCH[config.arch]


# --- MLM prediction heads (SPLADE; present only when config.mlm_head) --------
# logits = LayerNorm(gelu(dense(h))) @ word_tableᵀ + bias: the decoder is
# tied to the word table, so only the transform, its LayerNorm and the |V|
# bias are stored.  BERT's cls.predictions.*, RoBERTa's lm_head.*,
# DistilBERT's vocab_transform / vocab_layer_norm / vocab_projector.bias.
_BERT_MLM_TENSORS = {
    "cls.predictions.transform.dense.weight": ("mlm_dense_w", lambda c: (c.n_embd, c.n_embd)),
    "cls.predictions.transform.dense.bias": ("mlm_dense_b", lambda c: (c.n_embd,)),
    "cls.predictions.transform.LayerNorm.weight": ("mlm_ln_scale", lambda c: (c.n_embd,)),
    "cls.predictions.transform.LayerNorm.bias": ("mlm_ln_bias", lambda c: (c.n_embd,)),
    "cls.predictions.bias": ("mlm_bias", lambda c: (c.n_vocab,)),
}
_ROBERTA_MLM_TENSORS = {
    "lm_head.dense.weight": ("mlm_dense_w", lambda c: (c.n_embd, c.n_embd)),
    "lm_head.dense.bias": ("mlm_dense_b", lambda c: (c.n_embd,)),
    "lm_head.layer_norm.weight": ("mlm_ln_scale", lambda c: (c.n_embd,)),
    "lm_head.layer_norm.bias": ("mlm_ln_bias", lambda c: (c.n_embd,)),
    "lm_head.bias": ("mlm_bias", lambda c: (c.n_vocab,)),
}
_DISTILBERT_MLM_TENSORS = {
    "vocab_transform.weight": ("mlm_dense_w", lambda c: (c.n_embd, c.n_embd)),
    "vocab_transform.bias": ("mlm_dense_b", lambda c: (c.n_embd,)),
    "vocab_layer_norm.weight": ("mlm_ln_scale", lambda c: (c.n_embd,)),
    "vocab_layer_norm.bias": ("mlm_ln_bias", lambda c: (c.n_embd,)),
    "vocab_projector.bias": ("mlm_bias", lambda c: (c.n_vocab,)),
}
_MLM_TENSORS_BY_ARCH = {"bert": _BERT_MLM_TENSORS, "roberta": _ROBERTA_MLM_TENSORS,
                        "distilbert": _DISTILBERT_MLM_TENSORS}


def mlm_tensors(config) -> dict:
    """MLM prediction-head tensor map (empty unless config.mlm_head)."""
    if not config.mlm_head:
        return {}
    return _MLM_TENSORS_BY_ARCH[config.arch]


# tied views of the MLM decoder that ForMaskedLM state dicts may carry beside
# the names above: the converter checks the tie and drops them
MLM_TIED_TENSORS = frozenset({
    "cls.predictions.decoder.weight", "cls.predictions.decoder.bias",
    "lm_head.decoder.weight", "lm_head.decoder.bias", "vocab_projector.weight",
})

# tensors the converter drops: position / token-type id buffers, the poolers
# of embedding models (BERT's pooler.dense, ALBERT's bare pooler) and T5's
# encoder.embed_tokens, a second name of `shared`
SKIPPED_TENSORS = frozenset({
    "embeddings.position_ids", "embeddings.token_type_ids",
    "pooler.dense.weight", "pooler.dense.bias", "pooler.weight", "pooler.bias",
    "encoder.embed_tokens.weight",
})


# ColBERT's per-token projection (present only when colbert_dim > 0): the
# bias-free `linear` of HF_ColBERT over every final hidden state
COLBERT_TENSORS = {
    "linear.weight": ("colbert_w", lambda c: (c.colbert_dim, c.n_embd)),
}


def embedding_tensors(config) -> dict:
    """Embedding-level tensor map; DistilBERT, MPNet and a BERT-schema
    config without token types have no token-type table, a DeBERTa config
    with them has one, and a factorized ALBERT or ELECTRA adds its
    projection."""
    if config.arch == "modernbert":
        return MODERNBERT_EMBEDDING_TENSORS
    if config.arch == "mpnet":
        return MPNET_EMBEDDING_TENSORS
    if config.arch == "t5":
        return T5_EMBEDDING_TENSORS
    if config.arch == "nomic-bert":
        return NOMIC_EMBEDDING_TENSORS
    if config.arch == "deberta":
        if not config.n_token_types:
            return DEBERTA_EMBEDDING_TENSORS
        return {**DEBERTA_EMBEDDING_TENSORS, "embeddings.token_type_embeddings.weight":
                ("token_type", lambda c: (c.n_token_types, c.n_embd))}
    base = EMBEDDING_TENSORS
    if config.n_token_types == 0 or config.arch == "distilbert":
        base = {k: v for k, v in base.items() if v[0] != "token_type"}
    if config.n_embd_emb:
        base = {**base, **(_ALBERT_EMB_PROJ_TENSORS if config.arch == "albert"
                           else _ELECTRA_EMB_PROJ_TENSORS)}
    return base


def layer_tensor_names(i: int, config=None) -> dict[str, tuple[str, object]]:
    arch = "bert" if config is None else config.arch
    templates = {"modernbert": MODERNBERT_LAYER_TENSORS, "deberta": DEBERTA_LAYER_TENSORS,
                 "distilbert": DISTILBERT_LAYER_TENSORS, "mpnet": MPNET_LAYER_TENSORS,
                 "albert": ALBERT_LAYER_TENSORS}.get(arch, LAYER_TENSORS)
    if arch == "t5":
        templates = {**T5_LAYER_TENSORS, **(_T5_WI_GATED if config.ffn_gated else _T5_WI)}
    if arch == "nomic-bert":
        templates = {**NOMIC_LAYER_TENSORS,
                     **(_NOMIC_ATTN_BIAS_TENSORS if config.attn_bias else {}),
                     **(_NOMIC_FFN_BIAS_TENSORS if config.ffn_bias else {})}
    named = {t.format(i=i): v for t, v in templates.items()}
    if arch == "modernbert" and i == 0:
        named = {k: v for k, v in named.items() if v[0] != "ln_att_scale"}
    return named


def extra_tensors(config) -> dict:
    """Encoder-level tensors outside embeddings and layers: ModernBERT's
    final LayerNorm scale; DeBERTa's relative table and its LayerNorm;
    T5's relative-bias table and its final RMSNorm scale; for the BERT
    graph, MPNet's relative-bias table wherever the config has buckets."""
    if config.arch in ("modernbert", "deberta", "t5"):
        return {"modernbert": MODERNBERT_EXTRA_TENSORS, "deberta": DEBERTA_EXTRA_TENSORS,
                "t5": T5_EXTRA_TENSORS}[config.arch]
    return MPNET_EXTRA_TENSORS if config.rel_attn_buckets else {}
