"""DeBERTa-v3 encoder forward pass in PyTorch (deberta-v3-base, and the
cross-encoder rerankers built on it: mxbai-rerank-base-v1,
nli-deberta-v3-base).

The JAX package's `models/deberta.py` on dicts of tensors, as a plain loop
over layers.  The block is BERT's post-norm layout (attention + add&norm,
GELU FFN + add&norm); the attention is disentangled:
- relative positions are log-bucketed (`deberta_log_bucket`), computed in
  numpy on the host as the reference computes them at trace time;
- one relative table [2*span, E] shared by every layer, LayerNormed once
  per forward (`_rel_table`);
- each layer projects it through its own q/k projections with their biases
  (share_att_key): two more K1 launches per layer at M = 2*span;
- the scores add a content->position and a position->content term, all
  three scaled by 1/sqrt(3d), in the hand-written kernel
  (ops/deberta_attention.py): K9 for plain batches, K10 for packed rows.

v3 has no absolute-position or token-type table: the embeddings are
LN(word[ids]) with eps 1e-7.
"""
from __future__ import annotations

import torch

from ..ops.attention import MASK_BIAS
from ..ops.deberta_attention import disentangled_attention, disentangled_attention_packed
from ..ops.linear import layer_norm, linear
from .config import BertConfig


def _rel_table(params: dict, config: BertConfig, dtype) -> torch.Tensor:
    """The LayerNormed relative table [2*span, E], once per forward."""
    table = params["rel_emb"][: 2 * config.rel_attn_buckets]
    return layer_norm(table, params["rel_ln_scale"], params["rel_ln_bias"],
                      config.layer_norm_eps, dtype)


def _attention(x: torch.Tensor, lp: dict, rel_table: torch.Tensor, mask: torch.Tensor,
               config: BertConfig, packed: bool) -> torch.Tensor:
    """Disentangled self-attention -> [B, S, E].  mask: the [B, S] f32 key
    bias, or the [B, S] int32 segment ids of packed rows."""
    b, s, _ = x.shape
    d = config.head_dim
    q = linear(x, lp["q_w"], lp["q_b"])
    e = q.shape[-1]  # n_head / tp heads on a tp slot
    h = e // d
    q = q.view(b, s, h, d)
    k = linear(x, lp["k_w"], lp["k_b"]).view(b, s, h, d)
    v = linear(x, lp["v_w"], lp["v_b"]).view(b, s, h, d)
    # share_att_key: the table goes through this layer's q/k projections
    span2 = rel_table.shape[0]
    pos_q = linear(rel_table, lp["q_w"], lp["q_b"]).view(span2, h, d)
    pos_k = linear(rel_table, lp["k_w"], lp["k_b"]).view(span2, h, d)
    fn = disentangled_attention_packed if packed else disentangled_attention
    att = fn(q, k, v, mask, pos_k, pos_q, config.rel_attn_buckets, config.rel_attn_max_dist)
    return att.reshape(b, s, e)


def _encoder_layer(x: torch.Tensor, lp: dict, rel_table: torch.Tensor, mask: torch.Tensor,
                   config: BertConfig, packed: bool) -> torch.Tensor:
    """Post-norm block (DebertaV2Layer): attention + add&norm, GELU FFN +
    add&norm — BERT's residual layout."""
    eps = config.layer_norm_eps
    att = _attention(x, lp, rel_table, mask, config, packed)
    x = linear(att, lp["o_w"], lp["o_b"], residual=x, row_parallel=True,
               ln=(lp["ln_att_scale"], lp["ln_att_bias"], eps))
    hid = linear(x, lp["ffn_up_w"], lp["ffn_up_b"],
                 activation="gelu_tanh" if config.gelu == "tanh" else "gelu_erf")
    return linear(hid, lp["ffn_down_w"], lp["ffn_down_b"], residual=x, row_parallel=True,
                  ln=(lp["ln_out_scale"], lp["ln_out_bias"], eps))


def _encode(params: dict, ids: torch.Tensor, mask: torch.Tensor, config: BertConfig,
            opts, packed: bool, type_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Embeddings (BERT's, without a position term), the relative table and
    every layer -> [B, S, E]."""
    from .bert import embed_tokens

    x = embed_tokens(params, ids, config, opts, type_ids=type_ids)
    rel_table = _rel_table(params, config, opts.tdtype)
    layers = params["layers"]
    for i in range(config.n_layer):
        x = _encoder_layer(x, {k: v[i] for k, v in layers.items()}, rel_table, mask,
                           config, packed)
    return x


def _key_bias(mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.to(torch.bool), 0.0, MASK_BIAS).to(torch.float32)


def deberta_embed_batch(params: dict, ids: torch.Tensor, mask: torch.Tensor,
                        config: BertConfig, opts,
                        gather_idx: torch.Tensor | None = None,
                        token_states: bool = False) -> torch.Tensor:
    """Token ids [B, S] + validity mask [B, S] -> embeddings [B, n_embd]
    (the contract of models.bert.bert_embed_batch, which dispatches here),
    or with `token_states` the final states [B, S, E] f32."""
    from .bert import _cast_output, _output_head, pool_normalize

    x = _encode(params, ids, _key_bias(mask), config, opts, packed=False)
    if token_states:
        return x.to(torch.float32)
    out = _output_head(pool_normalize(x, mask, config.pooling, normalize=False),
                       params, config)
    return _cast_output(out, opts, gather_idx)


def deberta_embed_packed(params: dict, ids: torch.Tensor, seg: torch.Tensor,
                         pos: torch.Tensor, config: BertConfig, opts, *, n_seg: int,
                         gather_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Sequence-packed forward: ids/seg/pos [B, S] (seg -1 on padding) ->
    [B, n_seg, n_embd], or the flat slots `gather_idx`, in the output
    encoding.  Attention is block-diagonal by segment with the absolute
    row-offset tables (within a segment pos_q - pos_k == q - k)."""
    from .bert import _cast_output, _output_head, pool_normalize_packed

    x = _encode(params, ids, seg.to(torch.int32), config, opts, packed=True)
    pooled = pool_normalize_packed(x, seg, pos, n_seg, config.pooling, normalize=False)
    out = _output_head(pooled, params, config)
    return _cast_output(out, opts, gather_idx)


def deberta_score_batch(params: dict, ids: torch.Tensor, mask: torch.Tensor,
                        config: BertConfig, opts,
                        type_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-encoder forward: [B, S] pair ids -> [B, n_labels] f32 logits.
    HF DebertaV2ForSequenceClassification: the ContextPooler (dense +
    gelu on the first token) then the classifier, computed in f32."""
    from .bert import classifier_head

    if "head" not in params:
        raise ValueError("model has no classification head (n_labels == 0)")
    x = _encode(params, ids, _key_bias(mask), config, opts, packed=False,
                type_ids=type_ids)
    return classifier_head(x[:, 0, :].to(torch.float32), params["head"],
                           config.head_activation)
