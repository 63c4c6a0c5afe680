"""T5 encoder forward pass in PyTorch (sentence-t5 and GTR retrievers).

The JAX package's `models/t5.py` on dicts of tensors, as a plain loop over
layers.  Where it differs from the BERT graph (models/bert.py):
- pre-norm blocks x + f(RMSNorm(x)): no mean subtraction, no bias, the
  variance in f32 (HF T5LayerNorm), and a final RMSNorm whose output is
  f32;
- the word table `shared` alone: no scale, norm, position or token-type
  table;
- unscaled attention (T5 folds 1/sqrt(d) into its initialization) plus one
  relative position bias [H, S, S] shared by every layer, on the
  projection-layout kernel with a per-head bias (K4).  The kernel scales
  scores by 1/sqrt(d), so q is multiplied by sqrt(d) first, in q's dtype,
  as the JAX package does: exact in bf16 where d is a power of 4 (64), one
  rounding of the factor and one of each product where it is not (128);
- per-head width d_kv apart from n_embd / n_head, bias-free linears, and a
  relu FFN (v1.0) or a gated GELU one (v1.1), whose wi_1 product rides the
  down projection's prologue in K1.
Packed rows keep the batch-invariant bias: within a segment the restart
positions are consecutive, and pairs across segments are masked.
"""
from __future__ import annotations

import math

import torch

from ..ops.attention import MASK_BIAS, flash_attention_bse, flash_attention_packed_bse
from ..ops.linear import linear
from ..ops.qtensor import QTensor, gather_rows
from ..utils.metrics import in_op_range
from .config import BertConfig


@in_op_range("op.norm")
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, out_dtype) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale, computed in f32."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(out_dtype)


def unscale_q(q: torch.Tensor, d: int) -> torch.Tensor:
    """q * sqrt(d), the factor and the product in q's dtype (as JAX
    multiplies by a weakly typed scalar): cancels the kernel's 1/sqrt(d)."""
    return q * torch.tensor(math.sqrt(d), dtype=q.dtype, device=q.device)


@in_op_range("op.embed")
def _embed(params: dict, ids: torch.Tensor, opts) -> torch.Tensor:
    word = params["embeddings"]["word"]
    if isinstance(word, QTensor):
        x = gather_rows(word, ids, dtype=torch.float32)
    else:
        x = word[ids].to(torch.float32)
    return x.to(opts.tdtype)


def _attention(xn: torch.Tensor, lp: dict, pos_bias: torch.Tensor, mask: torch.Tensor,
               config: BertConfig, packed: bool) -> torch.Tensor:
    """Attention output (before the o projection) of the normed input:
    mask is the [B, S] key bias, or the segment ids when `packed`."""
    from .bert import local_heads

    q = unscale_q(linear(xn, lp["q_w"]), config.head_dim)
    k = linear(xn, lp["k_w"])
    v = linear(xn, lp["v_w"])
    h = q.shape[-1] // config.head_dim  # n_head / tp on a tp slot
    pos_bias = local_heads(pos_bias, h)
    if packed:
        return flash_attention_packed_bse(q, k, v, mask, h, pos_bias)
    return flash_attention_bse(q, k, v, mask, h, pos_bias)


def _ffn(xn: torch.Tensor, lp: dict, config: BertConfig):
    """(h, gate): h = act(wi x), relu after the linear as the JAX package
    applies it, GELU in K1's epilogue; gate = wi_1 x when gated (the down
    projection multiplies it in), else None."""
    act = config.ffn_act or "relu"
    u = linear(xn, lp["ffn_up_w"],
               activation=act if act in ("gelu_tanh", "gelu_erf") else None)
    if act == "relu":
        u = torch.relu(u)
    return u, linear(xn, lp["ffn_gate_w"]) if config.ffn_gated else None


def _run_layers(x: torch.Tensor, params: dict, pos_bias: torch.Tensor, mask: torch.Tensor,
                config: BertConfig, packed: bool) -> torch.Tensor:
    """The pre-norm blocks, then the final RMSNorm (f32 out)."""
    eps = config.layer_norm_eps
    layers = params["layers"]
    for i in range(config.n_layer):
        lp = {k: v[i] for k, v in layers.items()}
        att = _attention(rms_norm(x, lp["ln_att_scale"], eps, x.dtype), lp, pos_bias, mask,
                         config, packed)
        x = linear(att, lp["o_w"], residual=x, row_parallel=True)
        h, gate = _ffn(rms_norm(x, lp["ln_out_scale"], eps, x.dtype), lp, config)
        x = linear(h, lp["ffn_down_w"], residual=x, prologue_mul=gate, row_parallel=True)
    return rms_norm(x, params["final_ln_scale"], eps, torch.float32)


def t5_embed_batch(params: dict, ids: torch.Tensor, mask: torch.Tensor, config: BertConfig,
                   opts, gather_idx: torch.Tensor | None = None,
                   token_states: bool = False) -> torch.Tensor:
    """Token ids [B, S] + validity mask [B, S] -> embeddings [B, n_embd]
    (models.bert.bert_embed_batch's contract), or with `token_states` the
    final-RMSNorm states [B, S, E] f32."""
    from .bert import _cast_output, _output_head, pool_normalize, rel_attn_bias

    x = _embed(params, ids, opts)
    pos_bias = rel_attn_bias(params["rel_attn_bias"], ids.shape[-1],
                             config.rel_attn_max_dist)
    pad = torch.where(mask.to(torch.bool), 0.0, MASK_BIAS).to(torch.float32)
    x = _run_layers(x, params, pos_bias, pad, config, packed=False)
    if token_states:
        return x
    pooled = pool_normalize(x, mask, config.pooling, normalize=False)
    out = _output_head(pooled, params, config)
    return _cast_output(out, opts, gather_idx)


def t5_embed_packed(params: dict, ids: torch.Tensor, seg: torch.Tensor, pos: torch.Tensor,
                    config: BertConfig, opts, *, n_seg: int,
                    gather_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Packed rows [B, S] -> [B, n_seg, n_embd], or the flat slots
    `gather_idx` (models.bert.bert_embed_packed's contract)."""
    from .bert import _cast_output, _output_head, pool_normalize_packed, rel_attn_bias

    x = _embed(params, ids, opts)
    pos_bias = rel_attn_bias(params["rel_attn_bias"], ids.shape[-1],
                             config.rel_attn_max_dist)
    x = _run_layers(x, params, pos_bias, seg.to(torch.int32), config, packed=True)
    pooled = pool_normalize_packed(x, seg, pos, n_seg, config.pooling, normalize=False)
    out = _output_head(pooled, params, config)
    return _cast_output(out, opts, gather_idx)
