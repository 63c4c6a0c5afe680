"""nomic-bert encoder forward pass in PyTorch (nomic-embed-text-v1.5).

The JAX package's `models/nomic.py` on dicts of tensors, as a plain loop
over layers:
- embeddings: word + token_type[0], then the embedding LayerNorm; no
  position table (`bert.embed_tokens`);
- post-norm blocks as BERT's: norm1(x + attn(x)), norm2(x + mlp(x));
- rotate-half RoPE on q/k with base rope_theta, scaled by dynamic NTK once
  the sequence length S passes rope_max_trained (`_inv_freq`);
- the SwiGLU MLP fc2(fc11(x) * silu(fc12(x))): silu in K1's f32 epilogue of
  the up projection (fc12), the gate (fc11) multiplied in K1's prologue of
  the down projection.

Attention goes through the hand-written kernels (ops/attention.py), routed
as the reference routes its Pallas path:
- plain batches: K3 (projection layout, key bias) at S <= 1024, K5 (long
  rows) past it;
- packed rows: K2 (projection layout, segments) where `packed_bse_applies`,
  else K6 (`flash_attention_packed`): its windowed form where the longest
  segment `max_seg_len` gives a key slice narrower than S, else every key;
  rows past 1024 with S % 8 != 0 (XLA in the reference) run K6 padded to a
  multiple of 8 after RoPE, which is exact on the real rows.

Packed rows take the NTK base of the packed row length S, as the reference
does: in rows of 4096 or 8192 tokens a chunk is rotated by another base
than the same chunk alone, and its vector differs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.attention import (
    MASK_BIAS,
    MAX_SEQ,
    fits_bias_bse,
    flash_attention,
    flash_attention_bse,
    flash_attention_packed,
    flash_attention_packed_bse,
    packed_bse_applies,
)
from ..ops.linear import linear
from .config import BertConfig
from .modernbert import apply_rope, rope_cos_sin


def _inv_freq(config: BertConfig, s: int) -> np.ndarray:
    """RoPE inverse frequencies [d/2] f32 for sequence length `s`: the base
    in float64, scaled by dynamic NTK past the trained length, base **
    -(2j/d) in float64, then cast."""
    d = config.head_dim
    base = float(config.rope_theta or 1000.0)
    if (config.rope_scaling_factor > 0 and config.rope_max_trained > 0
            and s > config.rope_max_trained):
        f = config.rope_scaling_factor
        base = base * ((f * s / config.rope_max_trained) - (f - 1.0)) ** (d / (d - 2.0))
    exponents = np.arange(0, d, 2, dtype=np.float64) / d
    return (base ** -exponents).astype(np.float32)


class _Ctx:
    """What every layer of one forward shares: the plain key bias [B, S]
    or the packed segment ids [B, S], the RoPE tables in the activation
    dtype, and the longest packed segment."""

    def __init__(self, config: BertConfig, pos: torch.Tensor, dtype, s: int, device,
                 pad: torch.Tensor | None = None, seg: torch.Tensor | None = None,
                 max_seg_len: int | None = None):
        self.pad, self.seg, self.max_seg_len = pad, seg, max_seg_len
        inv = torch.from_numpy(_inv_freq(config, s)).to(device)
        self.rope = rope_cos_sin(pos, inv, dtype)


def _attention(x: torch.Tensor, lp: dict, ctx: _Ctx, config: BertConfig) -> torch.Tensor:
    """RoPE attention over a padded or packed batch -> [B, S, E]."""
    b, s, _ = x.shape
    d = config.head_dim
    q = linear(x, lp["q_w"], lp.get("q_b"))
    e = q.shape[-1]  # n_head / tp heads on a tp slot
    h = e // d
    q = q.view(b, s, h, d)
    k = linear(x, lp["k_w"], lp.get("k_b")).view(b, s, h, d)
    v = linear(x, lp["v_w"], lp.get("v_b")).view(b, s, h, d)
    cos, sin = ctx.rope
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    if ctx.seg is not None:
        # K2 where the reference takes its projection-layout kernel, and at
        # S % 8 != 0, where it takes XLA (K6 needs S % 8 == 0)
        if packed_bse_applies(s, d, ctx.max_seg_len) or (s % 8 and s <= MAX_SEQ):
            return flash_attention_packed_bse(q.reshape(b, s, e), k.reshape(b, s, e),
                                              v.reshape(b, s, e), ctx.seg, h)
        return flash_attention_packed(q, k, v, ctx.seg, ctx.max_seg_len).reshape(b, s, e)
    if fits_bias_bse(s, d):
        return flash_attention_bse(q.reshape(b, s, e), k.reshape(b, s, e),
                                   v.reshape(b, s, e), ctx.pad, h)
    return flash_attention(q, k, v, ctx.pad).reshape(b, s, e)


def encoder_layer(x: torch.Tensor, lp: dict, ctx: _Ctx, config: BertConfig) -> torch.Tensor:
    """One post-norm block: x = norm1(x + o(attn(x))); x = norm2(x +
    fc2(silu(fc12(x)) * fc11(x)))."""
    eps = config.layer_norm_eps
    x = linear(_attention(x, lp, ctx, config), lp["o_w"], lp.get("o_b"), residual=x,
               row_parallel=True, ln=(lp["ln_att_scale"], lp["ln_att_bias"], eps))
    u = linear(x, lp["ffn_up_w"], lp.get("ffn_up_b"), activation="silu")
    g = linear(x, lp["ffn_gate_w"], lp.get("ffn_gate_b"))
    return linear(u, lp["ffn_down_w"], lp.get("ffn_down_b"), residual=x, prologue_mul=g,
                  row_parallel=True, ln=(lp["ln_out_scale"], lp["ln_out_bias"], eps))


def _run_layers(x: torch.Tensor, layers: dict, ctx: _Ctx, config: BertConfig) -> torch.Tensor:
    for i in range(config.n_layer):
        x = encoder_layer(x, {k: v[i] for k, v in layers.items()}, ctx, config)
    return x


def nomic_embed_batch(params: dict, ids: torch.Tensor, mask: torch.Tensor,
                      config: BertConfig, opts,
                      gather_idx: torch.Tensor | None = None,
                      token_states: bool = False) -> torch.Tensor:
    """Token ids [B, S] + validity mask [B, S] -> embeddings [B, n_embd]
    (the contract of models.bert.bert_embed_batch, which dispatches here),
    or with `token_states` the final states [B, S, E] f32.  Positions are
    0..S-1 in every row; padded keys are masked."""
    from .bert import _cast_output, _output_head, embed_tokens, pool_normalize

    s = ids.shape[-1]
    x = embed_tokens(params, ids, config, opts)
    pad = torch.where(mask.to(torch.bool), 0.0, MASK_BIAS).to(torch.float32)
    ctx = _Ctx(config, torch.arange(s, device=ids.device), opts.tdtype, s, ids.device,
               pad=pad)
    x = _run_layers(x, params["layers"], ctx, config)
    if token_states:
        return x.to(torch.float32)
    out = _output_head(pool_normalize(x, mask, config.pooling, normalize=False),
                       params, config)
    return _cast_output(out, opts, gather_idx)


def nomic_embed_packed(params: dict, ids: torch.Tensor, seg: torch.Tensor,
                       pos: torch.Tensor, config: BertConfig, opts, *, n_seg: int,
                       gather_idx: torch.Tensor | None = None,
                       max_seg_len: int | None = None) -> torch.Tensor:
    """Sequence-packed forward: ids/seg/pos [B, S] (seg -1 on padding, pos
    the within-segment position, which RoPE rotates by) -> [B, n_seg,
    n_embd], or the flat slots `gather_idx`, in the output encoding.
    `max_seg_len` bounds the longest segment (the windowed K6's slice).
    The NTK base keys off the packed row length S."""
    from .bert import _cast_output, _output_head, embed_tokens, pool_normalize_packed

    s = ids.shape[-1]
    x = embed_tokens(params, ids, config, opts)
    ctx = _Ctx(config, pos, opts.tdtype, s, ids.device, seg=seg.to(torch.int32),
               max_seg_len=max_seg_len)
    x = _run_layers(x, params["layers"], ctx, config)
    pooled = pool_normalize_packed(x, seg, pos, n_seg, config.pooling, normalize=False)
    out = _output_head(pooled, params, config)
    return _cast_output(out, opts, gather_idx)
