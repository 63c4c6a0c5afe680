"""ModernBERT encoder forward pass in PyTorch (gte-modernbert-base and the
nomic-modernbert embedders).

The JAX package's `models/modernbert.py` on dicts of tensors, as a plain
loop over layers:
- pre-norm blocks x + f(LN(x)), bias-free LayerNorms, layer 0 without the
  attention norm, a final LayerNorm that outputs f32;
- rotate-half RoPE with a per-layer base: global layers (i %
  global_attn_every == 0) rotate by rope_theta, the others by
  local_rope_theta, and attend only within |q - k| <= local_window // 2;
- a GeGLU FFN Wo(gelu(up) * gate): GELU in K1's f32 epilogue, the gate
  multiply in K1's prologue of the down projection.

Attention goes through the hand-written kernels (ops/attention.py):
- S <= 1024: local layers take the projection-layout kernel with the
  [1, S, S] window bias (K4, key-bias or packed form); global layers take
  the same kernel without a bias (K3, or K2 for packed rows), since the
  reference's zero bias adds exactly nothing.  Packed rows build the window
  bias from absolute row offsets: within a segment positions are
  consecutive, and cross-segment pairs are masked by segment.
- S > 1024: local layers take the sliding-window kernel (K7), global
  layers the long-row kernel (K5); where S has no window slice (S % 128 !=
  0) local layers take K5 with the [1, S, S] window bias, as the reference
  does.  Packed rows past 1024 take the segment kernel (K6, windowed by
  the longest segment as nomic's) on global layers and the segment +
  sliding-window mode of the long-row kernel (mode 3) on local layers,
  where the reference runs XLA with a [B, S, S] bias; rows of S % 8 != 0
  run padded to a multiple of 8 inside those calls.

The cross-encoder head (gte-reranker-modernbert-base,
`modernbert_score_batch`) pools the final-norm states per `pooling` (cls
or mean), then dense (no bias), exact GELU, a bias-free LayerNorm and the
classifier, all in f32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import (
    MASK_BIAS,
    fits_bias_bse,
    flash_attention,
    flash_attention_bse,
    flash_attention_local,
    flash_attention_packed,
    flash_attention_packed_bse,
    flash_attention_packed_local,
    local_window_tiles,
)
from ..ops.linear import layer_norm, linear
from ..ops.qtensor import QTensor, gather_rows
from ..utils.metrics import in_op_range
from .config import BertConfig


def layer_kinds(config: BertConfig) -> tuple[list[bool], np.ndarray]:
    """(is_local per layer, inv_freq [L, d/2] f32): theta ** -(2j/d) in
    float64, then cast (HF's default RoPE init)."""
    every, d = config.global_attn_every, config.head_dim
    is_local = [not (every <= 0 or i % every == 0) for i in range(config.n_layer)]
    local_theta = config.local_rope_theta or config.rope_theta
    thetas = np.where(is_local, local_theta, config.rope_theta)
    exponents = np.arange(0, d, 2, dtype=np.float64) / d
    return is_local, (thetas[:, None] ** -exponents[None, :]).astype(np.float32)


@in_op_range("op.rope")
def rope_cos_sin(pos: torch.Tensor, inv_freq: torch.Tensor, dtype):
    """cos/sin [..., S, d] for rotate-half RoPE: f32 angles from
    concat(freqs, freqs), cast to the activation dtype."""
    freqs = pos.to(torch.float32)[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


@in_op_range("op.rope")
def apply_rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """t [B, S, H, d] rotated by cos/sin [S, d] or [B, S, d]: t*cos +
    rotate_half(t)*sin, the first d/2 dims paired with the last d/2."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    d2 = t.shape[-1] // 2
    rot = torch.cat([-t[..., d2:], t[..., :d2]], dim=-1)
    return t * cos + rot * sin


def window_bias(s: int, window: int, device) -> torch.Tensor:
    """[1, S, S] f32: 0 within |q - k| <= window // 2, -1e9 outside."""
    pos = torch.arange(s, device=device)
    inside = (pos[None, :] - pos[:, None]).abs() <= window // 2
    return torch.where(inside, 0.0, MASK_BIAS).to(torch.float32)[None]


def _ln(x: torch.Tensor, scale: torch.Tensor, eps: float, out_dtype) -> torch.Tensor:
    """Bias-free LayerNorm."""
    return layer_norm(x, scale, None, eps, out_dtype)


class _Ctx:
    """What every layer of one forward shares: the key mask (plain [B, S]
    f32 bias, or packed [B, S] segment ids and the longest segment), the
    RoPE tables of both layer kinds, and the window bias where a kernel
    needs it."""

    def __init__(self, config: BertConfig, pos: torch.Tensor, dtype, s: int, device,
                 pad: torch.Tensor | None = None, seg: torch.Tensor | None = None,
                 max_seg_len: int | None = None):
        self.pad, self.seg, self.max_seg_len = pad, seg, max_seg_len
        is_local, inv_freq = layer_kinds(config)
        self.is_local = is_local
        inv = torch.from_numpy(inv_freq).to(device)
        self.rope = [None] * config.n_layer
        tables = {}
        for i in range(config.n_layer):
            key = bool(is_local[i])  # layers of one kind share one table
            if key not in tables:
                tables[key] = rope_cos_sin(pos, inv[i], dtype)
            self.rope[i] = tables[key]
        window = config.local_window
        self.long = not fits_bias_bse(s, config.head_dim)
        sliced = local_window_tiles(s, window)[1] is not None
        self.win = None
        if any(is_local) and (not self.long or (not sliced and seg is None)):
            self.win = window_bias(s, window, device)
        self.sliced = self.long and sliced


def _attention(xn: torch.Tensor, lp: dict, i: int, ctx: _Ctx,
               config: BertConfig) -> torch.Tensor:
    """Pre-normed input -> attention output [B, S, E] (pre-residual)."""
    b, s, _ = xn.shape
    d = config.head_dim
    q = linear(xn, lp["q_w"])
    e = q.shape[-1]  # n_head / tp heads on a tp slot
    h = e // d
    q = q.view(b, s, h, d)
    k = linear(xn, lp["k_w"]).view(b, s, h, d)
    v = linear(xn, lp["v_w"]).view(b, s, h, d)
    cos, sin = ctx.rope[i]
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    local = ctx.is_local[i]
    if ctx.long:
        if ctx.seg is not None:
            if local:
                att = flash_attention_packed_local(q, k, v, ctx.seg, config.local_window)
            else:
                att = flash_attention_packed(q, k, v, ctx.seg, ctx.max_seg_len)
            return att.reshape(b, s, e)
        if local and ctx.sliced:
            att = flash_attention_local(q, k, v, ctx.pad, config.local_window)
        else:
            att = flash_attention(q, k, v, ctx.pad, ctx.win if local else None)
        return att.reshape(b, s, e)
    q, k, v = (t.reshape(b, s, e) for t in (q, k, v))
    win = ctx.win if local else None  # global layers: no bias (adding 0 is exact)
    if ctx.seg is not None:
        return flash_attention_packed_bse(q, k, v, ctx.seg, h, win)
    return flash_attention_bse(q, k, v, ctx.pad, h, win)


def encoder_layer(x: torch.Tensor, lp: dict, i: int, ctx: _Ctx,
                  config: BertConfig) -> torch.Tensor:
    """One pre-norm block: x += Wo(attn(attn_norm(x))), then
    x += Wo_mlp(gelu(up(hn)) * gate(hn)) over hn = mlp_norm(x)."""
    eps = config.layer_norm_eps
    xn = x if i == 0 else _ln(x, lp["ln_att_scale"], eps, x.dtype)
    x = linear(_attention(xn, lp, i, ctx, config), lp["o_w"], residual=x, row_parallel=True)
    hn = _ln(x, lp["ln_out_scale"], eps, x.dtype)
    u = linear(hn, lp["ffn_up_w"],
               activation="gelu_tanh" if config.gelu == "tanh" else "gelu_erf")
    g = linear(hn, lp["ffn_gate_w"])
    return linear(u, lp["ffn_down_w"], residual=x, prologue_mul=g, row_parallel=True)


@in_op_range("op.embed")
def _embed(params: dict, ids: torch.Tensor, config: BertConfig, dtype) -> torch.Tensor:
    """LN(tok_embeddings[ids]): no token-type or position table."""
    emb = params["embeddings"]
    word = emb["word"]
    if isinstance(word, QTensor):
        x = gather_rows(word, ids, dtype=torch.float32)
    else:
        x = word[ids].to(torch.float32)
    return _ln(x, emb["ln_scale"], config.layer_norm_eps, dtype)


def _run_layers(x: torch.Tensor, params: dict, ctx: _Ctx,
                config: BertConfig) -> torch.Tensor:
    layers = params["layers"]
    for i in range(config.n_layer):
        x = encoder_layer(x, {k: v[i] for k, v in layers.items()}, i, ctx, config)
    return _ln(x, params["final_ln_scale"], config.layer_norm_eps, torch.float32)


def _encode(params: dict, ids: torch.Tensor, mask: torch.Tensor, config: BertConfig,
            opts) -> torch.Tensor:
    """The final-norm states [B, S, E] f32 of a padded batch: positions
    are absolute 0..S-1 in every row; padded keys are masked."""
    s = ids.shape[-1]
    x = _embed(params, ids, config, opts.tdtype)
    pad = torch.where(mask.to(torch.bool), 0.0, MASK_BIAS).to(torch.float32)
    pos = torch.arange(s, device=ids.device)
    ctx = _Ctx(config, pos, opts.tdtype, s, ids.device, pad=pad)
    return _run_layers(x, params, ctx, config)


def modernbert_embed_batch(params: dict, ids: torch.Tensor, mask: torch.Tensor,
                           config: BertConfig, opts,
                           gather_idx: torch.Tensor | None = None,
                           token_states: bool = False) -> torch.Tensor:
    """Token ids [B, S] + validity mask [B, S] -> embeddings [B, n_embd]
    (the contract of models.bert.bert_embed_batch, which dispatches here),
    or with `token_states` the final-norm states [B, S, E] f32."""
    from .bert import _cast_output, _output_head, pool_normalize

    x = _encode(params, ids, mask, config, opts)
    if token_states:
        return x
    out = _output_head(pool_normalize(x, mask, config.pooling, normalize=False),
                       params, config)
    return _cast_output(out, opts, gather_idx)


def modernbert_score_batch(params: dict, ids: torch.Tensor, mask: torch.Tensor,
                           config: BertConfig, opts) -> torch.Tensor:
    """Cross-encoder forward (gte-reranker-modernbert-base): pair ids
    [B, S] ([CLS] a [SEP] b [SEP], no type ids) -> [B, n_labels] f32
    logits.  The final-norm states pooled per `pooling`, then the
    PredictionHead in f32: dense without bias, exact erf GELU whatever
    `config.gelu` says, a bias-free LayerNorm, then the classifier."""
    from .bert import pool_normalize

    if "head" not in params:
        raise ValueError("model has no classification head (n_labels == 0)")
    x = _encode(params, ids, mask, config, opts)
    pooled = pool_normalize(x, mask, config.pooling, normalize=False)
    head = params["head"]
    y = F.gelu(pooled.to(torch.float32) @ head["dense_w"])
    y = _ln(y, head["norm_scale"], config.layer_norm_eps, torch.float32)
    return y @ head["out_w"] + head["out_b"]


def modernbert_embed_packed(params: dict, ids: torch.Tensor, seg: torch.Tensor,
                            pos: torch.Tensor, config: BertConfig, opts, *,
                            n_seg: int, gather_idx: torch.Tensor | None = None,
                            max_seg_len: int | None = None) -> torch.Tensor:
    """Sequence-packed forward: ids/seg/pos [B, S] (seg -1 on padding, pos
    the within-segment position, which RoPE rotates by) -> [B, n_seg,
    n_embd], or the flat slots `gather_idx`, in the output encoding.
    `max_seg_len` bounds the longest segment (the windowed K6's slice on
    global layers past 1024 tokens)."""
    from .bert import _cast_output, _output_head, pool_normalize_packed

    s = ids.shape[-1]
    x = _embed(params, ids, config, opts.tdtype)
    ctx = _Ctx(config, pos, opts.tdtype, s, ids.device, seg=seg.to(torch.int32),
               max_seg_len=max_seg_len)
    x = _run_layers(x, params, ctx, config)
    pooled = pool_normalize_packed(x, seg, pos, n_seg, config.pooling, normalize=False)
    out = _output_head(pooled, params, config)
    return _cast_output(out, opts, gather_idx)
