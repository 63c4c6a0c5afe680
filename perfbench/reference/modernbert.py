"""ModernBERT (HF `ModernBertModel`, as gte-modernbert-base runs it): token
embeddings and a bias-free LayerNorm; pre-norm layers (layer 0 without the
attention norm) of bias-free fused-qkv attention with rotate-half RoPE,
global on every `global_attn_every_n_layers`-th layer (base
`global_rope_theta`) and within |q - k| <= local_attention / 2 elsewhere
(base `local_rope_theta`), and a GeGLU FFN Wo(gelu(input) * gate) with
(input, gate) = Wi(x).chunk(2); a final LayerNorm; the [CLS] state pooled.
f32 throughout; the products in `prec`."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import attention, layer_norm


def tensors(c: dict) -> list[tuple[str, tuple[int, ...], str]]:
    e, f = c["hidden_size"], c["intermediate_size"]
    out = [("embeddings.tok_embeddings.weight", (c["vocab_size"], e), "matrix"),
           ("embeddings.norm.weight", (e,), "scale")]
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}."
        if i:
            out.append((f"{p}attn_norm.weight", (e,), "scale"))
        out += [(f"{p}attn.Wqkv.weight", (3 * e, e), "matrix"),
                (f"{p}attn.Wo.weight", (e, e), "matrix"),
                (f"{p}mlp_norm.weight", (e,), "scale"),
                (f"{p}mlp.Wi.weight", (2 * f, e), "matrix"),
                (f"{p}mlp.Wo.weight", (e, f), "matrix")]
    out.append(("final_norm.weight", (e,), "scale"))
    return out


def _rope(t: torch.Tensor, theta: float) -> torch.Tensor:
    """t [B, H, L, d] rotated: t cos + rotate_half(t) sin, angles p *
    theta^(-2j/d) (computed in float64, as HF's default RoPE init)."""
    n, d = t.shape[-2:]
    inv = theta ** -(torch.arange(0, d, 2, dtype=torch.float64, device=t.device) / d)
    ang = torch.arange(n, dtype=torch.float64, device=t.device)[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1).to(torch.float32)
    rot = torch.cat([-t[..., d // 2:], t[..., : d // 2]], dim=-1)
    return t * torch.cos(ang) + rot * torch.sin(ang)


def forward(w: dict, ids: torch.Tensor, c: dict, prec) -> torch.Tensor:
    b, n = ids.shape
    e, h = c["hidden_size"], c["num_attention_heads"]
    eps = c["norm_eps"]
    every = c["global_attn_every_n_layers"]
    x = prec.round(layer_norm(w["embeddings.tok_embeddings.weight"][ids],
                              w["embeddings.norm.weight"], None, eps))
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}."
        is_global = i % every == 0
        y = x if i == 0 else layer_norm(x, w[f"{p}attn_norm.weight"], None, eps)
        qkv = prec.linear(y, w[f"{p}attn.Wqkv.weight"]).reshape(b, n, 3, h, -1)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        theta = c["global_rope_theta"] if is_global else c["local_rope_theta"]
        q, k = _rope(qkv[0], theta), _rope(qkv[1], theta)
        half = None if is_global else c["local_attention"] // 2
        ctx = attention(q, k, qkv[2], half, prec.round).transpose(1, 2).reshape(b, n, e)
        x = prec.round(x + prec.linear(ctx, w[f"{p}attn.Wo.weight"]))
        y = layer_norm(x, w[f"{p}mlp_norm.weight"], None, eps)
        inp, gate = prec.linear(y, w[f"{p}mlp.Wi.weight"]).chunk(2, dim=-1)
        x = prec.round(x + prec.linear(F.gelu(inp) * gate, w[f"{p}mlp.Wo.weight"]))
    x = layer_norm(x, w["final_norm.weight"], None, eps)
    return x[:, 0]
