"""What every reference family shares: block dequantization, the ids of a
text, the matrix product in the compared precision, LayerNorm, attention
computed in query blocks, and the batched loop with L2 pooling."""
from __future__ import annotations

import math
import re
from typing import Sequence

import numpy as np
import torch


def dequantize(blocks: torch.Tensor, qtype: str, shape: tuple[int, ...]) -> torch.Tensor:
    """Raw GGUF blocks [n, bytes] uint8 -> f32 weights of `shape`: each block
    an f16 scale d, then Q8_0's 32 int8 codes (w = d q) or Q4_0's 16 bytes
    of nibbles, low nibbles the block's first 16 weights (w = d (q - 8))."""
    d = blocks[:, :2].contiguous().view(torch.float16).to(torch.float32)
    if qtype == "q8_0":
        q = blocks[:, 2:].contiguous().view(torch.int8).to(torch.float32)
    elif qtype == "q4_0":
        b = blocks[:, 2:].to(torch.int16)
        q = torch.cat([b & 0xF, b >> 4], dim=1).to(torch.float32) - 8.0
    else:
        raise ValueError(f"unknown qtype {qtype!r}")
    return (q * d).reshape(shape)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (amax -> 448),
    back in f32."""
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    """How the reference computes: "f32", or "fp8", the control: every
    tensor a bf16 program keeps in bf16 (the operands of each linear and of
    attention's two products, and the hidden state after each residual add
    or norm) rounded to float8 e4m3, one scale a tensor as fp8 GEMMs take
    them; the products accumulated and the norms computed in f32."""

    def __init__(self, name: str):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.round = fp8_round if name == "fp8" else (lambda t: t)

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [.., K] @ w [N, K]^T."""
        return self.round(x) @ self.round(w).t()


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, eps: float):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps) * w
    return y + b if b is not None else y


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, half_window: int | None,
              rnd=lambda t: t, block: int = 1024) -> torch.Tensor:
    """Softmax attention over texts of one length: q/k/v [B, H, L, d] ->
    [B, H, L, d], queries in blocks of `block`; with `half_window`, each
    query sees only keys within |q - k| <= half_window.  The operands go
    through `rnd` (the precision's rounding)."""
    q, k, v = rnd(q), rnd(k), rnd(v)
    n, d = q.shape[-2:]
    out = torch.empty_like(q)
    kpos = torch.arange(n, device=q.device)
    for lo in range(0, n, block):
        qb = q[..., lo:lo + block, :]
        s = (qb @ k.transpose(-1, -2)) / math.sqrt(d)
        if half_window is not None:
            qpos = torch.arange(lo, lo + qb.shape[-2], device=q.device)
            far = (qpos[:, None] - kpos[None, :]).abs() > half_window
            s = s.masked_fill(far, float("-inf"))
        out[..., lo:lo + block, :] = rnd(torch.softmax(s, dim=-1)) @ v
    return out


class TextIds:
    """The framed ids of a text, derived from the vocabulary's token list
    alone: WordPiece lowercases and splits off punctuation, byte-level BPE
    makes each space-separated word "Ġ" + word; then [CLS] ids [SEP], cut to
    the context with [SEP] kept last."""

    def __init__(self, vocab, n_ctx: int):
        self.kind = vocab.kind
        self.n_ctx = n_ctx
        self.cls, self.sep = vocab.special["cls"], vocab.special["sep"]
        self.ids = {t: i for i, t in enumerate(vocab.tokens)}

    def __call__(self, text: str) -> list[int]:
        if self.kind == "wordpiece":
            pieces = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower())
        else:
            pieces = ["Ġ" + w for w in text.split()]
        body = [self.ids[p] for p in pieces][: self.n_ctx - 2]
        return [self.cls, *body, self.sep]


def embed_texts(forward, weights: dict, token_lists: Sequence[Sequence[int]], config: dict,
                prec: Precision, device, max_tokens: int = 32768) -> np.ndarray:
    """[n, E] f32 L2-normalized vectors of the token lists, texts of one
    length run together (at most `max_tokens` a block) through
    `forward(weights, ids [B, L], config, prec) -> [B, E]`."""
    out = np.empty((len(token_lists), config["hidden_size"]), np.float32)
    by_len: dict[int, list[int]] = {}
    for i, t in enumerate(token_lists):
        by_len.setdefault(len(t), []).append(i)
    for n, idx in sorted(by_len.items()):
        step = max(1, max_tokens // n)
        for lo in range(0, len(idx), step):
            rows = idx[lo:lo + step]
            ids = torch.tensor([token_lists[i] for i in rows], device=device)
            v = forward(weights, ids, config, prec)
            v = v / v.norm(dim=-1, keepdim=True).clamp_min(1e-12)
            out[rows] = v.cpu().numpy()
    return out
