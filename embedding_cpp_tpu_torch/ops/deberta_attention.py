"""Disentangled self-attention (DeBERTa-v2/v3): the CUDA kernel's wrappers,
their plain PyTorch versions, and the relative-position index tables.

Kernel `csrc/deberta_attention.cu`, the Hopper port of the TPU kernels
`_deberta_kernel` (K9, plain batches with a key-padding bias, through
`_disentangled_attention`) and `_deberta_seg_kernel` (K10, packed rows with
a segment mask, through `_disentangled_attention_seg`) of
embedding_cpp_tpu/ops/deberta_attention.py.  Per (batch, head) and pair
(query i, key k), with W = 2S delta-major rows of this layer's projected
relative table (`delta_tables`):

    s = (q_i.k_k + q_i.pk_rev[S-1-i+k]) + k_k.pq[i-k+S]     (f32 dots)
    K9:  s*scale + bias[k];   K10: seg[i] == seg[k] ? s*scale : -1e9
    scale = 1/sqrt(3d); softmax in the reference's order: row max, exp,
    f32 row sum, e cast to v's dtype for the PV product (f32
    accumulation), divide on the [S, d] output, cast.

pk_rev[w] = pos_k[c2p_idx[w]] and pq[w] = pos_q[p2c_idx[w]]: the TPU
kernel gathers those [H, 2S, d] tables before the call and aligns their
diagonals with a barrel shifter; the GPU kernel reads the rows it needs
straight from the [2*span, H, d] projections through the two int32 index
arrays, so neither the gathered tables nor the four q/k/v transposes of
the JAX entry points exist.  K10 tests only seg[i] == seg[k] (not
seg[k] >= 0), so padding query rows attend over the other padding keys,
as the TPU kernel's do; packed rows use the plain absolute-offset tables,
since within a segment bucket(pos_q - pos_k) == bucket(q - k).

Every wrapper launches its kernel for CUDA tensors, raises for what the
kernel does not serve, and runs the plain version for tensors on the CPU,
or where the forward chose it (`attn_impl="plain"`, ops/dispatch.py).  A
head dim without an instance (`attention.HEAD_DIM_INSTANCES`) takes the
plain version under "auto", counted in the wrapper's `plain_routes`.
Each wrapper's `launches` counts its kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ._build import check
from .attention import HEAD_DIM_INSTANCES, MASK_BIAS, _bind, _operands, _served, _softmax_pv
from .dispatch import count, use_kernel

MAX_SEQ = 512  # DeBERTa's context; a query tile's f32 score rows stay on chip
_DIMS = HEAD_DIM_INSTANCES["deberta_attention.cu"]


def deberta_log_bucket(rel, bucket_size: int, max_position: int) -> np.ndarray:
    """HF make_log_bucket_position on numpy int arrays: identity within
    +-bucket_size/2, sign-preserving log-spaced buckets out to
    max_position.  `rel` is q_pos - k_pos.  The float32 log and ceil run in
    numpy, as the reference computes them at trace time, so every bucket
    equals the reference's."""
    rel = np.asarray(rel)
    sign = np.sign(rel)
    mid = bucket_size // 2
    abs_pos = np.where((rel < mid) & (rel > -mid), mid - 1, np.abs(rel))
    log_pos = (np.ceil(np.log(abs_pos.astype(np.float32) / mid)
                       / math.log((max_position - 1) / mid) * (mid - 1)) + mid)
    return np.where(abs_pos <= mid, rel,
                    (log_pos * sign).astype(np.int32)).astype(np.int32)


def delta_tables(s: int, span: int, max_dist: int) -> tuple[np.ndarray, np.ndarray]:
    """(c2p_idx, p2c_idx), int [2S]: pk_rev[w] = pos_k[c2p_idx[w]] with
    c2p_idx[w] = clip(bucket(S-1-w) + span), and pq[w] = pos_q[p2c_idx[w]]
    with p2c_idx[w] = clip(-bucket(S-w) + span)."""
    w = np.arange(2 * s)
    c2p_idx = np.clip(deberta_log_bucket(s - 1 - w, span, max_dist) + span, 0, 2 * span - 1)
    p2c_idx = np.clip(-deberta_log_bucket(s - w, span, max_dist) + span, 0, 2 * span - 1)
    return c2p_idx, p2c_idx


@functools.lru_cache(maxsize=64)
def _device_tables(s: int, span: int, max_dist: int, device: torch.device):
    """The two delta tables as int32 tensors on `device` (one copy per
    shape, not one per layer)."""
    return tuple(torch.from_numpy(t.astype(np.int32)).to(device)
                 for t in delta_tables(s, span, max_dist))


def work(b: int, s: int, h: int, d: int, span: int, itemsize: int) -> tuple[float, float]:
    """(flops, bytes) of one call at [B, S, H x d] with 2*span relative rows,
    the minimal work whatever implements it: the four products q.k, c2p,
    p2c and PV at 2*S*S*d flops each per (batch, head); q, k, v, pos_k and
    pos_q read once and o written once (`itemsize` bytes an element), the
    f32 key bias or int32 segment row [B, S] and the two int32 index tables
    [2S] read once."""
    flops = 8.0 * b * h * s * s * d
    nbytes = (4 * b * s + 2 * 2 * span) * h * d * itemsize + b * s * 4 + 2 * 2 * s * 4
    return flops, float(nbytes)


def disentangled_scores_plain(q, k, pos_k, pos_q, c2p_idx, p2c_idx) -> torch.Tensor:
    """Raw f32 scores [B, H, S, S]: (q.k + c2p) + p2c, each term a product
    of f32 copies of the inputs."""
    b, s, h, d = q.shape
    qh = q.permute(0, 2, 1, 3).to(torch.float32)  # [B, H, S, d]
    kh = k.permute(0, 2, 1, 3).to(torch.float32)
    pk = pos_k[c2p_idx].permute(1, 0, 2).to(torch.float32)  # [H, 2S, d]
    pq = pos_q[p2c_idx].permute(1, 0, 2).to(torch.float32)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    scores = torch.matmul(qh, kh.transpose(-1, -2))
    c2p = torch.matmul(qh, pk.transpose(-1, -2))  # [B, H, S, 2S]
    scores = scores + c2p[:, :, i, s - 1 - i + j]
    del c2p
    p2c = torch.matmul(pq, kh.transpose(-1, -2))  # [B, H, 2S, S]
    return scores + p2c[:, :, i - j + s, j]


def disentangled_attention_plain(q, k, v, mask, pos_k, pos_q, c2p_idx, p2c_idx,
                                 seg_mask: bool) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch.  q/k/v [B, S, H, d];
    mask: f32 key bias [B, S], or int32 segment ids [B, S] when `seg_mask`;
    pos_k/pos_q [2*span, H, d]; c2p_idx/p2c_idx int [2S] (delta_tables)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d * 3)
    scores = disentangled_scores_plain(q, k, pos_k, pos_q, c2p_idx.long(), p2c_idx.long())
    if seg_mask:
        allowed = (mask[:, :, None] == mask[:, None, :])[:, None]
        scores = torch.where(allowed, scores * scale,
                             torch.tensor(MASK_BIAS, dtype=torch.float32, device=q.device))
    else:
        scores = scores * scale + mask.to(torch.float32)[:, None, None, :]
    out = _softmax_pv(scores, v.permute(0, 2, 1, 3), q.dtype)  # [B, H, S, d]
    return out.permute(0, 2, 1, 3)


# --- launches ----------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 9 + [_I, _I, _I, _I, _I, _F, _I, _I, _P]


def _launch(q, k, v, mask, pos_k, pos_q, c2p_idx, p2c_idx, seg_mask: bool) -> torch.Tensor:
    """Checks the operands and launches the disentangled-attention kernel
    (the index tables come from `delta_tables`: every entry lies in
    0 .. 2*span-1)."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"q/k/v shapes {q.shape} {k.shape} {v.shape}")
    b, s, h, d = q.shape
    if d not in _DIMS:
        raise ValueError(f"head dim {d} not in {_DIMS}")
    if not 1 <= s <= MAX_SEQ:
        raise ValueError(f"sequence length {s} outside 1..{MAX_SEQ}")
    dtypes = {t.dtype for t in (q, k, v, pos_k, pos_q)}
    if len(dtypes) != 1 or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q/k/v/pos dtypes {sorted(map(str, dtypes))}")
    span2 = pos_k.shape[0]
    if pos_k.shape != (span2, h, d) or pos_q.shape != pos_k.shape:
        raise ValueError(f"pos_k/pos_q {tuple(pos_k.shape)} {tuple(pos_q.shape)}, "
                         f"want (2*span, {h}, {d})")
    want = torch.int32 if seg_mask else torch.float32
    if mask.shape != (b, s) or mask.dtype != want:
        raise ValueError(f"mask {tuple(mask.shape)} {mask.dtype}, want ({b}, {s}) {want}")
    q, k, v, mask, pos_k, pos_q, c2p_idx, p2c_idx = _operands(
        (q, k, v, mask, pos_k, pos_q, c2p_idx, p2c_idx), q.device)
    out = torch.empty_like(q)
    if b == 0:
        return out
    err = _bind("deberta_attention.cu", "deberta_attn_launch", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        pos_k.data_ptr(), pos_q.data_ptr(), c2p_idx.data_ptr(), p2c_idx.data_ptr(),
        out.data_ptr(), b, s, h, d, span2, 1.0 / math.sqrt(d * 3),
        int(q.dtype == torch.bfloat16), int(seg_mask),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, "deberta_attn_launch")
    return out


def disentangled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask_bias: torch.Tensor, pos_k: torch.Tensor,
                           pos_q: torch.Tensor, span: int, max_dist: int) -> torch.Tensor:
    """DeBERTa attention over a plain (padded) batch: q/k/v [B, S, H, d]
    (a free view of the projections), mask_bias [B, S] f32 (0 valid, -1e9
    padding), pos_k/pos_q [2*span, H, d] — this layer's k/q projections of
    the shared relative table.  -> [B, S, H, d]."""
    mask_bias = mask_bias.to(torch.float32)
    c2p_idx, p2c_idx = _device_tables(q.shape[1], span, max_dist, q.device)
    if not use_kernel(q, "attn", "disentangled_attention", disentangled_attention,
                      _served(q, _DIMS)):
        return disentangled_attention_plain(q, k, v, mask_bias, pos_k, pos_q,
                                            c2p_idx, p2c_idx, False)
    out = _launch(q, k, v, mask_bias, pos_k, pos_q, c2p_idx, p2c_idx, False)
    count(disentangled_attention)
    return out


def disentangled_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  seg: torch.Tensor, pos_k: torch.Tensor,
                                  pos_q: torch.Tensor, span: int,
                                  max_dist: int) -> torch.Tensor:
    """DeBERTa attention over packed rows: key k is visible to query i iff
    seg[i] == seg[k] (seg [B, S] int32, -1 on padding); the absolute-offset
    tables of `disentangled_attention`.  -> [B, S, H, d]."""
    seg = seg.to(torch.int32)
    c2p_idx, p2c_idx = _device_tables(q.shape[1], span, max_dist, q.device)
    if not use_kernel(q, "attn", "disentangled_attention_packed",
                      disentangled_attention_packed, _served(q, _DIMS)):
        return disentangled_attention_plain(q, k, v, seg, pos_k, pos_q,
                                            c2p_idx, p2c_idx, True)
    out = _launch(q, k, v, seg, pos_k, pos_q, c2p_idx, p2c_idx, True)
    count(disentangled_attention_packed)
    return out


for _fn in (disentangled_attention, disentangled_attention_packed):
    _fn.launches = _fn.plain_routes = 0
