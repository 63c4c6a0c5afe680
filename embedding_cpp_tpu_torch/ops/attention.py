"""Masked multi-head attention over the projection layout: the CUDA
kernel's wrappers and its plain PyTorch version.

Kernel: `csrc/attention_bse.cu`, the Hopper port of the TPU kernel
`_attn_bse_kernel` (embedding_cpp_tpu/ops/attention.py) as called through
`_flash_attention_bse_call` by `flash_attention_packed_bse` (segment mask,
packed rows) and `flash_attention_bse` (additive key bias, plain batches).
q/k/v/o are [B, S, H*d] as the projections produce them; head h is the
column slice h*d .. (h+1)*d, so no transpose happens on either side.  The
kernel keeps a query tile's whole f32 score rows on chip and follows the
reference's order: scale, mask, row max, exp, f32 row sum, e cast to v's
dtype for the PV product (f32 accumulation), divide, cast.  What bounds it
on an H100 and what the first version does about it is noted in the
source.

The wrappers launch the kernel for CUDA tensors and run `attention_bse_plain`
only for tensors on the CPU.  `flash_attention_packed_bse.launches` and
`flash_attention_bse.launches` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check, load

MASK_BIAS = -1e9  # additive score for masked keys (finite, never -inf)
MAX_SEQ = 1024  # a query tile's f32 score rows must fit in shared memory
HEAD_DIMS = (16, 32, 64, 128)


def attention_bse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, h: int, seg_mask: bool) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch.  mask: f32 key bias [B, S],
    or int32 segment ids [B, S] when `seg_mask` (-1 on padding)."""
    b, s, e = q.shape
    d = e // h
    scale = 1.0 / (d**0.5)

    def heads(t):
        return t.reshape(b, s, h, d).permute(0, 2, 1, 3).to(torch.float32)

    scores = torch.matmul(heads(q), heads(k).transpose(-1, -2))  # [B,H,S,S] f32
    if seg_mask:
        allowed = (mask[:, :, None] == mask[:, None, :])[:, None]
        scores = torch.where(allowed, scores * scale,
                             torch.tensor(MASK_BIAS, dtype=torch.float32))
    else:
        scores = scores * scale + mask.to(torch.float32)[:, None, None, :]
    m = torch.amax(scores, dim=-1, keepdim=True)
    ex = torch.exp(scores - m)
    se = torch.sum(ex, dim=-1, keepdim=True)  # before ex is cast
    acc = torch.matmul(ex.to(v.dtype).to(torch.float32), heads(v))
    out = (acc / se).to(q.dtype)
    return out.permute(0, 2, 1, 3).reshape(b, s, e)


def _lib():
    fn = load("attention_bse.cu").attn_bse_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, mask, h: int, seg_mask: bool) -> torch.Tensor:
    """Checks the operands and launches the kernel; returns o [B, S, H*d]."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 3:
        raise ValueError(f"q/k/v shapes {q.shape} {k.shape} {v.shape}")
    b, s, e = q.shape
    if e % h or e // h not in HEAD_DIMS:
        raise ValueError(f"head dim {e}/{h} not in {HEAD_DIMS}")
    if not 1 <= s <= MAX_SEQ:
        raise ValueError(f"sequence length {s} outside 1..{MAX_SEQ}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype} {k.dtype} {v.dtype}")
    want = torch.int32 if seg_mask else torch.float32
    if mask.shape != (b, s) or mask.dtype != want:
        raise ValueError(f"mask {tuple(mask.shape)} {mask.dtype}, want ({b}, {s}) {want}")
    ts = [t.contiguous() for t in (q, k, v, mask)]
    if any(t.device != q.device for t in ts):
        raise ValueError("attention operands on different devices")
    ts = [t.clone() if t.data_ptr() % 16 else t for t in ts]
    out = torch.empty_like(ts[0])
    if b == 0:
        return out
    d = e // h
    err = _lib()(
        *(t.data_ptr() for t in ts), out.data_ptr(), b, s, h, d, 1.0 / (d**0.5),
        int(q.dtype == torch.bfloat16), int(seg_mask),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, "attn_bse_launch")
    return out


def flash_attention_bse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask_bias: torch.Tensor, h: int) -> torch.Tensor:
    """Attention with an additive f32 key bias [B, S] (0 valid, -1e9
    padding) over q/k/v [B, S, H*d] -> [B, S, H*d]."""
    mask_bias = mask_bias.to(torch.float32)
    if q.device.type == "cpu":
        return attention_bse_plain(q, k, v, mask_bias, h, seg_mask=False)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bse: unsupported device {q.device}")
    out = _launch(q, k, v, mask_bias, h, seg_mask=False)
    flash_attention_bse.launches += 1
    return out


def flash_attention_packed_bse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               seg: torch.Tensor, h: int) -> torch.Tensor:
    """Segment-masked attention for packed rows: key k is visible to query q
    iff seg[q] == seg[k] (seg [B, S] int32, -1 on padding)."""
    seg = seg.to(torch.int32)
    if q.device.type == "cpu":
        return attention_bse_plain(q, k, v, seg, h, seg_mask=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_packed_bse: unsupported device {q.device}")
    out = _launch(q, k, v, seg, h, seg_mask=True)
    flash_attention_packed_bse.launches += 1
    return out


flash_attention_bse.launches = 0
flash_attention_packed_bse.launches = 0
