"""Masked multi-head attention: the CUDA kernels' wrappers and their plain
PyTorch versions.

Projection layout (q/k/v/o [B, S, H*d], head h the column slice h*d ..
(h+1)*d), kernel `csrc/attention_bse.cu`, the Hopper port of the TPU
kernel `_attn_bse_kernel` (embedding_cpp_tpu/ops/attention.py) through
`_flash_attention_bse_call`, for S <= 1024:
  `flash_attention_packed_bse`  segment mask (packed rows)
  `flash_attention_bse`         additive key bias (plain batches)
either with an optional [PH, S, S] position bias (the JAX names
`flash_attention_bias_bse` / `flash_attention_bias_packed_bse` delegate).
The kernel follows the reference's order: scale, mask (and bias), row max,
exp, f32 row sum, e cast to v's dtype for the PV product (f32
accumulation), divide, cast.  Its bf16 body walks 64-query tiles over
64-key tiles in two exact passes (the row max, then exp / sum / PV) and,
on packed rows, skips the keys that share no segment id with the rows
(`bse_skips`); at S <= 32 a block takes several batch rows.

Long rows (q/k/v/o [B, S, H, d], a free view of the projections), kernel
`csrc/attention_long.cu`, for any S:
  `flash_attention`        every key, key bias, optional position bias
                           (TPU `_attn_kernel` via `_flash_attention` and
                           `_flash_attention_bias`)
  `flash_attention_local`  the sliding window over the TPU tile's key slice
                           (TPU `_attn_local_kernel`)
  `flash_attention_packed` segment-masked packed rows past the projection
                           layout's envelope: every key (TPU
                           `_attn_seg_kernel`), or, given the longest
                           segment, the TPU query tile's key slice (TPU
                           `_attn_seg_window_kernel`)
  `flash_attention_packed_local`  the segment mask and the sliding window
                           together over K7's key slice (mode 3; no TPU
                           kernel: the reference's XLA path for ModernBERT's
                           local layers on packed rows past 1024 tokens)
Both packed wrappers take any S: rows of S % 8 != 0 are padded to the next
multiple of 8 with keys of segment -1 (masked for every real query), and
the output is cut back.
Its bf16 body walks 128-query tiles (64 with a position bias; either one
forced by `_launch_long`'s `tile_q`, `LONG_TILES`) over 64-key tiles in the
same two exact passes and, for K6 (segment id spans) and K7 (the window),
skips the key tiles and 8-key runs that hold no visible pair.

Head-major rows (q/k/v/o [B, H, S, d]), kernel
`csrc/attention_headpack.cu`, the Hopper port of B1, the head-packed
kernel of the JAX suite's `bench_attention_headpack`
(benchmarks/kernels.py); no model path runs it:
  `attention_headpack`     hb heads per block, each product one MMA over a
                           block-diagonal operand tile; unlike every kernel
                           above, p is divided by the row sum before PV
The same order of operations in two passes over the key tiles (row max,
then exp / sum / PV), so nothing is rescaled.  What bounds each kernel on
an H100 and what its first version does about it is noted in its source.

Every wrapper launches its kernel for CUDA tensors, raises for what the
kernel does not serve, and runs the plain version for tensors on the CPU,
or where the forward chose it (`attn_impl="plain"`, ops/dispatch.py).
A head dim that the body has no instance for (`HEAD_DIM_INSTANCES`) takes
the plain version under "auto" on any device, decided from the shape
before any launch and counted in the wrapper's `plain_routes`; "kernel"
raises there.  Each wrapper's `launches` counts its kernel launches; the two
projection-layout wrappers count those with a position bias (K4) apart,
in `bias_launches`, and `flash_attention_packed` its windowed launches
in `window_launches`; `flash_attention_packed_local.launches` counts
mode 3.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check, load
from .dispatch import count, use_kernel

MASK_BIAS = -1e9  # additive score for masked keys (finite, never -inf)
MAX_SEQ = 1024  # the JAX route's envelope (a whole [S, S] f32 score tile in VMEM)
# The head dims each CUDA body has instances for: the D switch of its launch
# entry (`dispatch_d` in attention_bse.cu and attention_long.cu, `dispatch`
# in deberta_attention.cu).  Any other d takes the plain version.
HEAD_DIM_INSTANCES = {
    "attention_bse.cu": (16, 32, 64, 96, 128),
    "attention_long.cu": (16, 32, 64, 128),
    "deberta_attention.cu": (16, 32, 64, 128),
}
_BSE_DIMS = HEAD_DIM_INSTANCES["attention_bse.cu"]
_LONG_DIMS = HEAD_DIM_INSTANCES["attention_long.cu"]
_PLAIN_CHUNK = 1 << 26  # score elements per chunk of the long plain version


def fits_bias_bse(s: int, d: int) -> bool:
    """True when the projection-layout kernel serves sequence length `s`
    and head dim `d` (its bias rows stream from device memory, so the bias
    adds no limit)."""
    return 1 <= s <= MAX_SEQ and d in _BSE_DIMS


# The bf16 body's tiling, as csrc/attention_bse.cu names it (`tc::TILE_Q`,
# `TILE_K`, `NW`): blocks of 64 query rows, 16 per warp, over 64-key tiles;
# a warp skips keys in runs of 8, the n of its m16n8k16 products.
BSE_TILE_Q = 64
BSE_TILE_K = 64
BSE_WARP_ROWS, BSE_RUN = 16, 8


def _spans(seg: torch.Tensor, width: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lo, hi, pad) [B, S_pad / width] of each run of `width` positions of
    seg [B, S]: [min, max] over the ids other than -1 (lo > hi when none)
    and whether -1 is among them; positions past S hold no key."""
    b, s = seg.shape
    n = -(-s // BSE_TILE_K) * BSE_TILE_K // width
    big = torch.iinfo(torch.int64).max
    ids = torch.zeros((b, n * width), dtype=torch.int64)
    ids[:, :s] = seg.to(torch.int64).cpu()
    key = torch.arange(n * width) < s
    real = (ids != -1) & key
    lo = torch.where(real, ids, big).reshape(b, n, width).amin(-1)
    hi = torch.where(real, ids, -big).reshape(b, n, width).amax(-1)
    pad = ((ids == -1) & key).reshape(b, n, width).any(-1)
    return lo, hi, pad


def _meet(a, b) -> torch.Tensor:
    """Spans that may hold a pair of equal ids: overlapping, or both with
    padding (broadcasting over their shapes)."""
    return ((a[0] <= b[1]) & (b[0] <= a[1])) | (a[2] & b[2])


def bse_skips(seg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """What the segment kernel skips on seg [B, S] with S > 32 (at short S,
    where a block takes several batch rows, it skips nothing): kept [B, nq,
    nk], key tile j is loaded for query tile i (their spans meet); scored
    [B, nq * 4, nk * 8], a warp's 16 rows score 8 keys (their tile is kept
    and their spans meet).  A span is [min, max] over the ids other than -1
    and whether -1 is there: no pair of spans that misses holds a visible
    (query, key) pair, for any ids.  Runs and rows past S hold no span, so
    they count as not scored (the kernel does not reach them)."""
    tile = _spans(seg, BSE_TILE_K)
    run = _spans(seg, BSE_RUN)
    rows = _spans(seg, BSE_WARP_ROWS)
    kept = _meet(tuple(t[:, :, None] for t in tile), tuple(t[:, None, :] for t in tile))
    per_tile = BSE_TILE_Q // BSE_WARP_ROWS, BSE_TILE_K // BSE_RUN
    scored = _meet(tuple(t[:, :, None] for t in rows), tuple(t[:, None, :] for t in run))
    scored &= kept.repeat_interleave(per_tile[0], 1).repeat_interleave(per_tile[1], 2)
    return kept, scored


def _pos_bias_heads(pos_bias: torch.Tensor, h: int) -> torch.Tensor:
    """[PH, S, S] -> a [1, H|1, S, S] view that broadcasts over batch."""
    if pos_bias.shape[0] not in (1, h):
        raise ValueError(f"pos_bias heads {pos_bias.shape[0]} not in (1, {h})")
    return pos_bias.to(torch.float32)[None]


def attention_bse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, h: int, seg_mask: bool,
                        pos_bias: torch.Tensor | None = None) -> torch.Tensor:
    """The projection-layout kernel's arithmetic in plain PyTorch.  mask:
    f32 key bias [B, S], or int32 segment ids [B, S] when `seg_mask` (-1
    on padding); pos_bias: optional f32 [PH, S, S], PH in {1, H}."""
    b, s, e = q.shape
    d = e // h
    scale = 1.0 / (d**0.5)

    def heads(t):
        return t.reshape(b, s, h, d).permute(0, 2, 1, 3)

    scores = torch.matmul(heads(q).to(torch.float32),
                          heads(k).to(torch.float32).transpose(-1, -2))  # [B,H,S,S]
    if seg_mask:
        allowed = (mask[:, :, None] == mask[:, None, :])[:, None]
        sc = scores * scale
        if pos_bias is not None:
            sc = sc + _pos_bias_heads(pos_bias, h)
        scores = torch.where(allowed, sc, torch.tensor(MASK_BIAS, dtype=torch.float32))
    else:
        scores = scores * scale + mask.to(torch.float32)[:, None, None, :]
        if pos_bias is not None:
            scores = scores + _pos_bias_heads(pos_bias, h)
    out = _softmax_pv(scores, heads(v), q.dtype)
    return out.permute(0, 2, 1, 3).reshape(b, s, e)


def _softmax_pv(scores: torch.Tensor, v: torch.Tensor, out_dtype) -> torch.Tensor:
    """max, exp, f32 row sum before e is cast, e cast to v's dtype, f32
    product, divide, cast (scores [..., Q, K] f32, v [..., K, d])."""
    m = torch.amax(scores, dim=-1, keepdim=True)
    ex = torch.exp(scores - m)
    se = torch.sum(ex, dim=-1, keepdim=True)
    acc = torch.matmul(ex.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return (acc / se).to(out_dtype)


def attention_long_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask_bias: torch.Tensor,
                         pos_bias: torch.Tensor | None = None) -> torch.Tensor:
    """The long-row kernel's arithmetic in plain PyTorch: q/k/v [B, S, H,
    d], mask_bias f32 [B, S], pos_bias optional f32 [PH, S, S] ->
    [B, S, H, d].  Query rows go in chunks so [B, H, rows, S] stays small."""
    b, s, h, d = q.shape
    scale = 1.0 / (d**0.5)
    kh = k.permute(0, 2, 1, 3).to(torch.float32)  # [B, H, S, d]
    vh = v.permute(0, 2, 1, 3)
    keyb = mask_bias.to(torch.float32)[:, None, None, :]
    pb = None if pos_bias is None else _pos_bias_heads(pos_bias, h)
    out = torch.empty_like(q)
    rows = max(1, _PLAIN_CHUNK // max(1, b * h * s))
    for r0 in range(0, s, rows):
        qc = q[:, r0:r0 + rows].permute(0, 2, 1, 3).to(torch.float32)
        scores = torch.matmul(qc, kh.transpose(-1, -2)) * scale + keyb
        if pb is not None:
            scores = scores + pb[:, :, r0:r0 + rows]
        out[:, r0:r0 + rows] = _softmax_pv(scores, vh, q.dtype).permute(0, 2, 1, 3)
    return out


def local_window_tiles(s: int, window: int) -> tuple[int, int | None]:
    """(tq, wmax) of the TPU sliding-window kernel: query tiles of tq rows
    each score a slice of wmax keys; wmax is None when the slice would not
    be narrower than the sequence (S % 128 != 0, or a short S), where the
    reference takes the long-row kernel with an [S, S] window bias."""
    if s % 128:
        return 128, None
    tq = 256 if s % 256 == 0 and s >= 2048 else 128
    wmax = -(-(tq + window + 16) // 128) * 128
    return tq, wmax if wmax < s else None


def _local_slices(s: int, window: int, device) -> tuple[int, int, torch.Tensor]:
    """(tq, wmax, kidx [S/tq, wmax]): the key indices of each TPU query
    tile's slice, kstart = clip(((qs + (tq - wmax)//2)//8)*8, 0, S - wmax)."""
    tq, wmax = local_window_tiles(s, window)
    if wmax is None:
        raise ValueError(f"no sliding-window slice for S={s}, window={window}")
    return tq, wmax, _slice_keys(s, tq, wmax, device)


def attention_local_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask_bias: torch.Tensor, window: int) -> torch.Tensor:
    """The sliding-window kernel's arithmetic in plain PyTorch: each TPU
    query tile scores only its slice's keys, s*scale + (|q - k| <= window/2
    ? keybias : -1e9).  q/k/v [B, S, H, d] -> [B, S, H, d]."""
    b, s, h, d = q.shape
    scale = 1.0 / (d**0.5)
    tq, wmax, kidx = _local_slices(s, window, q.device)
    nt = s // tq
    qpos = torch.arange(s, device=q.device).reshape(nt, tq)
    inwin = (qpos[:, :, None] - kidx[:, None, :]).abs() <= window // 2  # [nt, tq, wmax]
    keyb = mask_bias.to(torch.float32)[:, kidx]  # [B, nt, wmax]
    add = torch.where(inwin[None], keyb[:, :, None, :],
                      torch.tensor(MASK_BIAS, dtype=torch.float32, device=q.device))
    qt = q.reshape(b, nt, tq, h, d).permute(0, 1, 3, 2, 4).to(torch.float32)
    kt = k[:, kidx].permute(0, 1, 3, 4, 2).to(torch.float32)  # [B, nt, H, d, wmax]
    vt = v[:, kidx].permute(0, 1, 3, 2, 4)  # [B, nt, H, wmax, d]
    scores = torch.matmul(qt, kt) * scale + add[:, :, None]  # [B, nt, H, tq, wmax]
    out = _softmax_pv(scores, vt, q.dtype)  # [B, nt, H, tq, d]
    return out.permute(0, 1, 3, 2, 4).reshape(b, s, h, d)


def packed_window_tiles(s: int, max_seg_len: int | None) -> tuple[int, int | None]:
    """(tq, wmax) of the TPU windowed segment kernel: query tiles of tq
    rows each score a slice of wmax keys, a margin of the longest segment
    plus the 8-alignment slack on either side; wmax is None (the full
    kernel runs) without a bound, for S % 128 != 0 or S < 1024, or when
    the slice would not be narrower than S."""
    tq = 256 if s % 256 == 0 else 128
    if max_seg_len is None or s % 128 or s < 1024:
        return tq, None
    wmax = -(-(tq + 2 * max_seg_len + 24) // 128) * 128
    return tq, wmax if wmax < s else None


def packed_bse_applies(s: int, d: int, max_seg_len: int | None) -> bool:
    """True when packed rows take the projection-layout kernel (K2): S in
    128..1024 with aligned tiles, and the windowed segment kernel would not
    apply (it needs the [B, S, H, d] layout and runs from S = 1024)."""
    if s % 8 or d % 8 or not 128 <= s <= MAX_SEQ:
        return False
    return packed_window_tiles(s, max_seg_len)[1] is None


def _slice_keys(s: int, tq: int, wmax: int, device) -> torch.Tensor:
    """kidx [S/tq, wmax]: the key indices of each TPU query tile's slice,
    kstart = clip(((qs + (tq - wmax)//2)//8)*8, 0, S - wmax)."""
    qs = torch.arange(0, s, tq, device=device)
    kstart = torch.clamp(torch.div(qs + (tq - wmax) // 2, 8, rounding_mode="floor") * 8,
                         0, s - wmax)
    return kstart[:, None] + torch.arange(wmax, device=device)[None, :]


def attention_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           seg: torch.Tensor) -> torch.Tensor:
    """The full segment kernel's arithmetic in plain PyTorch: q/k/v [B, S,
    H, d], seg [B, S] int32 -> [B, S, H, d]; seg[q] == seg[k] ? s*scale :
    -1e9 over every key (padding rows, seg -1, attend the padding keys).
    Query rows go in chunks so [B, H, rows, S] stays small."""
    b, s, h, d = q.shape
    scale = 1.0 / (d**0.5)
    kh = k.permute(0, 2, 1, 3).to(torch.float32)
    vh = v.permute(0, 2, 1, 3)
    masked = torch.tensor(MASK_BIAS, dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    rows = max(1, _PLAIN_CHUNK // max(1, b * h * s))
    for r0 in range(0, s, rows):
        qc = q[:, r0:r0 + rows].permute(0, 2, 1, 3).to(torch.float32)
        allowed = (seg[:, r0:r0 + rows, None] == seg[:, None, :])[:, None]
        scores = torch.where(allowed, torch.matmul(qc, kh.transpose(-1, -2)) * scale, masked)
        out[:, r0:r0 + rows] = _softmax_pv(scores, vh, q.dtype).permute(0, 2, 1, 3)
    return out


def attention_packed_local_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 seg: torch.Tensor, window: int) -> torch.Tensor:
    """Mode 3's arithmetic in plain PyTorch: key k is visible to query q
    iff seg[q] == seg[k] and |q - k| <= window // 2, s*scale, else -1e9,
    over each TPU query tile's slice of K7 (`local_window_tiles`), or over
    the whole row where S has no slice.  q/k/v [B, S, H, d] -> [B, S, H,
    d]."""
    b, s, h, d = q.shape
    scale = 1.0 / (d**0.5)
    masked = torch.tensor(MASK_BIAS, dtype=torch.float32, device=q.device)
    tq, wmax = local_window_tiles(s, window)
    if wmax is None:  # the slice is the whole row: query rows in chunks
        kh = k.permute(0, 2, 1, 3).to(torch.float32)
        vh = v.permute(0, 2, 1, 3)
        kpos = torch.arange(s, device=q.device)
        out = torch.empty_like(q)
        rows = max(1, _PLAIN_CHUNK // max(1, b * h * s))
        for r0 in range(0, s, rows):
            qc = q[:, r0:r0 + rows].permute(0, 2, 1, 3).to(torch.float32)
            inwin = (kpos[r0:r0 + rows, None] - kpos[None, :]).abs() <= window // 2
            allowed = (seg[:, r0:r0 + rows, None] == seg[:, None, :]) & inwin
            scores = torch.where(allowed[:, None],
                                 torch.matmul(qc, kh.transpose(-1, -2)) * scale, masked)
            out[:, r0:r0 + rows] = _softmax_pv(scores, vh, q.dtype).permute(0, 2, 1, 3)
        return out
    kidx = _slice_keys(s, tq, wmax, q.device)
    nt = s // tq
    qpos = torch.arange(s, device=q.device).reshape(nt, tq)
    inwin = (qpos[:, :, None] - kidx[:, None, :]).abs() <= window // 2  # [nt, tq, wmax]
    allowed = (seg.reshape(b, nt, tq)[..., None] == seg[:, kidx][:, :, None, :]) & inwin
    qt = q.reshape(b, nt, tq, h, d).permute(0, 1, 3, 2, 4).to(torch.float32)
    kt = k[:, kidx].permute(0, 1, 3, 4, 2).to(torch.float32)  # [B, nt, H, d, wmax]
    vt = v[:, kidx].permute(0, 1, 3, 2, 4)  # [B, nt, H, wmax, d]
    scores = torch.where(allowed[:, :, None], torch.matmul(qt, kt) * scale, masked)
    out = _softmax_pv(scores, vt, q.dtype)  # [B, nt, H, tq, d]
    return out.permute(0, 1, 3, 2, 4).reshape(b, s, h, d)


def attention_packed_window_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  seg: torch.Tensor, max_seg_len: int) -> torch.Tensor:
    """The windowed segment kernel's arithmetic in plain PyTorch: each TPU
    query tile scores only its slice's keys, seg[q] == seg[k] ? s*scale :
    -1e9.  q/k/v [B, S, H, d] -> [B, S, H, d]."""
    b, s, h, d = q.shape
    scale = 1.0 / (d**0.5)
    tq, wmax = packed_window_tiles(s, max_seg_len)
    if wmax is None:
        raise ValueError(f"no segment window for S={s}, max_seg_len={max_seg_len}")
    kidx = _slice_keys(s, tq, wmax, q.device)
    nt = s // tq
    allowed = seg.reshape(b, nt, tq)[..., None] == seg[:, kidx][:, :, None, :]
    qt = q.reshape(b, nt, tq, h, d).permute(0, 1, 3, 2, 4).to(torch.float32)
    kt = k[:, kidx].permute(0, 1, 3, 4, 2).to(torch.float32)  # [B, nt, H, d, wmax]
    vt = v[:, kidx].permute(0, 1, 3, 2, 4)  # [B, nt, H, wmax, d]
    scores = torch.where(allowed[:, :, None], torch.matmul(qt, kt) * scale,
                         torch.tensor(MASK_BIAS, dtype=torch.float32, device=q.device))
    out = _softmax_pv(scores, vt, q.dtype)  # [B, nt, H, tq, d]
    return out.permute(0, 1, 3, 2, 4).reshape(b, s, h, d)


# (head dim, heads per block) B1 is built for: the packed width hb * d
# stays within one 128-column tile
HEADPACK_SHAPES = ((32, 1), (32, 2), (32, 4), (64, 1), (64, 2))


def attention_headpack_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias: torch.Tensor, hb: int) -> torch.Tensor:
    """B1's arithmetic in plain PyTorch: q/k/v [B, H, S, d], bias [B, S]
    f32 -> [B, H, S, d].  Per head: f32 scores * 1/sqrt(d) + bias, row max,
    e = exp(s - m), p = e / sum(e) divided before the PV product, p rounded
    to v's dtype, f32 product, cast to q's dtype.  The TPU kernel's
    block-diagonal operands add exact zeros, so head by head is the same
    function; `hb` only has to divide H.  Query rows go in chunks."""
    b, h, s, d = q.shape
    if h % hb:
        raise ValueError(f"{h} heads not divisible into groups of {hb}")
    scale = 1.0 / (d**0.5)
    kt = k.to(torch.float32).transpose(-1, -2)
    vf = v.to(torch.float32)
    keyb = bias.to(torch.float32)[:, None, None, :]
    out = torch.empty_like(q)
    rows = max(1, _PLAIN_CHUNK // max(1, b * h * s))
    for r0 in range(0, s, rows):
        sc = torch.matmul(q[:, :, r0:r0 + rows].to(torch.float32), kt) * scale + keyb
        e = torch.exp(sc - torch.amax(sc, dim=-1, keepdim=True))
        p = (e / torch.sum(e, dim=-1, keepdim=True)).to(v.dtype)
        out[:, :, r0:r0 + rows] = torch.matmul(p.to(torch.float32), vf).to(q.dtype)
    return out


# --- launches ----------------------------------------------------------------

def _bind(source: str, entry: str, argtypes):
    fn = getattr(load(source), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _operands(ts, device):
    """Contiguous, 16-byte aligned copies where needed, all on `device`."""
    out = []
    for t in ts:
        if t is None:
            out.append(None)
            continue
        if t.device != device:
            raise ValueError("attention operands on different devices")
        t = t.contiguous()
        out.append(t.clone() if t.data_ptr() % 16 else t)
    return out


def _check_qkv(q, k, v, heads_last: bool, h: int | None = None) -> tuple[int, int, int, int]:
    """(B, S, H, d) of q/k/v in [B, S, H*d] (heads_last False) or
    [B, S, H, d] layout; raises on what the kernel of that layout does not
    serve."""
    want = 4 if heads_last else 3
    if q.shape != k.shape or q.shape != v.shape or q.dim() != want:
        raise ValueError(f"q/k/v shapes {q.shape} {k.shape} {v.shape}")
    if heads_last:
        b, s, h, d = q.shape
    else:
        b, s, e = q.shape
        if e % h:
            raise ValueError(f"width {e} not divisible by {h} heads")
        d = e // h
    dims = _LONG_DIMS if heads_last else _BSE_DIMS
    if d not in dims:
        raise ValueError(f"head dim {d} not in {dims}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype} {k.dtype} {v.dtype}")
    return b, s, h, d


def _check_pos_bias(pos_bias, h: int, s: int) -> None:
    if pos_bias is not None and (pos_bias.dim() != 3 or pos_bias.shape[0] not in (1, h)
                                 or pos_bias.shape[1:] != (s, s)
                                 or pos_bias.dtype != torch.float32):
        raise ValueError(f"pos_bias {tuple(pos_bias.shape)} {pos_bias.dtype}, "
                         f"want (1|{h}, {s}, {s}) float32")


def _launch_bse(q, k, v, mask, h: int, seg_mask: bool, pos_bias=None) -> torch.Tensor:
    """Checks the operands and launches the projection-layout kernel."""
    b, s, _, d = _check_qkv(q, k, v, False, h)
    if not 1 <= s <= MAX_SEQ:
        raise ValueError(f"sequence length {s} outside 1..{MAX_SEQ}")
    want = torch.int32 if seg_mask else torch.float32
    if mask.shape != (b, s) or mask.dtype != want:
        raise ValueError(f"mask {tuple(mask.shape)} {mask.dtype}, want ({b}, {s}) {want}")
    _check_pos_bias(pos_bias, h, s)
    q, k, v, mask, pos_bias = _operands((q, k, v, mask, pos_bias), q.device)
    out = torch.empty_like(q)
    if b == 0:
        return out
    err = _bind("attention_bse.cu", "attn_bse_launch",
                [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        None if pos_bias is None else pos_bias.data_ptr(), out.data_ptr(),
        b, s, h, d, 1 if pos_bias is None else pos_bias.shape[0], 1.0 / (d**0.5),
        int(q.dtype == torch.bfloat16), int(seg_mask),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, "attn_bse_launch")
    return out


_FULL, _LOCAL, _SEG, _SEG_LOCAL = 0, 1, 2, 3  # attention_long.cu's modes
LONG_TILES = (64, 128)  # the query tiles attention_long.cu's bf16 body is built for


def _launch_long(q, k, v, mask, mode: int, pos_bias=None, window: int = 0,
                 max_seg_len: int | None = None, tile_q: int = 0) -> torch.Tensor:
    """Checks the operands and launches the long-row kernel in `mode`:
    _FULL, every key under an f32 key bias; _LOCAL, the sliding-window
    slices of `window`; _SEG, int32 segment ids over the TPU tile's key
    slice when `max_seg_len` gives one, else every key; _SEG_LOCAL, int32
    segment ids and the window over K7's slices, or every key where S has
    none.  `tile_q` forces the bf16 body's query rows a block (LONG_TILES;
    0: the source's rule)."""
    b, s, h, d = _check_qkv(q, k, v, True)
    want = torch.int32 if mode in (_SEG, _SEG_LOCAL) else torch.float32
    if mask.shape != (b, s) or mask.dtype != want:
        raise ValueError(f"mask {tuple(mask.shape)} {mask.dtype}, want ({b}, {s}) {want}")
    _check_pos_bias(pos_bias, h, s)
    tq, wmax = 0, 0
    if mode == _SEG:
        tq, wmax = packed_window_tiles(s, max_seg_len)
        wmax = wmax or s  # no window: the slice is the whole row
    elif mode == _LOCAL:
        tq, wmax = local_window_tiles(s, window)
        if wmax is None:
            raise ValueError(f"no sliding-window slice for S={s}, window={window}")
    elif mode == _SEG_LOCAL:
        tq, wmax = local_window_tiles(s, window)
        wmax = wmax or s
    q, k, v, mask, pos_bias = _operands((q, k, v, mask, pos_bias), q.device)
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    if tile_q not in (0, *LONG_TILES):
        raise ValueError(f"tile_q {tile_q} not in {LONG_TILES}")
    err = _bind("attention_long.cu", "attn_long_launch_tile",
                [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _P])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        None if pos_bias is None else pos_bias.data_ptr(), out.data_ptr(),
        b, s, h, d, 1 if pos_bias is None else pos_bias.shape[0], 1.0 / (d**0.5),
        int(q.dtype == torch.bfloat16), mode, tq, wmax, window, tile_q,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, "attn_long_launch_tile")
    return out


def _served(q: torch.Tensor, dims: tuple, h: int | None = None) -> bool:
    """Whether a kernel instance of `dims` serves q's head dim: q [B, S,
    H*d] with `h` heads, or [B, S, H, d] without.  A shape that no kernel
    takes counts as served, so that the kernel branch's checks name it."""
    if h is None:
        return q.dim() != 4 or q.shape[-1] in dims
    return q.dim() != 3 or h <= 0 or q.shape[-1] % h != 0 or q.shape[-1] // h in dims


def _count(fn, pos_bias) -> None:
    """One launch of `fn`'s kernel: `bias_launches` with a position bias
    (K4), else `launches` (K2/K3)."""
    if pos_bias is None:
        count(fn)
    else:
        count(fn, "bias_launches")


def flash_attention_bse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask_bias: torch.Tensor, h: int,
                        pos_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Attention with an additive f32 key bias [B, S] (0 valid, -1e9
    padding) over q/k/v [B, S, H*d] -> [B, S, H*d]; an optional position
    bias [PH, S, S] f32 (PH = H, or 1 when head-invariant) is added after
    it: (s*scale + keybias) + pos_bias."""
    mask_bias = mask_bias.to(torch.float32)
    if pos_bias is not None:
        pos_bias = pos_bias.to(torch.float32)
    if not use_kernel(q, "attn", "flash_attention_bse", flash_attention_bse,
                      _served(q, _BSE_DIMS, h)):
        return attention_bse_plain(q, k, v, mask_bias, h, False, pos_bias)
    out = _launch_bse(q, k, v, mask_bias, h, False, pos_bias)
    _count(flash_attention_bse, pos_bias)
    return out


def flash_attention_packed_bse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               seg: torch.Tensor, h: int,
                               pos_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Segment-masked attention for packed rows: key k is visible to query q
    iff seg[q] == seg[k] (seg [B, S] int32, -1 on padding).  An optional
    position bias [PH, S, S] f32 built from absolute row offsets is added
    to the visible pairs: seg[q] == seg[k] ? s*scale + pos_bias : -1e9
    (valid for packed rows because within a segment the restart positions
    are consecutive)."""
    seg = seg.to(torch.int32)
    if pos_bias is not None:
        pos_bias = pos_bias.to(torch.float32)
    if not use_kernel(q, "attn", "flash_attention_packed_bse", flash_attention_packed_bse,
                      _served(q, _BSE_DIMS, h)):
        return attention_bse_plain(q, k, v, seg, h, True, pos_bias)
    out = _launch_bse(q, k, v, seg, h, True, pos_bias)
    _count(flash_attention_packed_bse, pos_bias)
    return out


def flash_attention_bias_bse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             mask_bias: torch.Tensor, pos_bias: torch.Tensor,
                             h: int) -> torch.Tensor:
    """`flash_attention_bse` with a position bias, in the JAX entry's
    argument order."""
    return flash_attention_bse(q, k, v, mask_bias, h, pos_bias)


def flash_attention_bias_packed_bse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    seg: torch.Tensor, pos_bias: torch.Tensor,
                                    h: int) -> torch.Tensor:
    """`flash_attention_packed_bse` with a position bias, in the JAX
    entry's argument order."""
    return flash_attention_packed_bse(q, k, v, seg, h, pos_bias)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask_bias: torch.Tensor,
                    pos_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Masked attention over every key: q/k/v [B, S, H, d], mask_bias
    [B, S] f32 (0 valid, -1e9 padding), optional pos_bias [H|1, S, S] f32
    added after the key bias -> [B, S, H, d]."""
    mask_bias = mask_bias.to(torch.float32)
    if pos_bias is not None:
        pos_bias = pos_bias.to(torch.float32)
    if not use_kernel(q, "attn", "flash_attention", flash_attention, _served(q, _LONG_DIMS)):
        return attention_long_plain(q, k, v, mask_bias, pos_bias)
    out = _launch_long(q, k, v, mask_bias, _FULL, pos_bias)
    count(flash_attention)
    return out


def flash_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask_bias: torch.Tensor, window: int) -> torch.Tensor:
    """Sliding-window attention (ModernBERT's local layers): key k is
    visible to query q iff |q - k| <= window // 2 and k is valid, scored
    over the TPU query tile's key slice.  q/k/v [B, S, H, d] with S a
    multiple of 128 and the slice narrower than S (local_window_tiles)."""
    mask_bias = mask_bias.to(torch.float32)
    if not use_kernel(q, "attn", "flash_attention_local", flash_attention_local,
                      _served(q, _LONG_DIMS)):
        return attention_local_plain(q, k, v, mask_bias, window)
    if window <= 0:
        raise ValueError(f"window {window} must be positive")
    out = _launch_long(q, k, v, mask_bias, _LOCAL, window=window)
    count(flash_attention_local)
    return out


def pad_rows8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              seg: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """q/k/v [B, S, H, d] and seg [B, S] padded to the next multiple of 8
    rows (the segment kernels read ids 8 at a time): zero rows of segment
    -1, masked for every real query.  Unchanged where S % 8 == 0."""
    pad = -q.shape[1] % 8
    if not pad:
        return q, k, v, seg
    q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    return q, k, v, torch.nn.functional.pad(seg, (0, pad), value=-1)


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           seg: torch.Tensor, max_seg_len: int | None = None) -> torch.Tensor:
    """Segment-masked attention for packed rows in the [B, S, H, d] layout:
    key k is visible to query q iff seg[q] == seg[k] (seg [B, S] int32, -1
    on padding).  `max_seg_len` bounds the longest packed segment: where
    `packed_window_tiles` gives a slice narrower than S, each TPU query tile
    scores only its wmax keys (`window_launches`), else every key
    (`launches`).  Rows of S % 8 != 0 run padded (`pad_rows8`)."""
    s = q.shape[1]
    q, k, v, seg = pad_rows8(q, k, v, seg.to(torch.int32))
    windowed = packed_window_tiles(q.shape[1], max_seg_len)[1] is not None
    if not use_kernel(q, "attn", "flash_attention_packed", flash_attention_packed,
                      _served(q, _LONG_DIMS)):
        if windowed:
            return attention_packed_window_plain(q, k, v, seg, max_seg_len)[:, :s]
        return attention_packed_plain(q, k, v, seg)[:, :s]
    out = _launch_long(q, k, v, seg, _SEG, max_seg_len=max_seg_len)
    if windowed:
        count(flash_attention_packed, "window_launches")
    else:
        count(flash_attention_packed)
    return out[:, :s]


def flash_attention_packed_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 seg: torch.Tensor, window: int) -> torch.Tensor:
    """Segment-masked sliding-window attention for packed rows (mode 3,
    ModernBERT's local layers past 1024 tokens): key k is visible to query
    q iff seg[q] == seg[k] and |q - k| <= window // 2 (seg [B, S] int32, -1
    on padding; row offsets, which within a segment are the restart
    positions' distances), over K7's key slices, or every key where S has
    none.  Rows of S % 8 != 0 run padded (`pad_rows8`)."""
    s = q.shape[1]
    if window <= 0:
        raise ValueError(f"window {window} must be positive")
    q, k, v, seg = pad_rows8(q, k, v, seg.to(torch.int32))
    if not use_kernel(q, "attn", "flash_attention_packed_local", flash_attention_packed_local,
                      _served(q, _LONG_DIMS)):
        return attention_packed_local_plain(q, k, v, seg, window)[:, :s]
    out = _launch_long(q, k, v, seg, _SEG_LOCAL, window=window)
    count(flash_attention_packed_local)
    return out[:, :s]


def attention_headpack(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: torch.Tensor, hb: int) -> torch.Tensor:
    """Head-packed attention (B1): q/k/v [B, H, S, d] bf16 (head-major),
    bias [B, S] f32 (0 valid, -1e9 masked), hb heads per block -> [B, H,
    S, d]; (d, hb) in HEADPACK_SHAPES with hb dividing H."""
    bias = bias.to(torch.float32)
    if not use_kernel(q, "attn", "attention_headpack"):
        return attention_headpack_plain(q, k, v, bias, hb)
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q/k/v shapes {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, h, s, d = q.shape
    if (d, hb) not in HEADPACK_SHAPES or h % hb:
        raise ValueError(f"(d={d}, hb={hb}) with {h} heads: the kernel takes (d, hb) in "
                         f"{HEADPACK_SHAPES} and hb dividing H")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"q/k/v dtypes {q.dtype} {k.dtype} {v.dtype}, want bfloat16")
    if bias.shape != (b, s):
        raise ValueError(f"bias {tuple(bias.shape)}, want ({b}, {s})")
    q, k, v, bias = _operands((q, k, v, bias), q.device)
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    err = _bind("attention_headpack.cu", "attn_headpack_launch",
                [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, s, h, d, hb, 1.0 / (d**0.5), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "attn_headpack_launch")
    count(attention_headpack)
    return out


for _fn in (flash_attention_bse, flash_attention_packed_bse, flash_attention,
            flash_attention_local, flash_attention_packed, flash_attention_packed_local,
            attention_headpack):
    _fn.launches = _fn.plain_routes = 0
flash_attention_bse.bias_launches = flash_attention_packed_bse.bias_launches = 0
flash_attention_packed.window_launches = 0
