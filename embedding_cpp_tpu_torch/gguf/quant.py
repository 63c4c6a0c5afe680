"""Q4_0 / Q4_1 / Q8_0 block codecs, vectorized with numpy.

A copy of the JAX package's `gguf/quant.py` codecs: both packages must
quantize the same f32 state dict to the same bytes, so the arithmetic is
kept step for step.

Q4_0 (18 bytes / 32 elems):  f16 d;  uint8 qs[16]
    d  = x[argmax |x|] / -8                 value = (q - 8) * d
Q4_1 (20 bytes / 32 elems):  f16 d;  f16 m;  uint8 qs[16]
    m  = min(x);  d = (max(x) - min(x)) / 15  value = q * d + m
Q8_0 (34 bytes / 32 elems):  f16 d;  int8 qs[32]
    d  = max(|x|) / 127                     value = q * d

Nibble packing (Q4): byte j of a block holds element j in the low nibble
and element j+16 in the high nibble.
"""
from __future__ import annotations

import numpy as np

from .constants import QK4, GGMLType


def _blocks(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.size % QK4:
        raise ValueError(f"size {x.size} not divisible by block size {QK4}")
    return x.reshape(-1, QK4)


def pack_nibbles(q: np.ndarray) -> np.ndarray:
    """[nb, 32] uint8 (values 0..15) -> [nb, 16] packed bytes (ggml layout)."""
    lo = q[:, : QK4 // 2]
    hi = q[:, QK4 // 2 :]
    return (lo | (hi << 4)).astype(np.uint8)


def unpack_nibbles(qs: np.ndarray) -> np.ndarray:
    """[nb, 16] packed bytes -> [nb, 32] uint8 values 0..15 (ggml layout)."""
    return np.concatenate([qs & 0x0F, qs >> 4], axis=1)


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    """f32 array (size % 32 == 0) -> raw Q4_0 bytes, one 18-byte rec/block."""
    b = _blocks(x)
    nb = b.shape[0]
    idx = np.argmax(np.abs(b), axis=1)
    maxv = b[np.arange(nb), idx]
    d = maxv / -8.0
    inv = np.where(d != 0.0, np.divide(1.0, d, where=d != 0.0), 0.0)
    # x/d + 8.5 is >= 0.5, so C's truncating int cast == floor here
    q = np.minimum(np.floor(b * inv[:, None] + 8.5), 15.0).astype(np.uint8)
    out = np.empty((nb, 18), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = pack_nibbles(q)
    return out.reshape(-1)


def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    """f32 array (size % 32 == 0) -> raw Q4_1 bytes, one 20-byte rec/block."""
    b = _blocks(x)
    nb = b.shape[0]
    mn = b.min(axis=1)
    mx = b.max(axis=1)
    d = (mx - mn) / 15.0
    inv = np.where(d != 0.0, np.divide(1.0, d, where=d != 0.0), 0.0)
    q = np.minimum(np.floor((b - mn[:, None]) * inv[:, None] + 0.5), 15.0)
    q = q.astype(np.uint8)
    out = np.empty((nb, 20), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = mn.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:] = pack_nibbles(q)
    return out.reshape(-1)


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    """f32 array (size % 32 == 0) -> raw Q8_0 bytes, one 34-byte rec/block."""
    b = _blocks(x)
    nb = b.shape[0]
    d = np.abs(b).max(axis=1) / 127.0
    inv = np.where(d != 0.0, np.divide(1.0, d, where=d != 0.0), 0.0)
    v = b * inv[:, None]
    # C roundf: round half away from zero (numpy rounds half to even)
    q = np.trunc(v + np.copysign(0.5, v)).astype(np.int8)
    out = np.empty((nb, 34), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def _records(raw: np.ndarray, n_elements: int, rec_bytes: int) -> np.ndarray:
    rec = np.frombuffer(np.ascontiguousarray(raw), dtype=np.uint8)
    nb = n_elements // QK4
    return rec[: nb * rec_bytes].reshape(nb, rec_bytes)


def _f16_col(rec: np.ndarray, lo: int) -> np.ndarray:
    return rec[:, lo : lo + 2].copy().view(np.float16).astype(np.float32)


def dequantize(raw: np.ndarray, ggml_type: GGMLType, n_elements: int) -> np.ndarray:
    """Raw tensor bytes of any supported type -> f32 array."""
    if ggml_type == GGMLType.F32:
        return np.frombuffer(
            np.ascontiguousarray(raw), dtype=np.float32, count=n_elements
        ).copy()
    if ggml_type == GGMLType.F16:
        return np.frombuffer(
            np.ascontiguousarray(raw), dtype=np.float16, count=n_elements
        ).astype(np.float32)
    if ggml_type == GGMLType.Q4_0:
        rec = _records(raw, n_elements, 18)
        q = unpack_nibbles(rec[:, 2:]).astype(np.float32)
        out = (q - 8.0) * _f16_col(rec, 0)
    elif ggml_type == GGMLType.Q4_1:
        rec = _records(raw, n_elements, 20)
        q = unpack_nibbles(rec[:, 4:]).astype(np.float32)
        out = q * _f16_col(rec, 0) + _f16_col(rec, 2)
    elif ggml_type == GGMLType.Q8_0:
        rec = _records(raw, n_elements, 34)
        q = rec[:, 2:].copy().view(np.int8).astype(np.float32)
        out = q * _f16_col(rec, 0)
    else:
        raise NotImplementedError(f"dequantize from {ggml_type.name}")
    return out.reshape(-1)[:n_elements].astype(np.float32)


def quantize(x: np.ndarray, ggml_type: GGMLType) -> np.ndarray:
    """f32 array -> raw bytes of the requested type."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    if ggml_type == GGMLType.F32:
        return x.view(np.uint8).reshape(-1)
    if ggml_type == GGMLType.F16:
        return x.astype(np.float16).view(np.uint8).reshape(-1)
    if ggml_type == GGMLType.Q4_0:
        return quantize_q4_0(x)
    if ggml_type == GGMLType.Q4_1:
        return quantize_q4_1(x)
    if ggml_type == GGMLType.Q8_0:
        return quantize_q8_0(x)
    raise NotImplementedError(f"quantize to {ggml_type.name}")
