"""Device-resident quantized weights (Q4_0 / Q4_1 / Q8_0) as torch tensors.

The same layout as the JAX package's `ops/qtensor.py`, so weights carry
across as plain copies and `dequantize` equals the JAX one bit for bit:

- matmul weights are contraction-major: logical [K, N] (in, out);
- Q4 nibbles are packed block-locally split-half: within each 32-row
  block, byte-row j holds element j (low nibble) and element j+16 (high
  nibble).  Q8 codes are plain int8 [K, N];
- scales (and Q4_1 mins) live in separate f32 planes [K/32, N].

Row-gathered tables (the word embeddings) keep their rows: qs [V, E/2]
(or int8 [V, E]) with scales [V, E/32], read by `gather_rows`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.constants import QK4, GGMLType
from ..gguf.quant import unpack_nibbles

Q4_TYPES = (GGMLType.Q4_0, GGMLType.Q4_1)
QUANT_TYPES = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q8_0)


@dataclass
class QTensor:
    """Packed quantized tensor.

    qs:     Q4: uint8 [..., K//2, N]  (block-local split-half packing)
            Q8: int8  [..., K, N]
    scales: f32 [..., K//32, N]
    mins:   f32 [..., K//32, N] for Q4_1, else None
    shape:  logical per-tensor shape (K, N), without stacked leading axes
    qtype:  GGMLType.Q4_0, Q4_1 or Q8_0
    """

    qs: torch.Tensor
    scales: torch.Tensor
    mins: torch.Tensor | None
    shape: tuple[int, ...]
    qtype: GGMLType

    def map(self, fn) -> "QTensor":
        """Apply `fn` to every tensor field (device moves, layer slices)."""
        return QTensor(
            qs=fn(self.qs), scales=fn(self.scales),
            mins=None if self.mins is None else fn(self.mins),
            shape=self.shape, qtype=self.qtype,
        )

    def __getitem__(self, i) -> "QTensor":
        """One layer of a layer-stacked tensor."""
        return self.map(lambda t: t[i])


def _split_q4_records(raw: np.ndarray, n_elements: int, qtype: GGMLType):
    """Raw ggml Q4 block records -> (q values [nb, 32] uint8, d [nb], m [nb])."""
    nb = n_elements // QK4
    rec_bytes = 18 if qtype == GGMLType.Q4_0 else 20
    rec = np.frombuffer(np.ascontiguousarray(raw), dtype=np.uint8)[: nb * rec_bytes]
    rec = rec.reshape(nb, rec_bytes)
    d = rec[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(nb)
    if qtype == GGMLType.Q4_0:
        return unpack_nibbles(rec[:, 2:]), d, None
    m = rec[:, 2:4].copy().view(np.float16).astype(np.float32).reshape(nb)
    return unpack_nibbles(rec[:, 4:]), d, m


def _split_q8_records(raw: np.ndarray, n_elements: int):
    """Raw ggml Q8_0 records -> (q codes [nb, 32] int8, d [nb] f32)."""
    nb = n_elements // QK4
    rec = np.frombuffer(np.ascontiguousarray(raw), dtype=np.uint8)[: nb * 34]
    rec = rec.reshape(nb, 34)
    d = rec[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(nb)
    return rec[:, 2:].copy().view(np.int8), d


def _qtensor(qs, scales, mins, shape, qtype) -> QTensor:
    return QTensor(
        qs=torch.from_numpy(np.ascontiguousarray(qs)),
        scales=torch.from_numpy(np.ascontiguousarray(scales)),
        mins=None if mins is None else torch.from_numpy(np.ascontiguousarray(mins)),
        shape=tuple(shape), qtype=GGMLType(qtype),
    )


def pack_q4_matmul(raw: np.ndarray, out_in_shape: tuple[int, int],
                   qtype: GGMLType) -> QTensor:
    """GGUF Q4 payload of an [out, in] weight -> contraction-major QTensor.
    GGUF blocks run along `in`, which becomes the contraction axis K."""
    out, inner = out_in_shape
    q, d, m = _split_q4_records(raw, out * inner, qtype)
    q_kn = q.reshape(out, inner).T  # [K, N]
    blocks = q_kn.reshape(inner // QK4, QK4, out)
    qs = (blocks[:, : QK4 // 2] | (blocks[:, QK4 // 2 :] << 4)).reshape(
        inner // 2, out
    ).astype(np.uint8)
    scales = d.reshape(out, inner // QK4).T  # [K/32, N]
    mins = None if m is None else m.reshape(out, inner // QK4).T
    return _qtensor(qs, scales, mins, (inner, out), qtype)


def pack_q4_rows(raw: np.ndarray, shape: tuple[int, int],
                 qtype: GGMLType) -> QTensor:
    """GGUF Q4 payload of a row-gathered table [V, E]: qs [V, E//2]
    (block-local split-half along E), scales [V, E//32]."""
    v, e = shape
    q, d, m = _split_q4_records(raw, v * e, qtype)
    blocks = q.reshape(v, e // QK4, QK4)
    qs = (blocks[:, :, : QK4 // 2] | (blocks[:, :, QK4 // 2 :] << 4)).reshape(
        v, e // 2
    ).astype(np.uint8)
    mins = None if m is None else m.reshape(v, e // QK4)
    return _qtensor(qs, d.reshape(v, e // QK4), mins, (v, e), qtype)


def pack_q8_matmul(raw: np.ndarray, out_in_shape: tuple[int, int]) -> QTensor:
    """GGUF Q8_0 payload of an [out, in] weight -> contraction-major
    QTensor: int8 codes [K, N], scales [K/32, N]."""
    out, inner = out_in_shape
    q, d = _split_q8_records(raw, out * inner)
    return _qtensor(q.reshape(out, inner).T, d.reshape(out, inner // QK4).T,
                    None, (inner, out), GGMLType.Q8_0)


def pack_q8_rows(raw: np.ndarray, shape: tuple[int, int]) -> QTensor:
    """GGUF Q8_0 payload of a row-gathered table: qs int8 [V, E],
    scales [V, E//32]."""
    v, e = shape
    q, d = _split_q8_records(raw, v * e)
    return _qtensor(q.reshape(v, e), d.reshape(v, e // QK4), None, (v, e),
                    GGMLType.Q8_0)


def _unpack_block_local(qs: torch.Tensor) -> torch.Tensor:
    """packed [..., K//2, N] -> int32 q values [..., K, N]."""
    *lead, half_k, n = qs.shape
    b = qs.reshape(*lead, half_k * 2 // QK4, QK4 // 2, n).to(torch.int32)
    return torch.cat([b & 0x0F, b >> 4], dim=-2).reshape(*lead, half_k * 2, n)


def dequantize(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    """QTensor -> dense tensor in its logical layout, with the arithmetic
    in `dtype` (the JAX package's `dequantize`, bit for bit)."""
    if t.qtype == GGMLType.Q8_0:
        *lead, k, n = t.qs.shape
        qf = t.qs.to(dtype).reshape(*lead, k // QK4, QK4, n)
        scales = t.scales.reshape(*lead, k // QK4, 1, n).to(dtype)
        return (qf * scales).reshape(*lead, k, n)
    *lead, half_k, n = t.qs.shape
    k = half_k * 2
    qf = _unpack_block_local(t.qs).reshape(*lead, k // QK4, QK4, n).to(dtype)
    scales = t.scales.reshape(*lead, k // QK4, 1, n).to(dtype)
    if t.qtype == GGMLType.Q4_0:
        out = (qf - 8.0) * scales
    else:
        out = qf * scales + t.mins.reshape(*lead, k // QK4, 1, n).to(dtype)
    return out.reshape(*lead, k, n)


def gather_rows(t: QTensor, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Dequantized row gather from a row-major packed table [V, E]: gathers
    codes and scales, then dequantizes only the gathered rows."""
    v, e = t.shape
    nb = e // QK4
    if t.qtype == GGMLType.Q8_0:
        q = t.qs[ids].to(dtype)
        lead = q.shape[:-1]
        s = t.scales[ids][..., None].to(dtype)
        return (q.reshape(*lead, nb, QK4) * s).reshape(*lead, e)
    qs = t.qs[ids]
    lead = qs.shape[:-1]
    b = qs.reshape(*lead, nb, QK4 // 2).to(torch.int32)
    q = torch.cat([b & 0x0F, b >> 4], dim=-1).to(dtype)
    s = t.scales[ids][..., None].to(dtype)
    if t.qtype == GGMLType.Q4_0:
        out = (q - 8.0) * s
    else:
        out = q * s + t.mins[ids][..., None].to(dtype)
    return out.reshape(*lead, e)
