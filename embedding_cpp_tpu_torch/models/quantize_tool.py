"""GGUF -> GGUF requantization: the JAX package's `quantize_gguf`.

- every kv pair is copied with its type, `general.file_type` set to the
  target;
- a tensor is converted iff its name ends in "weight", it is 2-D and, for
  a block type, its contraction axis is a whole number of blocks; one that
  is quantized or f16 is dequantized to f32 first;
- every other tensor passes through as it is;
- a 16-bin histogram of the codes written and the sizes are reported.

A conversion runs the C++ codec (`gguf/native_codec.py`, multithreaded)
where it is available, as the JAX tool does, else the numpy block codecs
of `gguf/quant.py`; given the same codec, the two tools write the same
bytes.
"""
from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np

from ..gguf.constants import FTYPE_TO_GGML, QK4, GGMLType, GGUFFileType, GGUFValueType, Keys
from ..gguf.quant import dequantize, quantize, unpack_nibbles
from ..gguf.reader import GGUFReader
from ..gguf.writer import GGUFWriter
from .params import FTYPE_NAMES

_BLOCK_TYPES = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q8_0)
# numpy kind of a kv array -> its GGUF element type
_ARRAY_TYPES = {"f": GGUFValueType.FLOAT32, "i": GGUFValueType.INT32, "u": GGUFValueType.UINT32}


@dataclass
class QuantizeStats:
    n_quantized: int = 0
    n_kept: int = 0
    total_in_bytes: int = 0
    total_out_bytes: int = 0
    hist_all: np.ndarray = field(default_factory=lambda: np.zeros(16, np.int64))


def _kv_type_of(value) -> GGUFValueType | None:
    if isinstance(value, bool):
        return GGUFValueType.BOOL
    if isinstance(value, int):
        return GGUFValueType.UINT32 if 0 <= value < 2**32 else GGUFValueType.INT64
    if isinstance(value, float):
        return GGUFValueType.FLOAT32
    if isinstance(value, (str, bytes)):
        return GGUFValueType.STRING
    return None


def _copy_kv(reader: GGUFReader, writer: GGUFWriter, ftype: GGUFFileType) -> None:
    for key, value in reader.kv.items():
        if key == Keys.FILE_TYPE:
            continue
        if isinstance(value, list):  # a string array
            writer.add_array(key, value, GGUFValueType.STRING)
        elif isinstance(value, np.ndarray):
            writer.add_array(key, [v.item() for v in value], _ARRAY_TYPES[value.dtype.kind])
        else:
            t = _kv_type_of(value)
            if t is None:
                raise TypeError(f"cannot copy kv {key!r} of type {type(value)}")
            writer.add_kv(key, value, t)
    writer.add_uint32(Keys.FILE_TYPE, int(ftype))


def _q_histogram(raw: np.ndarray, qtype: GGMLType) -> np.ndarray:
    """16-bin histogram of the codes: one bin per nibble (Q4), or the int8
    range folded into 16 even bins, (q + 128) >> 4 (Q8_0)."""
    rec = np.frombuffer(np.ascontiguousarray(raw), dtype=np.uint8)
    if qtype == GGMLType.Q8_0:
        q = rec.reshape(-1, 34)[:, 2:].view(np.int8)
        return np.bincount(((q.astype(np.int32) + 128) >> 4).reshape(-1),
                           minlength=16).astype(np.int64)
    rec_bytes, head = (18, 2) if qtype == GGMLType.Q4_0 else (20, 4)
    q = unpack_nibbles(rec.reshape(-1, rec_bytes)[:, head:])
    return np.bincount(q.reshape(-1), minlength=16).astype(np.int64)


def _eligible(name: str, shape: tuple, target: GGMLType) -> bool:
    if not (name.endswith("weight") and len(shape) == 2):
        return False
    return target not in _BLOCK_TYPES or shape[-1] % QK4 == 0


def _convert(raw, src_type: GGMLType, n_elements: int, target: GGMLType) -> np.ndarray:
    """One tensor's bytes at `target`, by the native codec where it is
    available."""
    from ..gguf import native_codec

    if native_codec.available():
        return native_codec.requantize(raw, src_type, n_elements, target)
    return quantize(dequantize(raw, src_type, n_elements), target)


def quantize_gguf(in_path: str, out_path: str, ftype: GGUFFileType | str,
                  verbose: bool = True) -> QuantizeStats:
    """Rewrite `in_path` at `ftype` ("q4_0" | "q4_1" | "q8_0" | "f16" |
    "f32", or a GGUFFileType) into `out_path`."""
    if isinstance(ftype, str):
        ftype = FTYPE_NAMES[ftype]
    target = FTYPE_TO_GGML[ftype]
    stats = QuantizeStats()
    t0 = time.time()
    with GGUFReader(in_path) as r:
        w = GGUFWriter(alignment=r.alignment)
        _copy_kv(r, w, ftype)
        for name, info in r.tensors.items():
            raw = r.tensor_raw(name)
            stats.total_in_bytes += info.nbytes
            if not (_eligible(name, info.shape, target) and info.ggml_type != target):
                w.add_tensor_raw(name, info.shape, info.ggml_type, np.asarray(raw))
                stats.n_kept += 1
                stats.total_out_bytes += info.nbytes
                continue
            out = _convert(raw, info.ggml_type, info.n_elements, target)
            if target == GGMLType.F16:
                w.add_tensor(name, out.view(np.float16).reshape(info.shape))
            else:
                w.add_tensor_raw(name, info.shape, target, out)
                if target in _BLOCK_TYPES:
                    stats.hist_all += _q_histogram(out, target)
            stats.n_quantized += 1
            stats.total_out_bytes += out.nbytes
            if verbose:
                print(f"{name:60s} {info.ggml_type.name:5s} -> {target.name:5s}"
                      f" {info.nbytes / 1e6:8.2f} MB -> {out.nbytes / 1e6:8.2f} MB",
                      file=sys.stderr)
        w.write(out_path)
    if verbose:
        print(f"quantized {stats.n_quantized} tensors, kept {stats.n_kept}; "
              f"{stats.total_in_bytes / 1e6:.2f} MB -> {stats.total_out_bytes / 1e6:.2f} MB "
              f"in {time.time() - t0:.2f}s", file=sys.stderr)
        if stats.hist_all.sum():
            h = stats.hist_all / stats.hist_all.sum()
            print("hist:", " ".join(f"{x:.3f}" for x in h), file=sys.stderr)
    return stats
