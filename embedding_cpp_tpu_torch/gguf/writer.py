"""GGUF v2 file writer (numpy).

The JAX package's `gguf/writer.py` format, byte for byte: the same kv
encoding (a value's type inferred with bool before int), the tensor
directory with offsets aligned to `alignment` (32 bytes unless the caller
gives the alignment of the file it copies), zero padding before the data
section and between tensors, and format version `GGUF_WRITE_VERSION`.
"""
from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_WRITE_VERSION,
    GGMLType,
    GGUFValueType,
    align_offset,
    ggml_nbytes,
)
from .reader import _SCALAR_FMT

_NUMPY_TO_GGML = {
    np.dtype(np.float32): GGMLType.F32,
    np.dtype(np.float16): GGMLType.F16,
    np.dtype(np.int8): GGMLType.I8,
    np.dtype(np.int16): GGMLType.I16,
    np.dtype(np.int32): GGMLType.I32,
}


class GGUFWriter:
    """Collect kv pairs and tensors, then write a GGUF v2 file."""

    def __init__(self, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.alignment = alignment
        self._kv: list[tuple[str, GGUFValueType, object]] = []
        # (name, ne in GGUF order, type, payload bytes)
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, np.ndarray]] = []

    # --- kv -----------------------------------------------------------------
    def add_kv(self, key: str, value, vtype: GGUFValueType | None = None) -> None:
        self._kv.append((key, self._infer_type(value) if vtype is None else vtype, value))

    def add_uint32(self, key: str, value: int) -> None:
        self.add_kv(key, int(value), GGUFValueType.UINT32)

    def add_float32(self, key: str, value: float) -> None:
        self.add_kv(key, float(value), GGUFValueType.FLOAT32)

    def add_string(self, key: str, value: str | bytes) -> None:
        self.add_kv(key, value, GGUFValueType.STRING)

    def add_bool(self, key: str, value: bool) -> None:
        self.add_kv(key, bool(value), GGUFValueType.BOOL)

    def add_array(self, key: str, value, elem_type: GGUFValueType) -> None:
        self.add_kv(key, (elem_type, list(value)), GGUFValueType.ARRAY)

    @staticmethod
    def _infer_type(value) -> GGUFValueType:
        if isinstance(value, bool):  # before int: bool is an int subclass
            return GGUFValueType.BOOL
        if isinstance(value, int):
            return GGUFValueType.UINT32 if value >= 0 else GGUFValueType.INT32
        if isinstance(value, float):
            return GGUFValueType.FLOAT32
        if isinstance(value, (str, bytes)):
            return GGUFValueType.STRING
        raise TypeError(f"cannot infer GGUF type for {type(value)}")

    # --- tensors ------------------------------------------------------------
    def add_tensor(self, name: str, array: np.ndarray) -> None:
        """An unquantized tensor (f32/f16/int), shape in numpy order."""
        array = np.ascontiguousarray(array)
        self._tensors.append((name, tuple(reversed(array.shape)), _NUMPY_TO_GGML[array.dtype],
                              array.view(np.uint8).reshape(-1)))

    def add_tensor_raw(self, name: str, shape: tuple[int, ...], ggml_type: GGMLType,
                       raw: np.ndarray) -> None:
        """Encoded payload bytes (Q4_0, Q8_0, ...), shape in numpy order."""
        expected = ggml_nbytes(ggml_type, int(np.prod(shape)) if shape else 1)
        raw = np.ascontiguousarray(raw, dtype=np.uint8).reshape(-1)
        if raw.nbytes != expected:
            raise ValueError(f"{name}: payload {raw.nbytes} B != expected {expected} B "
                             f"for {ggml_type.name} {shape}")
        self._tensors.append((name, tuple(reversed(shape)), ggml_type, raw))

    # --- serialization ------------------------------------------------------
    @staticmethod
    def _write_string(f: BinaryIO, s: str | bytes) -> None:
        raw = s.encode("utf-8") if isinstance(s, str) else s
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)

    def _write_value(self, f: BinaryIO, vtype: GGUFValueType, value) -> None:
        if vtype == GGUFValueType.STRING:
            self._write_string(f, value)
        elif vtype == GGUFValueType.ARRAY:
            elem_type, items = value
            f.write(struct.pack("<I", int(elem_type)))
            f.write(struct.pack("<Q", len(items)))
            for item in items:
                self._write_value(f, elem_type, item)
        else:
            f.write(struct.pack(_SCALAR_FMT[vtype], value))

    def write(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(GGUF_MAGIC)
            f.write(struct.pack("<I", GGUF_WRITE_VERSION))
            f.write(struct.pack("<Q", len(self._tensors)))
            f.write(struct.pack("<Q", len(self._kv)))
            for key, vtype, value in self._kv:
                self._write_string(f, key)
                f.write(struct.pack("<I", int(vtype)))
                self._write_value(f, vtype, value)
            # the directory, each offset aligned relative to the data section
            offsets, offset = [], 0
            for *_, raw in self._tensors:
                offset = align_offset(offset, self.alignment)
                offsets.append(offset)
                offset += raw.nbytes
            for (name, ne, ggml_type, _), off in zip(self._tensors, offsets):
                self._write_string(f, name)
                f.write(struct.pack("<I", len(ne)))
                for d in ne:
                    f.write(struct.pack("<Q", d))
                f.write(struct.pack("<I", int(ggml_type)))
                f.write(struct.pack("<Q", off))
            f.write(b"\x00" * (align_offset(f.tell(), self.alignment) - f.tell()))
            data_start = f.tell()
            for (*_, raw), off in zip(self._tensors, offsets):
                f.write(b"\x00" * (off - (f.tell() - data_start)))
                f.write(raw.tobytes())
