"""GGUF file reader (mmap + numpy).

Parses GGUF v1/v2/v3 little-endian files: the kv metadata section, the
tensor directory and zero-copy views of the tensor payloads — the same
parse as the JAX package's `gguf/reader.py`, which both packages' loaders
are held to.
"""
from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_SUPPORTED_VERSIONS,
    GGMLType,
    GGUFValueType,
    Keys,
    align_offset,
    ggml_nbytes,
)

_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


@dataclass(frozen=True)
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]  # numpy/HF order (reversed GGUF ne)
    ggml_type: GGMLType
    offset: int  # relative to the data section start
    n_elements: int
    nbytes: int


class GGUFReader:
    """Read-only, mmap-backed GGUF file."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._file = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._pos = 0
        self.kv: dict[str, object] = {}
        self.tensors: dict[str, GGUFTensorInfo] = {}
        self._parse()

    def _read(self, fmt: str):
        vals = struct.unpack_from(fmt, self._mm, self._pos)
        self._pos += struct.calcsize(fmt)
        return vals[0] if len(vals) == 1 else vals

    def _read_len(self) -> int:
        # v1 uses u32 lengths/counts everywhere; v2+ uses u64
        return self._read("<I" if self.version == 1 else "<Q")

    def _read_string(self) -> str:
        n = self._read_len()
        raw = self._mm[self._pos : self._pos + n]
        self._pos += n
        return raw.decode("utf-8", errors="replace")

    def _read_value(self, vtype: GGUFValueType):
        if vtype == GGUFValueType.STRING:
            return self._read_string()
        if vtype == GGUFValueType.ARRAY:
            elem_type = GGUFValueType(self._read("<I"))
            count = self._read_len()
            if elem_type == GGUFValueType.STRING:
                return [self._read_string() for _ in range(count)]
            if elem_type == GGUFValueType.ARRAY:
                return [self._read_value(elem_type) for _ in range(count)]
            fmt = _SCALAR_FMT[elem_type]
            arr = np.frombuffer(
                self._mm, dtype=np.dtype(fmt[1:]).newbyteorder("<"),
                count=count, offset=self._pos,
            ).copy()  # kv arrays outlive the mmap
            self._pos += struct.calcsize(fmt) * count
            return arr
        return self._read(_SCALAR_FMT[vtype])

    def _parse(self) -> None:
        magic = self._mm[0:4]
        if magic != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic {magic!r})")
        self._pos = 4
        self.version = self._read("<I")
        if self.version not in GGUF_SUPPORTED_VERSIONS:
            raise ValueError(f"{self.path}: unsupported GGUF version {self.version}")
        n_tensors = self._read_len()
        n_kv = self._read_len()
        for _ in range(n_kv):
            key = self._read_string()
            self.kv[key] = self._read_value(GGUFValueType(self._read("<I")))
        self.alignment = int(self.kv.get(Keys.ALIGNMENT, GGUF_DEFAULT_ALIGNMENT))
        for _ in range(n_tensors):
            name = self._read_string()
            n_dims = self._read("<I")
            ne = [self._read_len() for _ in range(n_dims)]
            ggml_type = GGMLType(self._read("<I"))
            offset = self._read("<Q")
            n_elements = int(np.prod(ne)) if ne else 1
            self.tensors[name] = GGUFTensorInfo(
                name=name, shape=tuple(reversed(ne)), ggml_type=ggml_type,
                offset=offset, n_elements=n_elements,
                nbytes=ggml_nbytes(ggml_type, n_elements),
            )
        self.data_start = align_offset(self._pos, self.alignment)

    def tensor_raw(self, name: str) -> np.ndarray:
        """Raw payload bytes of a tensor as a zero-copy uint8 view."""
        info = self.tensors[name]
        return np.frombuffer(
            self._mm, dtype=np.uint8, count=info.nbytes,
            offset=self.data_start + info.offset,
        )

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            # zero-copy tensor views are still alive; the mmap is released
            # when they are garbage-collected
            pass
        self._file.close()

    def __enter__(self) -> "GGUFReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
