"""JSON rendering of embedding matrices for the HTTP float mode
(`encoding_format: "float"`, the OpenAI default), by the C++ renderer of
`native/jsonfmt/jsonfmt.cpp`.

The renderer writes the whole `data` array in one call with
std::to_chars: the shortest text that reads back as the same f32, so every
value parses back bit-identical as float32, and a non-finite value is
written as `null`.  Where the library is not available (no compiler, or
a failed build), the array is rendered in Python (`json.dumps` of the f64
widening of each f32: the same values, longer text).  The library is the
port's own build (`utils/native_build.py`).
"""
from __future__ import annotations

import ctypes
import json

import numpy as np

from . import native_build

_lib = None
_lib_failed = False


def _load():
    """The library, or None where it cannot be built."""
    global _lib, _lib_failed
    if _lib is None and not _lib_failed:
        try:
            lib = native_build.load("jsonfmt")
        except ImportError:
            _lib_failed = True
            return None
        lib.tpuembed_json_embedding_data.restype = ctypes.c_int64
        lib.tpuembed_json_embedding_data.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64]
        lib.tpuembed_json_data_cap.restype = ctypes.c_int64
        lib.tpuembed_json_data_cap.argtypes = [ctypes.c_int64, ctypes.c_int64]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _py_embedding_data(vecs: np.ndarray, index_base: int = 0) -> bytes:
    return json.dumps(
        [{"object": "embedding", "index": index_base + i, "embedding": v.tolist()}
         for i, v in enumerate(vecs)],
        separators=(",", ":"),
    ).encode("utf-8")


def embedding_data_json(vecs: np.ndarray, index_base: int = 0) -> bytes:
    """[n, d] f32 -> the bytes of the OpenAI-style `data` array:
    `[{"object":"embedding","index":i,"embedding":[...]}, ...]`."""
    vecs = np.ascontiguousarray(vecs, dtype=np.float32)
    if vecs.ndim != 2:
        raise ValueError(f"expected [n, d] matrix, got shape {vecs.shape}")
    lib = _load()
    if lib is None or vecs.shape[1] == 0:
        return _py_embedding_data(vecs, index_base)
    n, d = vecs.shape
    cap = lib.tpuembed_json_data_cap(n, d)
    buf = ctypes.create_string_buffer(cap)
    written = lib.tpuembed_json_embedding_data(
        vecs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, d, index_base, buf, cap)
    if written < 0:  # the library refused the size: render in Python
        return _py_embedding_data(vecs, index_base)
    return buf.raw[:written]
