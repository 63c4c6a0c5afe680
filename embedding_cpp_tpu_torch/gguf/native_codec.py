"""ctypes binding to the C++ block codecs of `native/gguf/codec.cpp`, the
quantizer's multithreaded path.

The numpy codecs of `quant.py` are the reference; the two agree bit for
bit but for the sign of a zero: a Q4 code of 8 under a negative scale
dequantizes to -0.0 in numpy and to +0.0 here.  The library is the port's
own build (`utils/native_build.py`); where it cannot be built,
`available()` is false and the quantizer takes the numpy codecs.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils import native_build
from .constants import GGMLType, ggml_nbytes

_TYPE_CODE = {GGMLType.F32: 0, GGMLType.F16: 1, GGMLType.Q4_0: 2, GGMLType.Q4_1: 3,
              GGMLType.Q8_0: 8}

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = native_build.load("codec")
        f32p, u8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
        lib.tpuembed_quantize.restype = ctypes.c_int64
        lib.tpuembed_quantize.argtypes = [f32p, ctypes.c_int64, ctypes.c_int, u8p]
        lib.tpuembed_dequantize.restype = ctypes.c_int64
        lib.tpuembed_dequantize.argtypes = [u8p, ctypes.c_int, ctypes.c_int64, f32p]
        lib.tpuembed_requantize.restype = ctypes.c_int64
        lib.tpuembed_requantize.argtypes = [u8p, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                            u8p, ctypes.c_int]
        _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except ImportError:
        return False


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _raw_of(raw: np.ndarray, ggml_type: GGMLType, n_elements: int) -> np.ndarray:
    """The encoded bytes as a flat uint8 array, refused when shorter than
    n_elements need: the C side takes no length and would read past it."""
    raw = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
    need = ggml_nbytes(ggml_type, n_elements)
    if raw.size < need:
        raise ValueError(f"raw buffer too small for {n_elements} {ggml_type.name} "
                         f"elements: {raw.size} < {need} bytes")
    return raw


def quantize(x: np.ndarray, ggml_type: GGMLType) -> np.ndarray:
    """f32 values -> the encoded bytes of `ggml_type`."""
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    out = np.empty(ggml_nbytes(ggml_type, x.size), dtype=np.uint8)
    if lib.tpuembed_quantize(_f32(x), x.size, _TYPE_CODE[ggml_type], _u8(out)) < 0:
        raise ValueError(f"native quantize failed (n={x.size}, {ggml_type})")
    return out


def dequantize(raw: np.ndarray, ggml_type: GGMLType, n_elements: int) -> np.ndarray:
    """Encoded bytes -> n_elements f32 values."""
    lib = _load()
    raw = _raw_of(raw, ggml_type, n_elements)
    out = np.empty(n_elements, dtype=np.float32)
    if lib.tpuembed_dequantize(_u8(raw), _TYPE_CODE[ggml_type], n_elements, _f32(out)) < 0:
        raise ValueError(f"native dequantize failed ({ggml_type})")
    return out


def requantize(raw: np.ndarray, src_type: GGMLType, n_elements: int, dst_type: GGMLType,
               n_threads: int | None = None) -> np.ndarray:
    """src_type bytes -> dst_type bytes of the same n_elements values, on
    up to 8 threads."""
    lib = _load()
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    raw = _raw_of(raw, src_type, n_elements)
    out = np.empty(ggml_nbytes(dst_type, n_elements), dtype=np.uint8)
    if lib.tpuembed_requantize(_u8(raw), _TYPE_CODE[src_type], n_elements,
                               _TYPE_CODE[dst_type], _u8(out), n_threads) < 0:
        raise ValueError("native requantize failed")
    return out
