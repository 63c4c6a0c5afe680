"""A minimal GGUF v3 writer, the benchmark's own (the published format:
magic, version, tensor and kv counts, the kv section, the tensor directory
with offsets aligned to 32 bytes, then the data section).  The benchmark
writes the model file a user would download and loads it through the
port's `Engine.from_gguf`, so the file, and not the program, is the input
that both the program and the reference are given."""
from __future__ import annotations

import struct

import numpy as np

ALIGN = 32
# GGUF value types
U32, F32, BOOL, STRING, ARRAY = 4, 6, 7, 8, 9
# ggml tensor types
GGML_F32, GGML_Q4_0, GGML_Q8_0 = 0, 2, 8
# general.file_type of a file whose matrices are Q4_0 / Q8_0
FILE_TYPE = {"q4_0": 2, "q8_0": 7}
GGML_TYPE = {"q4_0": GGML_Q4_0, "q8_0": GGML_Q8_0}

_SCALAR = {U32: "<I", F32: "<f", BOOL: "<?"}


def _string(s: str | bytes) -> bytes:
    raw = s.encode("utf-8") if isinstance(s, str) else s
    return struct.pack("<Q", len(raw)) + raw


def _value(vtype: int, value) -> bytes:
    if vtype == STRING:
        return _string(value)
    if vtype == ARRAY:
        etype, items = value
        head = struct.pack("<IQ", etype, len(items))
        if etype == STRING:
            return head + b"".join(_string(x) for x in items)
        return head + b"".join(struct.pack(_SCALAR[etype], x) for x in items)
    return struct.pack(_SCALAR[vtype], value)


def write_gguf(path: str, kv: list[tuple[str, int, object]],
               tensors: list[tuple[str, tuple[int, ...], int, np.ndarray]]) -> int:
    """Write kv [(key, type, value)] and tensors [(name, numpy-order shape,
    ggml type, payload bytes)] to `path`; returns the bytes written."""
    offsets, off = [], 0
    for *_, raw in tensors:
        off = -(-off // ALIGN) * ALIGN
        offsets.append(off)
        off += raw.nbytes
    head = [b"GGUF", struct.pack("<IQQ", 3, len(tensors), len(kv))]
    for key, vtype, value in kv:
        head += [_string(key), struct.pack("<I", vtype), _value(vtype, value)]
    for (name, shape, gtype, _), o in zip(tensors, offsets):
        dims = tuple(reversed(shape))
        head += [_string(name), struct.pack("<I", len(dims)),
                 struct.pack(f"<{len(dims)}Q", *dims), struct.pack("<IQ", gtype, o)]
    head = b"".join(head)
    pad = -len(head) % ALIGN
    written = 0
    with open(path, "wb") as f:
        f.write(head + b"\0" * pad)
        written += len(head) + pad
        for (*_, raw), o in zip(tensors, offsets):
            gap = o - (written - len(head) - pad)
            f.write(b"\0" * gap)
            f.write(memoryview(np.ascontiguousarray(raw)).cast("B"))
            written += gap + raw.nbytes
    return written
