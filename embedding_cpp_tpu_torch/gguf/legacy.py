"""The legacy pre-GGUF `ggml` model format (magic 0x67676D6C): read, write,
upgrade to GGUF.

The JAX package's `gguf/legacy.py` format: int32 magic, eight int32 hparams
(vocab_size, max_position_embeddings, hidden_size, intermediate_size,
num_attention_heads, num_hidden_layers, type_vocab_size, ftype), the whole
tokenizer.json (int32 length + bytes), vocab_size length-prefixed token
strings, then each tensor as (n_dims, name_len, dtype) int32s, its dims in
reversed (ggml ne) order, its name and its raw data.  ftype 0 = f32, 1 = f16:
the format was never written quantized.
"""
from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass

import numpy as np

from ..models.config import BertConfig

LEGACY_MAGIC = 0x67676D6C  # "ggml"

_DTYPE = {0: np.float32, 1: np.float16}
_DTYPE_CODE = {np.dtype(np.float32): 0, np.dtype(np.float16): 1}


@dataclass
class LegacyModel:
    config: BertConfig
    ftype: int  # 0 = f32, 1 = f16
    tokenizer_json: bytes
    vocab: list[bytes]
    tensors: dict[str, np.ndarray]


def _read_i32(f) -> int:
    raw = f.read(4)
    if len(raw) != 4:
        raise EOFError("truncated legacy ggml file")
    return struct.unpack("<i", raw)[0]


def _read_exact(f, n: int, what: str) -> bytes:
    raw = f.read(n)
    if len(raw) != n:
        raise EOFError(f"truncated {what}")
    return raw


def _read_tensor(f, path) -> tuple[str, np.ndarray] | None:
    """One tensor record, or None at the end of the file."""
    head = f.read(12)
    if not head:
        return None
    if len(head) != 12:
        raise EOFError("truncated tensor header")
    n_dims, name_len, dtype_code = struct.unpack("<iii", head)
    if not 1 <= n_dims <= 4:
        raise ValueError(f"{path}: bad tensor rank {n_dims}")
    if not 0 < name_len < 1 << 16:
        raise ValueError(f"{path}: bad tensor name length {name_len}")
    if dtype_code not in _DTYPE:
        raise ValueError(f"{path}: unsupported tensor dtype {dtype_code}")
    ne = struct.unpack(f"<{n_dims}i", f.read(4 * n_dims))
    if any(not 0 < d < 1 << 28 for d in ne):
        raise ValueError(f"{path}: bad tensor dims {ne}")
    name = f.read(name_len).decode("utf-8")
    shape = tuple(reversed(ne))
    count = int(np.prod(shape))
    data = np.fromfile(f, dtype=_DTYPE[dtype_code], count=count)
    if data.size != count:
        raise EOFError(f"truncated tensor data for {name}")
    return name, data.reshape(shape)


def read_legacy_bin(path: str | os.PathLike) -> LegacyModel:
    """A legacy ggml-model*.bin -> hparams, tokenizer, vocab and tensors."""
    with open(path, "rb") as f:
        magic = _read_i32(f)
        if magic != LEGACY_MAGIC:
            raise ValueError(f"{path}: bad magic 0x{magic & 0xFFFFFFFF:08x} (want "
                             f"0x{LEGACY_MAGIC:08x} 'ggml'; GGUF files start with 'GGUF')")
        n_vocab, n_ctx, n_embd, n_ff, n_head, n_layer, _, ftype = (
            _read_i32(f) for _ in range(8))  # the 7th, type_vocab_size, is always 2
        if ftype not in _DTYPE:
            raise ValueError(f"{path}: unsupported legacy ftype {ftype}")
        if not (0 < n_vocab < 1 << 24) or not (0 < n_ctx <= 1 << 20):
            raise ValueError(f"{path}: implausible hparams (n_vocab={n_vocab}, n_ctx={n_ctx})")
        blob_len = _read_i32(f)
        if not 0 <= blob_len < 1 << 30:
            raise ValueError(f"{path}: bad tokenizer blob length {blob_len}")
        tokenizer_json = _read_exact(f, blob_len, "tokenizer.json blob")
        vocab = []
        for _ in range(n_vocab):
            tok_len = _read_i32(f)
            if not 0 <= tok_len < 1 << 20:
                raise ValueError(f"{path}: bad vocab token length {tok_len}")
            vocab.append(_read_exact(f, tok_len, "vocab entry"))
        tensors: dict[str, np.ndarray] = {}
        while (item := _read_tensor(f, path)) is not None:
            tensors[item[0]] = item[1]
    config = BertConfig(n_vocab=n_vocab, n_ctx=n_ctx, n_embd=n_embd, n_layer=n_layer,
                        n_head=n_head, n_ff=n_ff)
    return LegacyModel(config=config, ftype=ftype, tokenizer_json=tokenizer_json,
                       vocab=vocab, tensors=tensors)


def write_legacy_bin(path: str | os.PathLike, config: BertConfig,
                     state_dict: dict[str, np.ndarray], tokenizer_json: bytes,
                     ftype: str = "f16") -> None:
    """Write the legacy format: 2-D `.weight` tensors in f16 when ftype is
    f16, everything else f32; the tensors of `schema.SKIPPED_TENSORS`
    left out."""
    from ..models.schema import SKIPPED_TENSORS

    code = {"f32": 0, "f16": 1}.get(ftype)
    if code is None:
        raise ValueError(f"legacy format supports f32/f16 only, got {ftype!r}")
    if config.dense_out:
        raise ValueError("the legacy .bin format has no dense-head hparams; a Dense "
                         "projection model would silently lose its head — write GGUF instead")
    tok = json.loads(tokenizer_json)
    vocab_map = dict(tok["model"]["vocab"])
    for added in tok.get("added_tokens", []):
        vocab_map.setdefault(added["content"], int(added["id"]))
    id_to_token = {int(i): t for t, i in vocab_map.items()}
    with open(path, "wb") as f:
        f.write(struct.pack("<i", LEGACY_MAGIC))
        for v in (config.n_vocab, config.n_ctx, config.n_embd, config.n_ff, config.n_head,
                  config.n_layer, 2, code):
            f.write(struct.pack("<i", v))
        f.write(struct.pack("<i", len(tokenizer_json)))
        f.write(tokenizer_json)
        for i in range(config.n_vocab):
            if i not in id_to_token:
                raise ValueError(f"vocab has no token for id {i}")
            raw = id_to_token[i].encode("utf-8")
            f.write(struct.pack("<i", len(raw)))
            f.write(raw)
        for name, data in state_dict.items():
            if name in SKIPPED_TENSORS:
                continue
            arr = np.squeeze(np.ascontiguousarray(np.asarray(data), np.float32))
            if code == 1 and name.endswith(".weight") and arr.ndim == 2:
                arr = arr.astype(np.float16)
            raw_name = name.encode("utf-8")
            f.write(struct.pack("<iii", arr.ndim, len(raw_name), _DTYPE_CODE[arr.dtype]))
            for d in reversed(arr.shape):
                f.write(struct.pack("<i", d))
            f.write(raw_name)
            arr.tofile(f)


def upgrade_legacy_bin(src: str | os.PathLike, dst: str | os.PathLike,
                       ftype: str | None = None) -> None:
    """Legacy .bin -> GGUF, keeping the file's dtype, or at `ftype` (f32 /
    f16 / q4_0 / q4_1 / q8_0)."""
    from ..models.convert import FTYPE_NAMES, write_bert_gguf

    m = read_legacy_bin(src)
    if ftype is None:
        ftype = "f16" if m.ftype == 1 else "f32"
    write_bert_gguf(dst, m.config, m.tensors, m.tokenizer_json, FTYPE_NAMES[ftype])
