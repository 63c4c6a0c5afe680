"""Tokenizer subsystem over a GGUF `blob.tokenizer.json` and the
reference's CLS/SEP framing of single texts and pairs.

Backends, each loading the same json:
- "native": the C++ engines of `native/tokenizer` through ctypes
  (`native.py`; the library builds at first use);
- "hf": the HF `tokenizers` library (`hf.py`);
- "python": the pure-Python engines, by the json's model.type: WordPiece
  (the BERT family), byte-level BPE (RoBERTa, ModernBERT) and
  SentencePiece Unigram (DeBERTa-v3, XLM-R, ALBERT); other types raise.
`load_tokenizer(blob, "auto")` takes the first of native > hf > python
that accepts the json: the native engines refuse some Unigram shapes, and
those take the next backend.
"""
from __future__ import annotations

import json as _json

from .base import SpecialIds, frame_ids, frame_pair_ids
from .bpe import ByteLevelBPETokenizer
from .unigram import UnigramTokenizer
from .wordpiece import WordPieceTokenizer

__all__ = [
    "ByteLevelBPETokenizer",
    "SpecialIds",
    "UnigramTokenizer",
    "WordPieceTokenizer",
    "frame_ids",
    "frame_pair_ids",
    "load_tokenizer",
]

_ENGINES = {"BPE": ByteLevelBPETokenizer, "Unigram": UnigramTokenizer,
            "WordPiece": WordPieceTokenizer}


def load_tokenizer(tokenizer_json: bytes | str, backend: str = "auto"):
    """The tokenizer for a tokenizer.json from `backend` ("auto", "native",
    "hf" or "python").  A named backend raises when it cannot load the
    json; "auto" falls through to the next one."""
    if backend not in ("auto", "native", "hf", "python"):
        raise ValueError(f"unknown tokenizer backend {backend!r}")
    if backend in ("auto", "native"):
        try:
            from .native import NativeTokenizer

            return NativeTokenizer(tokenizer_json)
        except Exception:
            if backend == "native":
                raise
    if backend in ("auto", "hf"):
        try:
            from .hf import HFTokenizer

            return HFTokenizer(tokenizer_json)
        except Exception:
            if backend == "hf":
                raise
    text = (tokenizer_json.decode("utf-8") if isinstance(tokenizer_json, bytes)
            else tokenizer_json)
    mtype = (_json.loads(text).get("model") or {}).get("type")
    if mtype not in _ENGINES:
        raise ValueError(f"unsupported tokenizer model type: {mtype!r}")
    return _ENGINES[mtype](text)
