"""Tokenizer subsystem: pure-Python engines over a GGUF
`blob.tokenizer.json` (WordPiece for the BERT family, byte-level BPE for
RoBERTa/ModernBERT) and the reference's CLS/SEP framing.  `load_tokenizer`
dispatches on the json's model.type; other model types raise."""
from __future__ import annotations

import json as _json

from .base import SpecialIds, frame_ids
from .bpe import ByteLevelBPETokenizer
from .wordpiece import WordPieceTokenizer

__all__ = [
    "ByteLevelBPETokenizer",
    "SpecialIds",
    "WordPieceTokenizer",
    "frame_ids",
    "load_tokenizer",
]


def load_tokenizer(tokenizer_json: bytes | str):
    """The engine for a tokenizer.json: BPE or WordPiece by model.type."""
    text = (tokenizer_json.decode("utf-8") if isinstance(tokenizer_json, bytes)
            else tokenizer_json)
    mtype = (_json.loads(text).get("model") or {}).get("type")
    if mtype == "BPE":
        return ByteLevelBPETokenizer(text)
    if mtype == "WordPiece":
        return WordPieceTokenizer(text)
    raise ValueError(f"unsupported tokenizer model type: {mtype!r}")
