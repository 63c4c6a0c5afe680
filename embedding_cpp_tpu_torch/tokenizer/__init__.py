"""Tokenizer subsystem: pure-Python engines over a GGUF
`blob.tokenizer.json` (WordPiece for the BERT family, byte-level BPE for
RoBERTa/ModernBERT, SentencePiece Unigram for DeBERTa-v3) and the
reference's CLS/SEP framing of single texts and pairs.  `load_tokenizer`
dispatches on the json's model.type; other model types raise."""
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


def load_tokenizer(tokenizer_json: bytes | str):
    """The engine for a tokenizer.json, by model.type."""
    text = (tokenizer_json.decode("utf-8") if isinstance(tokenizer_json, bytes)
            else tokenizer_json)
    mtype = (_json.loads(text).get("model") or {}).get("type")
    if mtype not in _ENGINES:
        raise ValueError(f"unsupported tokenizer model type: {mtype!r}")
    return _ENGINES[mtype](text)
