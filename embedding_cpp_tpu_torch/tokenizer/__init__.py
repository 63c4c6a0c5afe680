"""Tokenizer subsystem: the pure-Python WordPiece engine over a GGUF
`blob.tokenizer.json`, and the reference's CLS/SEP framing.  Only
WordPiece jsons are served so far; other model types raise."""
from .base import SpecialIds, frame_ids
from .wordpiece import WordPieceTokenizer

__all__ = ["SpecialIds", "WordPieceTokenizer", "frame_ids"]
