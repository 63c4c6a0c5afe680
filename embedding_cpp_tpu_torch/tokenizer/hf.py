"""Tokenizer backend on the HF `tokenizers` library (Rust, in process),
loaded from the GGUF's `tokenizer.json` blob.  Template special tokens,
padding and truncation are switched off: the engine frames, pads and cuts
the ids itself.  `tokenizers` is imported when a tokenizer is built."""
from __future__ import annotations

from typing import Sequence


class HFTokenizer:
    def __init__(self, tokenizer_json: bytes | str):
        from tokenizers import Tokenizer

        if isinstance(tokenizer_json, bytes):
            tokenizer_json = tokenizer_json.decode("utf-8")
        self._tok = Tokenizer.from_str(tokenizer_json)
        self._tok.no_padding()
        self._tok.no_truncation()

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def encode_batch(self, texts: Sequence[str]) -> list[list[int]]:
        return [e.ids for e in self._tok.encode_batch(list(texts), add_special_tokens=False)]

    def id_to_token(self, token_id: int) -> str:
        return self._tok.id_to_token(int(token_id)) or ""

    def decode(self, ids) -> str:
        return self._tok.decode([int(i) for i in ids], skip_special_tokens=False)

    def token_to_id(self, token: str) -> int | None:
        return self._tok.token_to_id(token)
