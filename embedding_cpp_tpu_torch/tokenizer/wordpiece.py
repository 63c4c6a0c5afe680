"""Pure-Python tokenizer.json WordPiece engine.

The HF `tokenizers` pipeline subset that BERT-family tokenizer.json files
use, as the JAX package's `tokenizer/wordpiece.py` implements it:
BertNormalizer (clean_text, CJK isolation, accent stripping, lowercasing),
BertPreTokenizer (whitespace + punctuation splits), and greedy
longest-match WordPiece with a continuation prefix.
"""
from __future__ import annotations

import json
import unicodedata
from typing import Sequence

from .base import parse_added_tokens, split_added_tokens

# HF WordPiece decoder cleanup=True rules, applied per piece (a piece is
# " " + token or a "##"-stripped continuation), as the Rust decoder does
_WP_CLEANUP = (
    (" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
    (" n't", "n't"), (" 'm", "'m"), (" do not", " don't"), (" 's", "'s"),
    (" 've", "'ve"), (" 're", "'re"),
)
# CJK Unified Ideograph ranges (BERT's definition)
_CJK_RANGES = (
    (0x4E00, 0x9FFF),
    (0x3400, 0x4DBF),
    (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F),
    (0x2B740, 0x2B81F),
    (0x2B820, 0x2CEAF),
    (0xF900, 0xFAFF),
    (0x2F800, 0x2FA1F),
)


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _is_whitespace(ch: str) -> bool:
    return ch in (" ", "\t", "\n", "\r") or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class BertNormalizer:
    """clean_text -> handle_chinese_chars -> strip_accents (NFD, drop Mn)
    -> lowercase.  strip_accents=None follows the lowercase flag."""

    def __init__(self, clean_text: bool = True, handle_chinese_chars: bool = True,
                 strip_accents: bool | None = None, lowercase: bool = True):
        self.clean_text = clean_text
        self.handle_chinese_chars = handle_chinese_chars
        self.strip_accents = lowercase if strip_accents is None else strip_accents
        self.lowercase = lowercase

    def normalize(self, text: str) -> str:
        if self.clean_text:
            text = "".join(
                " " if _is_whitespace(ch) else ch
                for ch in text
                if not (ch == "\0" or ch == "�" or _is_control(ch))
            )
        if self.handle_chinese_chars:
            text = "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)
        if self.strip_accents:
            text = "".join(
                ch for ch in unicodedata.normalize("NFD", text)
                if unicodedata.category(ch) != "Mn"
            )
        if self.lowercase:
            text = text.lower()
        return text


def pre_tokenize(text: str) -> list[str]:
    """BertPreTokenizer: whitespace split + punctuation isolation."""
    words: list[str] = []
    current: list[str] = []
    for ch in text:
        if _is_whitespace(ch) or _is_punctuation(ch):
            if current:
                words.append("".join(current))
                current = []
            if not _is_whitespace(ch):
                words.append(ch)
        else:
            current.append(ch)
    if current:
        words.append("".join(current))
    return words


class WordPieceModel:
    """Greedy longest-match-first WordPiece."""

    def __init__(self, vocab: dict[str, int], unk_token: str = "[UNK]",
                 continuing_subword_prefix: str = "##",
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_id = vocab[unk_token]
        self.prefix = continuing_subword_prefix
        self.max_chars = max_input_chars_per_word

    def tokenize(self, word: str) -> list[int]:
        if len(word) > self.max_chars:
            return [self.unk_id]
        ids: list[int] = []
        start, n = 0, len(word)
        while start < n:
            end = n
            cur_id = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = self.prefix + sub
                cur_id = self.vocab.get(sub)
                if cur_id is not None:
                    break
                end -= 1
            if cur_id is None:
                return [self.unk_id]  # the whole word becomes UNK
            ids.append(cur_id)
            start = end
        return ids


class WordPieceTokenizer:
    """The full pipeline over a tokenizer.json blob (BertNormalizer,
    BertPreTokenizer, WordPiece); other component types raise."""

    def __init__(self, tokenizer_json: bytes | str):
        if isinstance(tokenizer_json, bytes):
            tokenizer_json = tokenizer_json.decode("utf-8")
        spec = json.loads(tokenizer_json)
        model = spec.get("model") or {}
        if model.get("type") != "WordPiece":
            raise ValueError(f"unsupported model type: {model.get('type')}")
        self.model = WordPieceModel(
            vocab=model["vocab"],
            unk_token=model.get("unk_token", "[UNK]"),
            continuing_subword_prefix=model.get("continuing_subword_prefix", "##"),
            max_input_chars_per_word=model.get("max_input_chars_per_word", 100),
        )
        norm = spec.get("normalizer")
        if norm is None:
            self.normalizer = None
        elif norm.get("type") == "BertNormalizer":
            self.normalizer = BertNormalizer(
                clean_text=norm.get("clean_text", True),
                handle_chinese_chars=norm.get("handle_chinese_chars", True),
                strip_accents=norm.get("strip_accents"),
                lowercase=norm.get("lowercase", True),
            )
        else:
            raise ValueError(f"unsupported normalizer: {norm.get('type')}")
        pre = spec.get("pre_tokenizer")
        if pre is not None and pre.get("type") != "BertPreTokenizer":
            raise ValueError(f"unsupported pre_tokenizer: {pre.get('type')}")
        # added tokens match on raw text before normalization
        self._added = parse_added_tokens(spec)
        self._id_to_token = {i: t for t, i in self.model.vocab.items()}
        for t in self._added:
            self._id_to_token.setdefault(t["id"], t["content"])

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for seg, seg_id in split_added_tokens(text, self._added):
            if seg_id is not None:
                ids.append(seg_id)
                continue
            if self.normalizer is not None:
                seg = self.normalizer.normalize(seg)
            for word in pre_tokenize(seg):
                ids.extend(self.model.tokenize(word))
        return ids

    def encode_batch(self, texts: Sequence[str]) -> list[list[int]]:
        return [self.encode(t) for t in texts]

    def id_to_token(self, token_id: int) -> str:
        return self._id_to_token.get(token_id, "")

    def decode(self, ids) -> str:
        """Ids -> text (`decode_wordpiece`)."""
        return decode_wordpiece(self.id_to_token, ids)


def decode_wordpiece(id_to_token, ids) -> str:
    """Ids -> text with the WordPiece decoder's rules: "##" continuations
    fuse onto the previous token, other tokens join with a space, and the
    cleanup rules de-space punctuation piece by piece."""
    pieces: list[str] = []
    for i in ids:
        tok = id_to_token(int(i))
        if not tok:
            continue
        piece = tok if not pieces else tok[2:] if tok.startswith("##") else " " + tok
        for a, b in _WP_CLEANUP:
            piece = piece.replace(a, b)
        pieces.append(piece)
    return "".join(pieces)
