"""Pure-Python tokenizer.json byte-level BPE engine (no Rust, no HF).

A copy of the JAX package's `tokenizer/bpe.py`, which this package may not
import: the RoBERTa/GPT-2/ModernBERT tokenizer family.  ByteLevel
pre-tokenization (the GPT-2 split pattern + the bytes->printable-unicode
remap) followed by greedy rank-ordered BPE merges.

The split pattern implemented as a hand-rolled scanner (Python `re` has no
\\p classes):

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+
    |\\s+(?!\\S)|\\s+

Notable consequences reproduced here: a single space fuses onto the next
word (" world" is one pre-token); runs of whitespace before a token leave
exactly one space for it (`\\s+(?!\\S)` backtracks one); contractions split
case-sensitively on the straight apostrophe only.
"""
from __future__ import annotations

import json
import unicodedata
from functools import lru_cache
from typing import Sequence

from .base import parse_added_tokens, split_added_tokens


@lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable-unicode-char map: the printable
    latin-1 ranges map to themselves, the other 68 bytes map to U+0100+n."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAC + 1))
        + list(range(0xAE, 0xFF + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


# regex \s (fancy_regex / Unicode): White_Space property.  The Zs category
# plus the non-Zs whitespace code points.
_WS_EXTRA = frozenset("\t\n\x0b\x0c\r\x1c\x1d\x1e\x1f\x85")


def _is_space(ch: str) -> bool:
    return ch in _WS_EXTRA or unicodedata.category(ch) == "Zs"


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def gpt2_split(text: str) -> list[str]:
    """The GPT-2/RoBERTa ByteLevel split pattern as a scanner."""
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        # 1. contractions (literal, case-sensitive)
        matched = False
        if text[i] == "'":
            for c in _CONTRACTIONS:
                if text.startswith(c, i):
                    out.append(c)
                    i += len(c)
                    matched = True
                    break
        if matched:
            continue
        # ` ?` of alternatives 2-4: one literal space (U+0020 only)
        j = i + 1 if text[i] == " " else i
        if j < n and _is_letter(text[j]):
            k = j + 1
            while k < n and _is_letter(text[k]):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        if j < n and _is_number(text[j]):
            k = j + 1
            while k < n and _is_number(text[k]):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        if j < n and not (
            _is_space(text[j]) or _is_letter(text[j]) or _is_number(text[j])
        ):
            k = j + 1
            while k < n and not (
                _is_space(text[k]) or _is_letter(text[k]) or _is_number(text[k])
            ):
                k += 1
            out.append(text[i:k])
            i = k
            continue
        # 5./6. whitespace runs: `\s+(?!\S)` leaves one char for the next
        # token's ` ?` when the run precedes a non-space; else `\s+` all
        if _is_space(text[i]):
            k = i + 1
            while k < n and _is_space(text[k]):
                k += 1
            if k < n and k - i > 1:
                out.append(text[i : k - 1])
                i = k - 1
            else:
                out.append(text[i:k])
                i = k
            continue
        # lone space fell through the letter/number/other branches (the
        # ` ?` consumed it but nothing followed): emit it as whitespace
        out.append(text[i])
        i += 1
    return out


class BpeModel:
    """Greedy rank-ordered BPE over byte-mapped words."""

    def __init__(
        self,
        vocab: dict[str, int],
        merges: Sequence[str | Sequence[str]],
        unk_token: str | None = None,
    ):
        self.vocab = vocab
        self.unk_id = vocab.get(unk_token) if unk_token else None
        self.ranks: dict[tuple[str, str], int] = {}
        for rank, m in enumerate(merges):
            # tokenizer.json serializes merges as "a b" strings (or [a, b]
            # pairs in newer versions)
            if isinstance(m, str):
                a, _, b = m.partition(" ")
            else:
                a, b = m
            self.ranks[(a, b)] = rank
        self._cache: dict[str, list[int]] = {}

    def _merge_word(self, word: str) -> list[str]:
        symbols = list(word)
        if len(symbols) < 2:
            return symbols
        while True:
            best_rank = None
            best_pair = None
            for idx in range(len(symbols) - 1):
                r = self.ranks.get((symbols[idx], symbols[idx + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_pair = (symbols[idx], symbols[idx + 1])
            if best_pair is None:
                return symbols
            a, b = best_pair
            # merge every occurrence of this exact PAIR left-to-right (not
            # any adjacent pair whose concatenation happens to match)
            out: list[str] = []
            idx = 0
            while idx < len(symbols):
                if (
                    idx < len(symbols) - 1
                    and symbols[idx] == a
                    and symbols[idx + 1] == b
                ):
                    out.append(a + b)
                    idx += 2
                else:
                    out.append(symbols[idx])
                    idx += 1
            symbols = out
            if len(symbols) < 2:
                return symbols

    def tokenize(self, word: str) -> list[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        ids: list[int] = []
        for sym in self._merge_word(word):
            found = self.vocab.get(sym)
            if found is not None:
                ids.append(found)
            elif self.unk_id is not None:
                ids.append(self.unk_id)
            # no unk configured: drop the symbol (HF BPE behavior)
        if len(self._cache) < 65536:
            self._cache[word] = ids
        return ids


class ByteLevelBPETokenizer:
    """Full byte-level BPE pipeline over a tokenizer.json blob.

    Implements the RoBERTa/ModernBERT subset: optional Lowercase/NFC-family
    normalizer, ByteLevel pre-tokenizer (GPT-2 pattern + byte remap,
    add_prefix_space honored), BPE model, ByteLevel decoder.  Other
    normalizer/pre-tokenizer types raise.
    """

    def __init__(self, tokenizer_json: bytes | str):
        if isinstance(tokenizer_json, bytes):
            tokenizer_json = tokenizer_json.decode("utf-8")
        spec = json.loads(tokenizer_json)

        model = spec.get("model") or {}
        if model.get("type") != "BPE":
            raise ValueError(f"unsupported model type: {model.get('type')}")
        if model.get("continuing_subword_prefix") or model.get(
            "end_of_word_suffix"
        ):
            raise ValueError("subword prefix/suffix BPE not supported")
        self.model = BpeModel(
            vocab=model["vocab"],
            merges=model.get("merges", []),
            unk_token=model.get("unk_token"),
        )

        self._norm_steps = self._parse_normalizer(spec.get("normalizer"))

        pre = spec.get("pre_tokenizer") or {}
        pres = (
            pre.get("pretokenizers", [pre])
            if pre.get("type") == "Sequence"
            else [pre]
        )
        byte_level = next(
            (p for p in pres if p.get("type") == "ByteLevel"), None
        )
        if byte_level is None or any(
            p.get("type") not in ("ByteLevel",) for p in pres
        ):
            raise ValueError(
                f"unsupported pre_tokenizer: {pre.get('type')!r} "
                "(ByteLevel required)"
            )
        self.add_prefix_space = bool(byte_level.get("add_prefix_space", True))
        self.use_regex = bool(byte_level.get("use_regex", True))
        self._b2u = bytes_to_unicode()

        # added tokens (specials) match on raw text before the byte remap
        self._added_list = parse_added_tokens(spec)
        self._added: dict[str, int] = {
            t["content"]: t["id"] for t in self._added_list
        }
        self._id_to_token = {i: t for t, i in self.model.vocab.items()}
        for t, i in self._added.items():
            self._id_to_token.setdefault(i, t)

    @staticmethod
    def _parse_normalizer(norm):
        if norm is None:
            return []
        kinds = (
            norm.get("normalizers", [])
            if norm.get("type") == "Sequence"
            else [norm]
        )
        steps = []
        for k in kinds:
            t = k.get("type")
            if t == "Lowercase":
                steps.append(str.lower)
            elif t in ("NFC", "NFD", "NFKC", "NFKD"):
                steps.append(
                    lambda s, form=t: unicodedata.normalize(form, s)
                )
            else:
                raise ValueError(f"unsupported normalizer: {t!r}")
        return steps

    def _split_added(self, text: str):
        return split_added_tokens(text, self._added_list)

    def _encode_segment(self, seg: str) -> list[int]:
        for step in self._norm_steps:
            seg = step(seg)
        if self.add_prefix_space and seg and not seg.startswith(" "):
            seg = " " + seg
        words = gpt2_split(seg) if self.use_regex else ([seg] if seg else [])
        ids: list[int] = []
        b2u = self._b2u
        for w in words:
            mapped = "".join(b2u[b] for b in w.encode("utf-8"))
            ids.extend(self.model.tokenize(mapped))
        return ids

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for seg, seg_id in self._split_added(text):
            if seg_id is not None:
                ids.append(seg_id)
            else:
                ids.extend(self._encode_segment(seg))
        return ids

    def encode_batch(self, texts: Sequence[str]) -> list[list[int]]:
        return [self.encode(t) for t in texts]

    def id_to_token(self, token_id: int) -> str:
        return self._id_to_token.get(token_id, "")

    def decode(self, ids) -> str:
        """Ids -> text: invert the byte remap (ByteLevel decoder); added
        tokens pass through literally."""
        u2b = unicode_to_bytes()
        added_ids = set(self._added.values())
        out: list[str] = []
        raw = bytearray()
        for i in ids:
            i = int(i)
            if i in added_ids:
                if raw:
                    out.append(raw.decode("utf-8", errors="replace"))
                    raw = bytearray()
                out.append(self._id_to_token[i])
                continue
            for ch in self._id_to_token.get(i, ""):
                b = u2b.get(ch)
                if b is not None:
                    raw.append(b)
                else:  # not a byte-mapped char (malformed vocab): utf-8 it
                    raw.extend(ch.encode("utf-8"))
        if raw:
            out.append(raw.decode("utf-8", errors="replace"))
        return "".join(out)

    def token_to_id(self, token: str) -> int | None:
        if token in self._added:
            return self._added[token]
        return self.model.vocab.get(token)
