"""Tokenizer framing: special ids and the reference's `bert_tokenize`
framing, as in the JAX package's `tokenizer/base.py`.

The tokenizer.json pipeline runs *without* template special tokens; the
ids are then framed here: prepend CLS (not for T5), append SEP, truncate
to n_max_tokens with SEP overwriting the last slot on overflow.  A
cross-encoder pair frames as [CLS] a [SEP] b [SEP], or <s> a </s></s> b
</s> for RoBERTa, XLM-R and MPNet (`frame_pair_ids`).
"""
from __future__ import annotations

import unicodedata
from dataclasses import dataclass
from typing import Sequence

from ..gguf.constants import Keys


@dataclass(frozen=True)
class SpecialIds:
    cls: int
    sep: int
    pad: int
    unk: int

    @classmethod
    def from_gguf_kv(cls, kv: dict) -> "SpecialIds":
        return cls(
            cls=int(kv.get(Keys.TOKENIZER_CLS_ID, 101)),
            sep=int(kv.get(Keys.TOKENIZER_SEP_ID, 102)),
            pad=int(kv.get(Keys.TOKENIZER_PAD_ID, 0)),
            unk=int(kv.get(Keys.TOKENIZER_UNK_ID, 100)),
        )


def frame_ids(ids: Sequence[int], special: SpecialIds, n_max_tokens: int,
              add_cls: bool = True) -> list[int]:
    """[CLS] + ids (stopping at the first pad id) + [SEP], truncated;
    add_cls=False frames ids + [SEP] only (T5: no CLS in its vocabulary,
    </s> in the separator's slot)."""
    out = [special.cls] if add_cls else []
    for i in ids:
        if i == special.pad:  # padding from the json config: stop here
            break
        out.append(int(i))
        if len(out) >= n_max_tokens:
            break
    if len(out) >= n_max_tokens:
        out[n_max_tokens - 1] = special.sep
        del out[n_max_tokens:]
    else:
        out.append(special.sep)
    return out


def _strip_pad(ids: Sequence[int], pad: int) -> list[int]:
    """The ids up to the first pad id (padding a json config injects)."""
    out = []
    for i in ids:
        if i == pad:
            break
        out.append(int(i))
    return out


def truncate_longest_first(la: int, lb: int, budget: int) -> tuple[int, int]:
    """HF tokenizers' LongestFirst truncation of a pair: the kept lengths.
    The longer sequence is trimmed to the other's length, then the
    remaining budget splits with the ceiling half to the longer one; on
    equal lengths the second counts as the longer.  `budget` excludes the
    special tokens."""
    budget = max(0, budget)
    if la + lb <= budget:
        return la, lb
    a_longest = la > lb
    lng, oth = (la, lb) if a_longest else (lb, la)
    to_remove = lng + oth - budget
    if lng - oth >= to_remove:  # trimming the longer one alone suffices
        lng -= to_remove
    else:
        lng = budget - budget // 2
        oth = budget // 2
    return (lng, oth) if a_longest else (oth, lng)


def frame_pair_ids(a_ids: Sequence[int], b_ids: Sequence[int], special: SpecialIds,
                   n_max_tokens: int, *, double_sep: bool = False
                   ) -> tuple[list[int], list[int]]:
    """Cross-encoder pair framing [CLS] a [SEP] b [SEP] -> (ids, token type
    ids 0...0 1...1; the [SEP] after `a` belongs to segment 0), the pair
    truncated longest-first to n_max_tokens.  double_sep (RoBERTa, XLM-R,
    MPNet): <s> a </s></s> b </s>, every type id 0 (a one-row token-type
    table, or none), four specials out of the budget."""
    a = _strip_pad(a_ids, special.pad)
    b = _strip_pad(b_ids, special.pad)
    la, lb = truncate_longest_first(len(a), len(b), n_max_tokens - (4 if double_sep else 3))
    if double_sep:
        ids = [special.cls, *a[:la], special.sep, special.sep, *b[:lb], special.sep]
        return ids, [0] * len(ids)
    ids = [special.cls, *a[:la], special.sep, *b[:lb], special.sep]
    return ids, [0] * (la + 2) + [1] * (lb + 1)


# --- added-token matching ----------------------------------------------------

# Unicode White_Space, exactly what the tokenizers crate strips for
# AddedToken lstrip/rstrip (NOT str.isspace(), which adds 0x1C-0x1F)
_ADDED_WS = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
) | frozenset(chr(c) for c in range(0x2000, 0x200B))


def _is_word_char(ch: str) -> bool:
    """Word char for AddedToken single_word boundaries."""
    cat = unicodedata.category(ch)
    return cat[0] in "LMN" or cat == "Pc" or ch in "\u200c\u200d"


def parse_added_tokens(spec: dict) -> list[dict]:
    """added_tokens entries, sorted longest-first for the leftmost-longest
    scan."""
    toks = [
        {
            "content": t["content"],
            "id": int(t["id"]),
            "lstrip": bool(t.get("lstrip", False)),
            "rstrip": bool(t.get("rstrip", False)),
            "single_word": bool(t.get("single_word", False)),
        }
        for t in spec.get("added_tokens", [])
    ]
    toks.sort(key=lambda t: -len(t["content"]))
    return toks


def split_added_tokens(text: str, added: list[dict]) -> list[tuple[str, int | None]]:
    """Split raw text on added tokens with the tokenizers crate's
    AddedVocabulary semantics (leftmost-longest; single_word; lstrip/rstrip
    consume the adjacent whitespace).  Returns [(segment, None) | (token, id)]."""
    if not added:
        return [(text, None)] if text else []
    n = len(text)
    segments: list[tuple[str, int | None]] = []
    pos = 0
    seg_start = 0
    while pos < n:
        hit = None
        for t in added:
            c = t["content"]
            if not c or not text.startswith(c, pos):
                continue
            end = pos + len(c)
            if t["single_word"] and (
                (pos > 0 and _is_word_char(text[pos - 1]))
                or (end < n and _is_word_char(text[end]))
            ):
                continue
            start = pos
            if t["lstrip"]:
                while start > seg_start and text[start - 1] in _ADDED_WS:
                    start -= 1
            if t["rstrip"]:
                while end < n and text[end] in _ADDED_WS:
                    end += 1
            hit = (start, end, c, t["id"])
            break
        if hit is None:
            pos += 1
            continue
        start, end, content, tid = hit
        if start > seg_start:
            segments.append((text[seg_start:start], None))
        segments.append((content, tid))
        pos = end
        seg_start = end
    if seg_start < n:
        segments.append((text[seg_start:], None))
    return segments
