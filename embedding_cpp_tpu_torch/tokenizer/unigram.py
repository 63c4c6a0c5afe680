"""Pure-Python tokenizer.json Unigram (SentencePiece) engine.

A copy of the JAX package's `tokenizer/unigram.py`, which this package may
not import: the tokenizer of DeBERTa-v3 (and XLM-R) checkpoints, with the
HF `tokenizers` semantics:

- normalizers: Precompiled (the sentencepiece charsmap as a darts
  double-array trie, read from the base64 blob), NFC-family, Lowercase,
  StripAccents, Replace, Strip, Prepend, Sequence;
- pre-tokenizer: Metaspace (space -> U+2581, prepend scheme, split
  merged-with-next);
- model: Unigram Viterbi over each pre-token — max-sum segmentation with
  unknown-char nodes at min_score - 10.0, consecutive unknowns fused
  (fuse_unk), optional byte_fallback.

Known deviation, as in the reference: HF segments Precompiled input into
UAX#29 extended grapheme clusters before the charsmap lookup; a cluster is
approximated here as a base char plus combining marks / ZWJ / variation
selectors.
"""
from __future__ import annotations

import base64
import json
import re
import struct
import unicodedata
from typing import Sequence

from .base import parse_added_tokens, split_added_tokens

_UNK_PENALTY = 10.0  # K_UNK_PENALTY, tokenizers models/unigram/model.rs


# --- Precompiled charsmap (sentencepiece normalizer) -------------------------


class DoubleArrayTrie:
    """Reader for the darts-clone double-array trie inside a sentencepiece
    precompiled_charsmap, matching spm_precompiled's unit encoding:
    label = unit & 0x800000FF, has_leaf = unit >> 8 & 1,
    offset = (unit >> 10) << ((unit & 0x200) >> 6), value = unit & 0x7FFFFFFF.
    """

    def __init__(self, units: Sequence[int]):
        self.units = units

    def common_prefix_search(self, key: bytes) -> list[int]:
        units = self.units
        unit = units[0]
        node_pos = (unit >> 10) << ((unit & 0x200) >> 6)
        results: list[int] = []
        for c in key:
            node_pos ^= c
            if node_pos >= len(units):
                return results
            unit = units[node_pos]
            if (unit & 0x800000FF) != c:
                return results
            node_pos ^= (unit >> 10) << ((unit & 0x200) >> 6)
            if (unit >> 8) & 1:
                results.append(units[node_pos] & 0x7FFFFFFF)
        return results


_MARK_CATS = ("Mn", "Mc", "Me")
_CLUSTER_EXTRAS = frozenset(chr(c) for c in range(0xFE00, 0xFE10)) | {"‍"}


def _grapheme_clusters(text: str):
    """Approximate UAX#29 extended clusters: base + marks/ZWJ/variation
    selectors (see module docstring for the deviation note)."""
    i, n = 0, len(text)
    while i < n:
        j = i + 1
        while j < n and (
            unicodedata.category(text[j]) in _MARK_CATS
            or text[j] in _CLUSTER_EXTRAS
        ):
            j += 1
        yield text[i:j]
        i = j


class PrecompiledCharsmap:
    """sentencepiece's compiled normalization map: [u32 trie_size][trie
    units][NUL-separated normalized strings]; chunk -> replacement via
    common-prefix search, first (shortest-prefix) hit wins
    (spm_precompiled transform())."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("precompiled charsmap too short")
        (trie_size,) = struct.unpack_from("<I", blob, 0)
        if 4 + trie_size > len(blob):
            raise ValueError("precompiled charsmap: trie exceeds blob")
        n_units = trie_size // 4
        units = struct.unpack_from(f"<{n_units}I", blob, 4)
        self.trie = DoubleArrayTrie(units)
        self.normalized = blob[4 + trie_size:]

    def transform(self, chunk: str) -> str | None:
        results = self.trie.common_prefix_search(chunk.encode("utf-8"))
        if not results:
            return None
        start = results[0]
        end = self.normalized.find(b"\x00", start)
        if end < 0:
            end = len(self.normalized)
        return self.normalized[start:end].decode("utf-8", errors="replace")

    def normalize(self, text: str) -> str:
        out: list[str] = []
        for cluster in _grapheme_clusters(text):
            if len(cluster.encode("utf-8")) < 6:
                norm = self.transform(cluster)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in cluster:
                norm = self.transform(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


# --- normalizer pipeline -----------------------------------------------------


def _parse_normalizer(norm):
    if norm is None:
        return []
    kinds = (
        norm.get("normalizers", []) if norm.get("type") == "Sequence" else [norm]
    )
    steps = []
    for k in kinds:
        t = k.get("type")
        if t == "Precompiled":
            blob = base64.b64decode(k["precompiled_charsmap"])
            steps.append(PrecompiledCharsmap(blob).normalize)
        elif t in ("NFC", "NFD", "NFKC", "NFKD"):
            steps.append(lambda s, form=t: unicodedata.normalize(form, s))
        elif t == "Lowercase":
            steps.append(str.lower)
        elif t == "StripAccents":
            # HF StripAccents removes ALL combining marks (categories
            # Mn/Mc/Me — Rust is_combining_mark) — the ALBERT/XLNet
            # converter pairs it with a preceding NFKD
            steps.append(
                lambda s: "".join(
                    c for c in s if not unicodedata.category(c).startswith("M")
                )
            )
        elif t == "Replace":
            pat = k.get("pattern") or {}
            content = k.get("content", "")
            if "String" in pat:
                steps.append(
                    lambda s, a=pat["String"], b=content: s.replace(a, b)
                )
            elif "Regex" in pat:
                rx = re.compile(pat["Regex"])
                steps.append(lambda s, rx=rx, b=content: rx.sub(b, s))
            else:
                raise ValueError(f"unsupported Replace pattern: {pat!r}")
        elif t == "Strip":
            left, right = bool(k.get("strip_left", True)), bool(
                k.get("strip_right", True)
            )
            steps.append(
                lambda s, l=left, r=right: (
                    s.strip() if l and r else s.lstrip() if l else s.rstrip()
                )
            )
        elif t == "Prepend":
            steps.append(
                lambda s, p=k.get("prepend", ""): (p + s) if s else s
            )
        else:
            raise ValueError(f"unsupported normalizer: {t!r}")
    return steps


# --- Unigram model -----------------------------------------------------------

_LEAF = 0  # char-trie leaf key (chars are len-1 strings, 0 can't collide)


class UnigramModel:
    """Viterbi max-sum segmentation over a scored piece vocabulary, matching
    tokenizers' encode_optimized: per-char DP positions, candidate pieces
    from a prefix trie, an unknown-char node (min_score - 10.0) only where
    no single-char piece matches, ties kept by first writer."""

    def __init__(self, vocab: list, unk_id: int | None, byte_fallback: bool,
                 fuse_unk: bool = True):
        self.pieces = [p for p, _ in vocab]
        self.scores = [float(s) for _, s in vocab]
        self.vocab = {p: i for i, (p, _) in enumerate(vocab)}
        self.unk_id = unk_id
        self.byte_fallback = byte_fallback
        self.fuse_unk = fuse_unk
        self.min_score = min(self.scores) if self.scores else 0.0
        self.trie: dict = {}
        for pid, piece in enumerate(self.pieces):
            node = self.trie
            for ch in piece:
                node = node.setdefault(ch, {})
            node[_LEAF] = pid
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, word: str) -> list[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        ids = self._viterbi(word)
        if len(self._cache) < 65536:
            self._cache[word] = ids
        return ids

    def _viterbi(self, word: str) -> list[int]:
        if not word:
            return []
        n = len(word)
        unk_score = self.min_score - _UNK_PENALTY
        # per char position: (score, start, piece_id); None = unreached
        best: list = [None] * (n + 1)
        best[0] = (0.0, -1, -1)
        for i in range(n):
            here = best[i]
            if here is None:  # not a reachable char boundary
                continue
            base = here[0]
            node = self.trie
            has_single = False
            j = i
            while j < n:
                node = node.get(word[j])
                if node is None:
                    break
                j += 1
                pid = node.get(_LEAF)
                if pid is None:
                    continue
                if j - i == 1:
                    has_single = True
                cand = base + self.scores[pid]
                if best[j] is None or cand > best[j][0]:
                    best[j] = (cand, i, pid)
            if not has_single:
                cand = base + unk_score
                if best[i + 1] is None or cand > best[i + 1][0]:
                    best[i + 1] = (cand, i, -1)  # -1 = unk node
        # backtrack
        rev: list[tuple[int, int, int]] = []  # (start, end, pid)
        pos = n
        while pos > 0:
            _, start, pid = best[pos]
            rev.append((start, pos, pid))
            pos = start
        rev.reverse()
        ids: list[int] = []
        k = 0
        while k < len(rev):
            start, end, pid = rev[k]
            if pid >= 0:
                ids.append(pid)
                k += 1
                continue
            # unknown span: fuse consecutive unk nodes into one token
            k2 = k
            while self.fuse_unk and k2 + 1 < len(rev) and rev[k2 + 1][2] < 0:
                k2 += 1
            chunk = word[start: rev[k2][1]]
            k = k2 + 1
            if self.byte_fallback:
                byte_ids = [
                    self.vocab.get(f"<0x{b:02X}>") for b in chunk.encode("utf-8")
                ]
                if all(b is not None for b in byte_ids):
                    ids.extend(byte_ids)
                    continue
            if self.unk_id is not None:
                ids.append(self.unk_id)
        return ids


# --- full pipeline -----------------------------------------------------------


class UnigramTokenizer:
    """Full SentencePiece-Unigram pipeline over a tokenizer.json blob;
    configurations outside the subset above raise ValueError."""

    def __init__(self, tokenizer_json: bytes | str):
        if isinstance(tokenizer_json, bytes):
            tokenizer_json = tokenizer_json.decode("utf-8")
        spec = json.loads(tokenizer_json)

        model = spec.get("model") or {}
        if model.get("type") != "Unigram":
            raise ValueError(f"unsupported model type: {model.get('type')}")
        pre = spec.get("pre_tokenizer") or {}
        if pre.get("type") != "Metaspace":
            raise ValueError(
                f"unsupported pre_tokenizer: {pre.get('type')!r} "
                "(Metaspace required)"
            )
        self.model = UnigramModel(
            vocab=model["vocab"],
            unk_id=model.get("unk_id"),
            byte_fallback=bool(model.get("byte_fallback", False)),
        )

        self._norm_steps = _parse_normalizer(spec.get("normalizer"))

        self.replacement = pre.get("replacement", "▁")
        # modern serialization: prepend_scheme always|first|never; legacy:
        # add_prefix_space bool
        scheme = pre.get("prepend_scheme")
        if scheme is None:
            scheme = (
                "always" if pre.get("add_prefix_space", True) else "never"
            )
        self.prepend_scheme = scheme
        self.split = bool(pre.get("split", True))

        self._added_list = parse_added_tokens(spec)
        self._id_to_token = {i: p for p, i in self.model.vocab.items()}
        for t in self._added_list:
            self._id_to_token.setdefault(t["id"], t["content"])

    def _split_added(self, text: str):
        return split_added_tokens(text, self._added_list)

    def _pre_tokenize(self, seg: str, first: bool = True) -> list[str]:
        rep = self.replacement
        seg = seg.replace(" ", rep)
        # "first" prepends only to the section at text offset 0 — a section
        # after an added-token split gets no separator (HF PrependScheme)
        prepend = self.prepend_scheme == "always" or (
            self.prepend_scheme == "first" and first
        )
        if prepend and seg and not seg.startswith(rep):
            seg = rep + seg
        if not self.split:
            return [seg] if seg else []
        # split on the replacement char, merged-with-next
        words: list[str] = []
        start = 0
        for m in re.finditer(re.escape(rep), seg):
            if m.start() > start:
                words.append(seg[start: m.start()])
            start = m.start()
        if start < len(seg) or (seg and not words):
            words.append(seg[start:])
        # merge: a piece that IS only separators fuses with the next piece?
        # no — MergedWithNext attaches each delimiter to what follows, which
        # the scan above already does (every split starts at a delimiter)
        return [w for w in words if w]

    def _encode_segment(self, seg: str, first: bool = True) -> list[int]:
        for step in self._norm_steps:
            seg = step(seg)
        ids: list[int] = []
        for w in self._pre_tokenize(seg, first):
            ids.extend(self.model.tokenize(w))
        return ids

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        first = True
        for seg, seg_id in self._split_added(text):
            if seg_id is not None:
                ids.append(seg_id)
            else:
                ids.extend(self._encode_segment(seg, first))
            first = False
        return ids

    def encode_batch(self, texts: Sequence[str]) -> list[list[int]]:
        return [self.encode(t) for t in texts]

    def id_to_token(self, token_id: int) -> str:
        return self._id_to_token.get(token_id, "")

    def decode(self, ids) -> str:
        """Metaspace decoder: replacement -> space, the first token's
        leading separator stripped (prepend_scheme != never); added tokens
        pass through literally."""
        out: list[str] = []
        for n, i in enumerate(ids):
            piece = self._id_to_token.get(int(i), "").replace(self.replacement, " ")
            if n == 0 and self.prepend_scheme != "never" and piece.startswith(" "):
                piece = piece[1:]
            out.append(piece)
        return "".join(out)
