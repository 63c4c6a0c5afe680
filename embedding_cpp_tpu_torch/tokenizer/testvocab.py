"""Synthetic WordPiece tokenizer for tests and benchmarks (no downloads).

`build_tokenizer_json` writes the tokenizer.json that the HF `tokenizers`
library serializes for a BertNormalizer + BertPreTokenizer + WordPiece
pipeline over the synthetic vocab — the same document the JAX package's
`tokenizer/testvocab.py` builds with that library — without needing the
library itself.
"""
from __future__ import annotations

import json
import string

_COMMON_WORDS = (
    "the of and a to in is you that it he was for on are as with his they i at "
    "be this have from or one had by word but not what all were we when your "
    "can said there use an each which she do how their if will up other about "
    "out many then them these so some her would make like him into time has "
    "look two more write go see number no way could people my than first water "
    "been call who oil its now find long down day did get come made may part "
    "store buy apple banana welcome along cloudy outside back soon anywhere "
    "going time partly hello world test sentence embedding model quick brown "
    "fox jumps over lazy dog"
).split()


def build_vocab(n_vocab: int = 1000) -> dict[str, int]:
    """Deterministic synthetic WordPiece vocab of exactly n_vocab entries."""
    tokens: list[str] = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += list(string.ascii_lowercase) + list(string.digits) + list(
        ".,!?;:'\"()[]{}<>-+*/=@#$%&_|\\~`^"
    )
    tokens += [f"##{c}" for c in string.ascii_lowercase + string.digits]
    for w in _COMMON_WORDS:
        if w not in tokens:
            tokens.append(w)
    for piece in ("##ing", "##ed", "##er", "##ly", "##tion", "##re", "##es",
                  "##ll", "##ve", "##s", "##t", "##d", "##m"):
        if piece not in tokens:
            tokens.append(piece)
    if len(tokens) > n_vocab:
        raise ValueError(f"n_vocab {n_vocab} too small (need {len(tokens)})")
    i = 0
    while len(tokens) < n_vocab:
        tokens.append(f"[unused{i}]")
        i += 1
    return {t: i for i, t in enumerate(tokens)}


def _special(token: str, type_id: int) -> dict:
    return {"SpecialToken": {"id": token, "type_id": type_id}}


def _sequence(name: str, type_id: int) -> dict:
    return {"Sequence": {"id": name, "type_id": type_id}}


def build_tokenizer_json(n_vocab: int = 1000, lowercase: bool = True) -> bytes:
    """Serialize the WordPiece tokenizer.json for the synthetic vocab."""
    vocab = build_vocab(n_vocab)
    spec = {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": [],
        "normalizer": {
            "type": "BertNormalizer", "clean_text": True,
            "handle_chinese_chars": True, "strip_accents": None,
            "lowercase": lowercase,
        },
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [_special("[CLS]", 0), _sequence("A", 0), _special("[SEP]", 0)],
            "pair": [_special("[CLS]", 0), _sequence("A", 0), _special("[SEP]", 0),
                     _sequence("B", 1), _special("[SEP]", 1)],
            "special_tokens": {
                t: {"id": t, "ids": [vocab[t]], "tokens": [t]}
                for t in ("[CLS]", "[SEP]")
            },
        },
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {
            "type": "WordPiece", "unk_token": "[UNK]",
            "continuing_subword_prefix": "##", "max_input_chars_per_word": 100,
            "vocab": vocab,
        },
    }
    return json.dumps(spec, ensure_ascii=False, separators=(",", ":")).encode("utf-8")
