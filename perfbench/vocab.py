"""The benchmark's own vocabularies: whole words only, at the config's full
published `n_vocab`, so every text the traffic draws tokenizes to one id a
word and the reference derives every id again from the text alone.

The words are random lowercase strings of English-like length (1 + a
Poisson count of mean 4.5 letters, at least 2, at most 16: about 5.6 a
word), drawn from one fixed seed, so every `--seed` tokenizes the same
vocabulary and only the texts change with it.

- WordPiece (BERT): BERT's special layout ([PAD] 0, [unused0..98] 1..99,
  [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103), then the words of the
  config's prompts and their punctuation, then drawn words up to n_vocab.
- Byte-level BPE (ModernBERT): the 256 byte symbols, then "Ġ" + each
  drawn word and each of its prefixes, built by one merge per letter
  ("Ġab" = "Ġa" + "b"), so a word becomes its own token whatever words
  surround it; texts draw only the drawn words, not the prefixes.
  ModernBERT's specials ([UNK] 50280 .. [MASK] 50284 at the published
  size) and [unused] fill the ids after the model's vocabulary.  The
  pre-tokenizer adds the prefix space, so the first word of a text is
  "Ġ" + word too.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass
from string import ascii_lowercase

import numpy as np

# ModernBERT's tokenizer: 50280 BPE ids, then its specials
_BPE_SPECIALS = ("[UNK]", "[CLS]", "[SEP]", "[PAD]", "[MASK]")
_BPE_MODEL_SIZE = 50280
# the vocabulary's own seed: the same words whatever the run's --seed
VOCAB_SEED = 0x766F6361
_LETTERS = np.array(list(ascii_lowercase))


def drawn_words(seed: int = VOCAB_SEED):
    """Distinct lowercase words of English-like length, endlessly, in the
    order a fixed generator draws them."""
    rng = np.random.default_rng(seed)
    seen: set[str] = set()
    while True:
        lens = np.clip(1 + rng.poisson(4.5, 4096), 2, 16)
        letters = _LETTERS[rng.integers(0, 26, int(lens.sum()))]
        off = 0
        for n in lens:
            w = "".join(letters[off: off + n])
            off += n
            if w not in seen:
                seen.add(w)
                yield w


def random_words(n: int, skip: frozenset = frozenset()) -> list[str]:
    """The first n drawn words, leaving out `skip`."""
    out = []
    for w in drawn_words():
        if w not in skip:
            out.append(w)
            if len(out) == n:
                return out
    raise AssertionError("unreachable")


def prefix_closed_words(n: int) -> tuple[list[str], list[int]]:
    """n strings closed under prefixes (each drawn word with every prefix
    of it, the shorter first) and the sorted indices of the drawn words
    among them; the last word is cut where the n-th string falls."""
    index: dict[str, int] = {}
    drawn: list[int] = []
    for w in drawn_words():
        for k in range(1, len(w) + 1):
            index.setdefault(w[:k], len(index))
            if len(index) == n:
                break
        drawn.append(index[w[:k]])
        if len(index) == n:
            return list(index), sorted(set(drawn))
    raise AssertionError("unreachable")


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable character map (the ByteLevel
    pre-tokenizer's)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def prompt_tokens(prompts: dict[str, str]) -> list[str]:
    """The lowercase words and punctuation of the prompts, in order."""
    seen: list[str] = []
    for text in prompts.values():
        for t in re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower()):
            if t not in seen:
                seen.append(t)
    return seen


@dataclass
class Vocab:
    kind: str  # "wordpiece" | "bpe"
    tokens: list[str]  # by id, n_vocab of them
    word_ids: np.ndarray  # the ids texts draw words from
    words: np.ndarray  # object array: the text form of each id in word_ids' range
    special: dict[str, int]  # cls / sep / pad / unk
    tokenizer_json: bytes

    def text(self, ids: np.ndarray) -> str:
        """The text of word ids (space-separated words)."""
        return " ".join(self.words[ids])


def _wordpiece(n_vocab: int, prompts: dict[str, str]) -> Vocab:
    tokens = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]",
                                                                "[MASK]"]
    extra = prompt_tokens(prompts)
    tokens += extra
    first_word = len(tokens)
    tokens += random_words(n_vocab - len(tokens), frozenset(extra))
    vocab = {t: i for i, t in enumerate(tokens)}
    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": [],
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None,
                       "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": None,
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]",
                  "continuing_subword_prefix": "##", "max_input_chars_per_word": 100,
                  "vocab": vocab},
    }
    words = np.array(tokens, dtype=object)
    return Vocab("wordpiece", tokens, np.arange(first_word, n_vocab), words,
                 {"cls": 101, "sep": 102, "pad": 0, "unk": 100},
                 json.dumps(spec, separators=(",", ":")).encode())


def _bpe(n_vocab: int) -> Vocab:
    b2u = bytes_to_unicode()
    space = b2u[ord(" ")]
    model_size = min(_BPE_MODEL_SIZE, n_vocab - len(_BPE_SPECIALS))
    words, drawn = prefix_closed_words(model_size - 256)
    tokens = [b2u[b] for b in range(256)] + [space + w for w in words]
    merges = [f"{space + w[:-1]} {w[-1]}" for w in words]
    added = list(_BPE_SPECIALS) + [f"[unused{i}]" for i in range(n_vocab - model_size
                                                                 - len(_BPE_SPECIALS))]
    ids = {t: model_size + i for i, t in enumerate(added)}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for t, i in ids.items()],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": True,
                          "trim_offsets": True, "use_regex": True},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False,
                  "vocab": {t: i for i, t in enumerate(tokens)}, "merges": merges},
    }
    text_forms = np.array([b2u[b] for b in range(256)] + words, dtype=object)
    return Vocab("bpe", tokens + added, 256 + np.asarray(drawn, dtype=np.int64), text_forms,
                 {"cls": ids["[CLS]"], "sep": ids["[SEP]"], "pad": ids["[PAD]"],
                  "unk": ids["[UNK]"]},
                 json.dumps(spec, separators=(",", ":")).encode())


def build_vocab(config: dict) -> Vocab:
    """The vocabulary of a configuration file (`tokenizer`: wordpiece | bpe)."""
    n_vocab = int(config["vocab_size"])
    if config["tokenizer"] == "wordpiece":
        return _wordpiece(n_vocab, config.get("prompts") or {})
    if config["tokenizer"] == "bpe":
        return _bpe(n_vocab)
    raise ValueError(f"unknown tokenizer {config['tokenizer']!r}")
