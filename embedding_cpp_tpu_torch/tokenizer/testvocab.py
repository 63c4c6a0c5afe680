"""Synthetic tokenizers for tests and benchmarks (no downloads).

`build_tokenizer_json` writes the tokenizer.json that the HF `tokenizers`
library serializes for a BertNormalizer + BertPreTokenizer + WordPiece
pipeline over the synthetic vocab — the same document the JAX package's
`tokenizer/testvocab.py` builds with that library — without needing the
library itself.  The byte-level BPE, Unigram and ALBERT-style Unigram
builders train their vocabularies with that library, as the JAX package's
do (training is deterministic for a fixed corpus), and raise where it is
not installed.
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


_CORPUS = (
    " ".join(_COMMON_WORDS),
    "It's the quick brown fox; don't they'll we've I'm you're 123 42.",
    "Café déjà vu — naïve résumé!",
)
_EUROPEAN = ("Ein schneller brauner Fuchs springt über den faulen Hund.",
             "Le renard brun rapide saute par-dessus le chien paresseux.")


def _tokenizers():
    """The HF `tokenizers` library, which trains the BPE and Unigram
    vocabularies (the WordPiece one needs nothing)."""
    try:
        import tokenizers
    except ImportError as e:
        raise RuntimeError("the BPE and Unigram test vocabularies are trained with the HF "
                           "`tokenizers` library, which is not installed; the WordPiece "
                           "presets need nothing") from e
    return tokenizers


def build_bpe_tokenizer_json(n_vocab: int = 1000, add_prefix_space: bool = False) -> bytes:
    """A byte-level BPE tokenizer.json (RoBERTa-style: specials <s> <pad>
    </s> <unk> <mask>, ByteLevel pre-tokenizer and decoder), merges trained
    on the synthetic corpus."""
    tk = _tokenizers()
    tok = tk.Tokenizer(tk.models.BPE())
    tok.pre_tokenizer = tk.pre_tokenizers.ByteLevel(add_prefix_space=add_prefix_space,
                                                    use_regex=True)
    tok.decoder = tk.decoders.ByteLevel()
    trainer = tk.trainers.BpeTrainer(
        vocab_size=n_vocab, special_tokens=["<s>", "<pad>", "</s>", "<unk>", "<mask>"],
        initial_alphabet=tk.pre_tokenizers.ByteLevel.alphabet(), show_progress=False)
    tok.train_from_iterator(list(_CORPUS), trainer)
    return tok.to_str().encode("utf-8")


def _unigram(normalizer, special_tokens: list[str], corpus: list[str], n_vocab: int) -> bytes:
    tk = _tokenizers()
    tok = tk.Tokenizer(tk.models.Unigram())
    if normalizer is not None:
        tok.normalizer = normalizer
    tok.pre_tokenizer = tk.pre_tokenizers.Metaspace(replacement="▁")
    tok.decoder = tk.decoders.Metaspace(replacement="▁")
    trainer = tk.trainers.UnigramTrainer(vocab_size=n_vocab, special_tokens=special_tokens,
                                         unk_token="<unk>", show_progress=False)
    tok.train_from_iterator(corpus, trainer)
    return tok.to_str().encode("utf-8")


def build_unigram_tokenizer_json(n_vocab: int = 600) -> bytes:
    """An XLM-R-style Unigram tokenizer.json (Metaspace pre-tokenizer and
    decoder, specials <s> <pad> </s> <unk>) trained on the synthetic
    multilingual corpus."""
    return _unigram(None, ["<s>", "<pad>", "</s>", "<unk>"],
                    [*_CORPUS, "你好世界 中文 模型 嵌入 向量 日本語 テスト", *_EUROPEAN], n_vocab)


def build_albert_tokenizer_json(n_vocab: int = 600) -> bytes:
    """An ALBERT-style Unigram tokenizer.json: the normalizers HF's
    AlbertConverter emits for a lower-casing checkpoint without accents
    (quotes replaced, NFKD, accents stripped, lower case, runs of spaces
    collapsed) over Metaspace, specials in ALBERT's order."""
    n = _tokenizers().normalizers
    normalizer = n.Sequence([
        n.Replace("``", '"'), n.Replace("''", '"'), n.NFKD(), n.StripAccents(), n.Lowercase(),
        n.Replace(_tokenizers().Regex(" {2,}"), " ")])
    return _unigram(normalizer, ["<pad>", "<unk>", "[CLS]", "[SEP]"],
                    [*_CORPUS, "ﬁne ﬂour ½ cup №5 Ⅻ ℕ ｆｕｌｌｗｉｄｔｈ", *_EUROPEAN], n_vocab)


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
