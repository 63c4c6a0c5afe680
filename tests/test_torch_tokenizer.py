"""The port's pure-Python tokenizers and framing against the JAX package's:
WordPiece (the committed golden ids, added-token splitting, the synthetic
tokenizer.json), byte-level BPE, SentencePiece Unigram (trained,
ALBERT-normalized and Precompiled-charsmap pipelines), and CLS/SEP
framing."""
import json
import random
from pathlib import Path

import pytest

from embedding_cpp_tpu.tokenizer.base import SpecialIds as JSpecialIds
from embedding_cpp_tpu.tokenizer.base import frame_ids as jax_frame_ids
from embedding_cpp_tpu.tokenizer.testvocab import build_tokenizer_json as jax_build_json
from embedding_cpp_tpu.tokenizer.wordpiece import WordPieceTokenizer as JWordPiece
from embedding_cpp_tpu_torch.tokenizer import SpecialIds, WordPieceTokenizer, frame_ids
from embedding_cpp_tpu_torch.tokenizer.testvocab import build_tokenizer_json

HERE = Path(__file__).resolve().parent
ALPHABET = ("abc def ghi,.!? Ünïcödé 中文 \t\n\x00� the quick brown fox "
            "[CLS] [SEP] [MASK]x  ##ing ")


def test_committed_golden_ids():
    tok = WordPieceTokenizer((HERE / "golden_tokenizer.json").read_bytes())
    entries = json.loads((HERE / "golden_tokens.json").read_text())["entries"]
    for e in entries:
        assert tok.encode(e["text"]) == e["ids"], e["text"]


@pytest.mark.parametrize("n_vocab", [300, 1000])
def test_synthetic_tokenizer_json_is_byte_identical(n_vocab):
    assert build_tokenizer_json(n_vocab) == jax_build_json(n_vocab)


def _with_added_tokens() -> bytes:
    spec = json.loads(jax_build_json(1000))
    spec["added_tokens"] = [
        {"id": 2, "content": "[CLS]", "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False, "special": True},
        {"id": 3, "content": "[SEP]", "single_word": False, "lstrip": True,
         "rstrip": True, "normalized": False, "special": True},
        {"id": 4, "content": "[MASK]", "single_word": True, "lstrip": True,
         "rstrip": False, "normalized": False, "special": True},
    ]
    return json.dumps(spec).encode()


@pytest.mark.parametrize("blob", ["synthetic", "added_tokens"])
def test_fuzzed_encodes_match_jax(blob):
    data = jax_build_json(1000) if blob == "synthetic" else _with_added_tokens()
    ours, theirs = WordPieceTokenizer(data), JWordPiece(data)
    rng = random.Random(0)
    for _ in range(1500):
        text = "".join(rng.choice(ALPHABET) for _ in range(rng.randint(0, 48)))
        assert ours.encode(text) == theirs.encode(text), repr(text)


@pytest.mark.parametrize("n", [0, 3, 6, 7, 20])
def test_framing_matches_jax(n):
    ids = list(range(10, 10 + n)) + [0, 55]  # a pad id stops the copy
    ours = frame_ids(ids, SpecialIds(cls=2, sep=3, pad=0, unk=1), 8)
    theirs = jax_frame_ids(ids, JSpecialIds(cls=2, sep=3, pad=0, unk=1), 8)
    assert ours == theirs and len(ours) <= 8 and ours[-1] == 3


def test_unsupported_tokenizer_json_raises():
    spec = json.loads(jax_build_json(300))
    spec["model"]["type"] = "BPE"
    with pytest.raises(ValueError):
        WordPieceTokenizer(json.dumps(spec))


# --- byte-level BPE (RoBERTa / ModernBERT tokenizer.json) ----------------------

BPE_ALPHABET = ("abc def ghi,.!? Café déjà vu — naïve résumé 中文 \t\n 123 42 "
                "It's don't they'll we've I'm <s></s><mask> the quick brown fox ")


@pytest.mark.parametrize("add_prefix_space", [False, True])
def test_bpe_fuzzed_encodes_match_jax(add_prefix_space):
    pytest.importorskip("tokenizers")
    from embedding_cpp_tpu.tokenizer.bpe import ByteLevelBPETokenizer as JBPE
    from embedding_cpp_tpu.tokenizer.testvocab import build_bpe_tokenizer_json

    from embedding_cpp_tpu_torch.tokenizer import ByteLevelBPETokenizer

    data = build_bpe_tokenizer_json(1000, add_prefix_space=add_prefix_space)
    ours, theirs = ByteLevelBPETokenizer(data), JBPE(data)
    rng = random.Random(1)
    for _ in range(1000):
        text = "".join(rng.choice(BPE_ALPHABET) for _ in range(rng.randint(0, 48)))
        ids = ours.encode(text)
        assert ids == theirs.encode(text), repr(text)
        assert ours.decode(ids) == theirs.decode(ids)
    assert ours.token_to_id("<mask>") == theirs.token_to_id("<mask>")


def test_load_tokenizer_dispatches_on_model_type():
    """The pure-Python backend picks its engine by model.type ("auto" puts
    the native and HF backends first: test_torch_native_tokenizer.py)."""
    from embedding_cpp_tpu_torch.tokenizer import ByteLevelBPETokenizer, load_tokenizer

    assert isinstance(load_tokenizer(jax_build_json(300), "python"), WordPieceTokenizer)
    spec = json.loads(jax_build_json(300))
    spec["model"] = {"type": "BPE", "vocab": {"a": 0, "b": 1, "ab": 2}, "merges": ["a b"]}
    spec["normalizer"] = None
    spec["pre_tokenizer"] = {"type": "ByteLevel", "add_prefix_space": False}
    bpe = load_tokenizer(json.dumps(spec), "python")
    assert isinstance(bpe, ByteLevelBPETokenizer) and bpe.encode("ab") == [2]
    spec["model"]["type"] = "Unigram"
    with pytest.raises(ValueError):
        load_tokenizer(json.dumps(spec), "python")


# --- SentencePiece Unigram (DeBERTa-v3 / XLM-R tokenizer.json) -----------------

UNIGRAM_TEXTS = [
    "hello world", "Hello World", "the quick brown fox jumps over the lazy dog",
    "It's the quick brown fox; don't they'll we've I'm you're 123 42.",
    "Café déjà vu — naïve résumé!", "你好世界 中文 模型", "日本語 テスト です",
    "  leading and   multiple   spaces  ", "", " ", "a", "▁already▁metaspaced",
    "tab\tand\nnewline", "punct!!! ... ??? ,,,", "number 3.14159 and -42 and 1e10",
    "ümlaut Über straße", "unknownglyphs ☃❤ snowman heart", "ZAQWSXCDE rare uppercase run",
    "``quoted''  twice", "ﬁne ﬂour ½ cup №5", "ｆｕｌｌ ｗｉｄｔｈ", "ạ́ marks", "x² + y²",
]
UNIGRAM_ALPHABET = ("abcdefghijklmnopqrstuvwxyzABCDE 0123456789.,!?'\"- "
                    "你好世界中文模型éüßñÉÎ▁ \tﬁ½№☃①ａ")


def _unigram_blobs() -> dict:
    from embedding_cpp_tpu.tokenizer.testvocab import (
        build_albert_tokenizer_json,
        build_unigram_tokenizer_json,
    )
    from test_unigram_tokenizer import _CHARSMAP, build_charsmap_blob
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers

    trained = json.loads(build_unigram_tokenizer_json(600))
    precompiled = Tokenizer(models.Unigram(
        [tuple(p) for p in trained["model"]["vocab"]], unk_id=trained["model"]["unk_id"],
        byte_fallback=False))
    precompiled.normalizer = normalizers.Precompiled(build_charsmap_blob(_CHARSMAP))
    precompiled.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁")
    return {"trained": build_unigram_tokenizer_json(600),
            "albert": build_albert_tokenizer_json(400),
            "precompiled": precompiled.to_str().encode()}


@pytest.mark.parametrize("blob", ["trained", "albert", "precompiled"])
def test_unigram_encodes_match_jax(blob):
    pytest.importorskip("tokenizers")
    from embedding_cpp_tpu.tokenizer.unigram import UnigramTokenizer as JUnigram
    from embedding_cpp_tpu_torch.tokenizer import UnigramTokenizer, load_tokenizer

    data = _unigram_blobs()[blob]
    ours, theirs = load_tokenizer(data, "python"), JUnigram(data)
    assert isinstance(ours, UnigramTokenizer)
    if blob == "precompiled":
        assert json.loads(data)["normalizer"]["type"] == "Precompiled"
    rng = random.Random(3)
    fuzz = ["".join(rng.choice(UNIGRAM_ALPHABET) for _ in range(rng.randint(0, 40)))
            for _ in range(300)]
    for text in UNIGRAM_TEXTS + fuzz:
        ids = ours.encode(text)
        assert ids == theirs.encode(text), repr(text)
        assert [ours.id_to_token(i) for i in ids] == [theirs.id_to_token(i) for i in ids]
    assert ours.encode_batch(UNIGRAM_TEXTS) == theirs.encode_batch(UNIGRAM_TEXTS)
