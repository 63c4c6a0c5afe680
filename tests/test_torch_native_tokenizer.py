"""The port's NativeTokenizer (the C++ engines of `native/tokenizer`, built
by `utils/native_build.py`) against the JAX package's NativeTokenizer and
the port's pure-Python engines: ids, tokens and `decode` on the WordPiece,
byte-level BPE, Unigram and ALBERT test vocabularies over the fuzz corpus,
seeded random strings and invalid UTF-8; `load_tokenizer("auto")` on every
tiny preset's tokenizer.json against the JAX loader's pick; hostile blobs
refused with ValueError; the fall-through of Unigram shapes the native
engine refuses; the `hf` backend against the JAX one; threads sharing one
instance; and the Engine's consumers of the int32 arrays `encode_batch`
returns."""
import json
import random
import threading

import numpy as np
import pytest
from torch_native import jax_native, needs_compiler

pytestmark = needs_compiler

VOCABS = ("wordpiece", "bpe", "unigram", "albert")
ALPHABET = ("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
            " \t\n.,!?;:'\"()[]{}@#$%^&*-_+=~`|\\/<>éüßñÉÎ▁你好世界ﬁ½№☃①ａ")


def _corpus() -> list[str]:
    from corpus import FUZZ_CORPUS

    rng = random.Random(7)
    fuzz = ["".join(rng.choice(ALPHABET) for _ in range(rng.randint(0, 60)))
            for _ in range(150)]
    return list(FUZZ_CORPUS) + fuzz + ["x" * 9000, "hello " * 2000]


@pytest.fixture(scope="module")
def blobs():
    """One tokenizer.json per test vocabulary (the trained ones need the HF
    `tokenizers` library; each is trained once and shared by both
    packages, since HF's Unigram trainer varies from run to run)."""
    from embedding_cpp_tpu_torch.tokenizer import testvocab

    out = {"wordpiece": testvocab.build_tokenizer_json(1000)}
    try:
        out["bpe"] = testvocab.build_bpe_tokenizer_json(600)
        out["unigram"] = testvocab.build_unigram_tokenizer_json(600)
        out["albert"] = testvocab.build_albert_tokenizer_json(400)
    except ImportError:
        pass
    return out


@pytest.fixture(scope="module")
def tokenizers(blobs):
    """vocab -> (port native, JAX native, port pure-Python engine)."""
    from embedding_cpp_tpu_torch.tokenizer import load_tokenizer
    from embedding_cpp_tpu_torch.tokenizer.native import NativeTokenizer

    out = {}
    with jax_native("tokenizer") as jnative:
        for name, blob in blobs.items():
            out[name] = (NativeTokenizer(blob), jnative.NativeTokenizer(blob),
                         load_tokenizer(blob, "python"))
    return out


def _get(tokenizers, vocab):
    if vocab not in tokenizers:
        pytest.skip("the trained vocabularies need the HF tokenizers library")
    return tokenizers[vocab]


@pytest.mark.parametrize("vocab", VOCABS)
def test_ids_match_jax_native_and_python(tokenizers, vocab):
    ours, theirs, py = _get(tokenizers, vocab)
    texts = _corpus()
    got = ours.encode_batch(texts)
    assert all(isinstance(g, np.ndarray) and g.dtype == np.int32 for g in got)
    got = [g.tolist() for g in got]
    assert got == [t.tolist() for t in theirs.encode_batch(texts)]
    assert got == py.encode_batch(texts)
    for text, ids in zip(texts[:60], got):
        assert ours.encode(text) == ids == theirs.encode(text)


@pytest.mark.parametrize("vocab", VOCABS)
def test_tokens_and_decode_match(tokenizers, vocab):
    ours, theirs, py = _get(tokenizers, vocab)
    n = max(py._id_to_token) + 1 if hasattr(py, "_id_to_token") else 1000
    for i in list(range(n)) + [-1, n, n + 10_000]:
        assert ours.id_to_token(i) == theirs.id_to_token(i) == py.id_to_token(i), i
    for text in _corpus()[:80]:
        ids = ours.encode(text)
        assert ours.decode(ids) == theirs.decode(ids) == py.decode(ids), text
        assert ours.decode(np.asarray(ids, np.int32)) == ours.decode(ids)


@pytest.mark.parametrize("vocab", VOCABS)
def test_invalid_utf8_does_not_crash(tokenizers, vocab):
    """Bytes that are not UTF-8 reach the library only through the C ABI
    (a str always encodes): they tokenize as the JAX binding's do."""
    import ctypes

    ours, theirs, _ = _get(tokenizers, vocab)
    for raw in (b"hello \xff\xfe world", b"\xc3", b"\xed\xa0\x80 x", b"\x80" * 50):
        out = []
        for tok in (ours, theirs):
            buf = (ctypes.c_int32 * 256)()
            n = tok._lib.tpuembed_encode(tok._handle, raw, len(raw), buf, 256)
            assert n >= 0
            out.append(list(buf[:n]))
        assert out[0] == out[1]


def test_long_text_grows_the_buffer(tokenizers):
    ours, theirs, _ = tokenizers["wordpiece"]
    text = "hello world " * 6000  # 12000 ids, past the first 8192-id buffer
    ids = ours.encode(text)
    assert len(ids) == 12000 and ids == theirs.encode(text)


def test_threads_share_one_instance(tokenizers):
    """Each call owns its buffer: eight threads encoding at once get what
    one thread gets."""
    ours, _, _ = tokenizers["wordpiece"]
    texts = _corpus()
    want = [ours.encode(t) for t in texts]
    got, errors = {}, []

    def work(k):
        try:
            got[k] = [ours.encode(t) for t in texts[k::8]]
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for k in range(8):
        assert got[k] == want[k::8]


def _hostile() -> list[bytes]:
    unigram = {"model": {"type": "Unigram", "unk_id": 0, "vocab": [["<unk>", 0.0]]},
               "pre_tokenizer": {"type": "Metaspace"}}
    bad_charsmap = json.loads(json.dumps(unigram))
    bad_charsmap["normalizer"] = {"type": "Precompiled", "precompiled_charsmap": "!!x!!"}
    return [s.encode() if isinstance(s, str) else s for s in (
        '{"model": {"type": "BPE"}}',
        '{"model":{"type":"WordPiece","vocab":{"a":-1}}}',
        '{"model":{"type":"WordPiece","vocab":{"a":999999999}}}',
        '{"added_tokens":[{"id":-5,"content":"x"}],'
        '"model":{"type":"WordPiece","vocab":{"[UNK]":0},"unk_token":"[UNK]"}}',
        '{"model":{"type":"WordPiece","vocab":{"a":0}},"x":1e999}',
        '{"model":{"type":"Unigram","vocab":{"a":0}},"pre_tokenizer":{"type":"Metaspace"}}',
        json.dumps({**unigram, "model": {**unigram["model"], "unk_id": 99}}),
        json.dumps(bad_charsmap),
        b"\xff\xfe not json", b"", b"[]",
    )]


@pytest.mark.parametrize("blob", _hostile(), ids=range(len(_hostile())))
def test_hostile_blob_is_refused(blob):
    from embedding_cpp_tpu_torch.tokenizer.native import NativeTokenizer

    with pytest.raises(ValueError):
        NativeTokenizer(blob)
    with jax_native("tokenizer") as jnative, pytest.raises(ValueError):
        jnative.NativeTokenizer(blob)


def test_unsupported_unigram_shapes_fall_through():
    """Shapes the native engine refuses load from the next backend under
    "auto", and raise under "native", as in the JAX loader."""
    from embedding_cpp_tpu.tokenizer import load_tokenizer as jload
    from embedding_cpp_tpu_torch.tokenizer import load_tokenizer
    from embedding_cpp_tpu_torch.tokenizer.native import NativeTokenizer

    base = {"model": {"type": "Unigram", "unk_id": 0, "vocab": [["<unk>", 0.0], ["a", -1.0]]},
            "pre_tokenizer": {"type": "Metaspace", "replacement": "▁"}}
    shapes = [{**base, "normalizer": {"type": "NFKC"}},
              {**base, "normalizer": {"type": "Replace", "pattern": {"Regex": "a+"},
                                      "content": "a"}},
              {**base, "pre_tokenizer": {"type": "Metaspace", "replacement": "ab"}}]
    for spec in shapes:
        blob = json.dumps(spec).encode()
        with pytest.raises(ValueError):
            load_tokenizer(blob, "native")
        ours = load_tokenizer(blob)
        assert not isinstance(ours, NativeTokenizer)
        with jax_native("tokenizer"):
            theirs = jload(blob)
        assert type(ours).__name__ == type(theirs).__name__
        assert ours.encode("a aa") == list(theirs.encode("a aa"))


def test_unknown_backend_is_refused(blobs):
    from embedding_cpp_tpu_torch.tokenizer import load_tokenizer

    with pytest.raises(ValueError, match="backend"):
        load_tokenizer(blobs["wordpiece"], "rust")


def _presets() -> list[str]:
    from embedding_cpp_tpu.cli.make_test_model import PRESETS as JPRESETS
    from embedding_cpp_tpu_torch.cli.make_test_model import PRESETS

    return sorted(p for p in PRESETS if p.startswith("tiny") and p in JPRESETS)


@pytest.fixture(scope="module")
def preset_blobs():
    """Each tiny preset's tokenizer.json, one per distinct vocabulary
    builder (the Unigram and BPE presets train theirs)."""
    from embedding_cpp_tpu_torch.cli.make_test_model import _preset_vocab

    cache = {}

    def get(preset):
        if preset not in cache:
            try:
                cache[preset] = _preset_vocab(preset)[1]
            except ImportError:
                pytest.skip("the trained vocabularies need the HF tokenizers library")
        return cache[preset]
    return get


@pytest.mark.parametrize("preset", _presets())
def test_auto_picks_the_counterpart_backend(preset_blobs, preset):
    from embedding_cpp_tpu.tokenizer import load_tokenizer as jload
    from embedding_cpp_tpu_torch.tokenizer import load_tokenizer

    blob = preset_blobs(preset)
    ours = load_tokenizer(blob)
    with jax_native("tokenizer"):
        theirs = jload(blob)
    assert type(ours).__name__ == type(theirs).__name__
    texts = _corpus()[:40]
    assert [list(map(int, t)) for t in ours.encode_batch(texts)] == [
        list(map(int, t)) for t in theirs.encode_batch(texts)]


@pytest.mark.parametrize("vocab", VOCABS)
def test_hf_backend_matches_jax_hf(blobs, vocab):
    pytest.importorskip("tokenizers")
    from embedding_cpp_tpu.tokenizer.hf import HFTokenizer as JHF
    from embedding_cpp_tpu_torch.tokenizer import load_tokenizer
    from embedding_cpp_tpu_torch.tokenizer.hf import HFTokenizer

    if vocab not in blobs:
        pytest.skip("no trained vocabulary")
    ours, theirs = load_tokenizer(blobs[vocab], "hf"), JHF(blobs[vocab])
    assert isinstance(ours, HFTokenizer)
    texts = _corpus()[:60]
    got = ours.encode_batch(texts)
    assert got == theirs.encode_batch(texts)
    for t, ids in zip(texts, got):
        assert ours.encode(t) == ids
        assert ours.decode(ids) == theirs.decode(ids)
    for i in (0, 1, 5, 50, 10**6):
        assert ours.id_to_token(i) == theirs.id_to_token(i)
    assert ours.token_to_id(ours.id_to_token(5)) == theirs.token_to_id(theirs.id_to_token(5))


@pytest.fixture(scope="module")
def gguf_engines(tmp_path_factory):
    """A tiny WordPiece GGUF loaded natively ("auto") and with the Python
    engine, and a tiny ColBERT one (its skiplist and framing)."""
    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.cli.make_test_model import make_test_model

    out = {}
    for preset in ("tiny", "tiny-colbert"):
        path = str(tmp_path_factory.mktemp("gguf") / f"{preset}.gguf")
        make_test_model(path, preset, "f32", seed=0)
        out[preset] = (Engine.from_gguf(path, device="cpu"),
                       Engine.from_gguf(path, device="cpu", tokenizer_backend="python"))
    return out


def test_engine_consumers_take_the_arrays(gguf_engines):
    """The native engine's int32 arrays give every consumer what the Python
    engine's lists give: framing, pairs, the pack plan, the token plan,
    encode and ColBERT's skiplist and framing."""
    from embedding_cpp_tpu_torch.tokenizer.native import NativeTokenizer
    from embedding_cpp_tpu_torch.tokenizer.wordpiece import WordPieceTokenizer

    nat, py = gguf_engines["tiny"]
    assert isinstance(nat.tokenizer, NativeTokenizer)
    assert isinstance(py.tokenizer, WordPieceTokenizer)
    texts = _corpus()[:48]
    ids = nat.tokenize_batch(texts)
    assert ids == py.tokenize_batch(texts)
    assert all(type(i) is int for t in ids for i in t)
    assert nat.tokenize(texts[3]) == py.tokenize(texts[3])
    pairs = list(zip(texts[:10], texts[10:20]))
    assert nat.tokenize_pairs(pairs) == py.tokenize_pairs(pairs)
    assert nat._pack_plan(ids) == py._pack_plan(ids)
    for a, b in zip(nat.token_plan(ids), py.token_plan(ids)):
        assert np.array_equal(a.ids, b.ids) and a.positions == b.positions
    np.testing.assert_array_equal(nat.encode(texts), py.encode(texts))
    got, counts = nat.encode_with_counts(texts)
    assert counts == py.encode_with_counts(texts)[1]
    with pytest.raises(ValueError):
        nat.tokenize_batch(["word " * 200], truncate=False)
    col_nat, col_py = gguf_engines["tiny-colbert"]
    assert col_nat.colbert_skiplist() == col_py.colbert_skiplist()
    assert col_nat.colbert_doc_tokens(texts) == col_py.colbert_doc_tokens(texts)
    assert np.array_equal(col_nat.colbert_query_ids(texts)[0], col_py.colbert_query_ids(texts)[0])


@pytest.mark.parametrize("vocab", ("unigram", "albert"))
def test_colbert_skiplist_on_unigram_vocabularies(gguf_engines, tokenizers, vocab):
    """ColBERT's skiplist and document framing over a Metaspace vocabulary,
    where every punctuation character is two ids ("▁", then the
    character): the native engine's arrays give the Python engine's
    skiplist, which is the first id of each character's `encode`, as the
    JAX Engine builds it."""
    import string

    from embedding_cpp_tpu_torch import Engine

    nat_tok, _, py_tok = _get(tokenizers, vocab)
    col = gguf_engines["tiny-colbert"][0]
    nat, py = (Engine(col.params, col.config, tok, col.special_ids, device="cpu")
               for tok in (nat_tok, py_tok))
    want = frozenset(py_tok.encode(ch)[0] for ch in string.punctuation if py_tok.encode(ch))
    assert nat.colbert_skiplist() == py.colbert_skiplist() == want
    texts = _corpus()[:48]
    assert nat.colbert_doc_tokens(texts) == py.colbert_doc_tokens(texts)
