"""The port's Engine against the JAX package's Engine on one tiny GGUF
written by the JAX package's `make_test_model`: the same token ids, and
`encode` within 2e-5 with f32 activations, on a packed corpus (>= 32 short
sentences) and an unpacked one (< 32 sentences of mixed lengths)."""
import contextlib

import numpy as np
import pytest
import torch
from torch_native import has_compiler, jax_native

from embedding_cpp_tpu.cli.make_test_model import make_test_model
from embedding_cpp_tpu.runtime.engine import Engine as JEngine
from embedding_cpp_tpu_torch import Engine
from embedding_cpp_tpu_torch.models import MINILM_L6, ComputeOptions
from embedding_cpp_tpu_torch.runtime.batching import pack_segments
from embedding_cpp_tpu_torch.tokenizer.testvocab import _COMMON_WORDS

ATOL = 2e-5


def _sentences(n: int, lo: int, hi: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    words = np.array(_COMMON_WORDS)
    return [" ".join(rng.choice(words, size=int(rng.integers(lo, hi))))
            for _ in range(n)]


PACKED = _sentences(40, 3, 14, seed=0)  # short: the engine packs these
# mixed lengths, one over the 128-token context (framing cuts it, SEP last)
UNPACKED = _sentences(12, 3, 110, seed=1) + [
    "", "Hello, World!  Ünïcödé 中文", " ".join(["word"] * 200)]


@pytest.fixture(scope="module", params=["f32", "q4_0"])
def engines(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gguf") / f"tiny-{request.param}.gguf")
    make_test_model(path, "tiny", request.param, seed=0)
    return Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)


@pytest.mark.parametrize("texts", [PACKED, UNPACKED], ids=["packed", "unpacked"])
def test_token_ids_match(engines, texts):
    ours, theirs = engines
    assert ours.tokenize_batch(texts) == theirs.tokenize_batch(texts)


@pytest.mark.parametrize("texts", [PACKED, UNPACKED], ids=["packed", "unpacked"])
def test_encode_matches_jax(engines, texts):
    ours, theirs = engines
    assert ours._pack_plan(ours.tokenize_batch(texts)) == theirs._pack_plan(
        theirs.tokenize_batch(texts))
    got = ours.encode(texts)
    ref = theirs.encode(texts)
    assert got.shape == ref.shape == (len(texts), 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_packed_corpus_takes_the_packed_path(engines):
    ours, _ = engines
    ids = ours.tokenize_batch(PACKED)
    assert ours._pack_plan(ids) == list(range(len(PACKED)))
    never = Engine(ours.params, ours.config, ours.tokenizer, ours.special_ids,
                   device="cpu", packing="never")
    np.testing.assert_allclose(never.embed_tokens(ids), ours.embed_tokens(ids),
                               rtol=0, atol=1e-5)


def test_int8_output_round_trips(engines):
    """int8 transfer keeps direction: cosine >= 0.999 against f32 at this
    64-wide model (one code step is 1/127 of the largest component)."""
    ours, _ = engines
    i8 = Engine(ours.params, ours.config, ours.tokenizer, ours.special_ids,
                device="cpu", opts=ComputeOptions(output_dtype="int8"))
    a, b = i8.encode(PACKED), ours.encode(PACKED)
    cos = np.sum(a * b, -1) / np.linalg.norm(a, axis=-1)
    assert cos.min() >= 0.999


def test_over_context_text_is_cut_to_n_ctx(engines):
    ours, _ = engines
    ids = ours.tokenize_batch([UNPACKED[-1]])[0]
    assert len(ids) == ours.config.n_ctx and ids[-1] == ours.special_ids.sep


def test_engine_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError):
        Engine.synthetic(MINILM_L6)
    with pytest.raises(RuntimeError):
        Engine({}, MINILM_L6)


def test_synthetic_engine_on_cpu_serves_the_minilm_vocab():
    from dataclasses import replace

    config = replace(MINILM_L6, n_vocab=1000, n_layer=1)
    eng = Engine.synthetic(config, "q4_0", device="cpu")
    out = eng.encode(PACKED[:3])
    assert out.shape == (3, 384)
    np.testing.assert_allclose(np.linalg.norm(out, axis=-1), 1.0, atol=1e-5)


def test_pack_segments_matches_jax():
    from embedding_cpp_tpu.runtime.batching import pack_segments as jax_pack

    lists = [list(range(1, 3 + (i * 7) % 60)) for i in range(300)]
    idx = list(range(300))
    ours = pack_segments(lists, idx, 0)
    theirs = jax_pack(lists, idx, 0)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        for f in ("ids", "seg", "pos", "orig", "slots"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.positions == b.positions and a.n_seg == b.n_seg


@pytest.fixture(scope="module")
def modernbert_engines(tmp_path_factory):
    """A tiny-modernbert Q4_0 GGUF (byte-level BPE tokenizer.json) through
    both engines."""
    pytest.importorskip("tokenizers")
    path = str(tmp_path_factory.mktemp("gguf") / "tiny-modernbert-q4_0.gguf")
    make_test_model(path, "tiny-modernbert", "q4_0", seed=0)
    return Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)


@pytest.mark.parametrize("texts", [PACKED, UNPACKED], ids=["packed", "unpacked"])
def test_modernbert_encode_matches_jax(modernbert_engines, texts):
    ours, theirs = modernbert_engines
    assert ours.config.arch == "modernbert"
    assert ours.tokenize_batch(texts) == theirs.tokenize_batch(texts)
    got, ref = ours.encode(texts), theirs.encode(texts)
    assert got.shape == ref.shape == (len(texts), 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_long_context_buckets_match_jax():
    """n_ctx 8192: the default buckets extend in powers of two to the
    context, as the JAX engine extends them."""
    from dataclasses import replace

    from embedding_cpp_tpu.models.config import MODERNBERT_BASE as J_MODERNBERT_BASE
    from embedding_cpp_tpu_torch.models import MODERNBERT_BASE
    from embedding_cpp_tpu_torch.runtime.engine import long_seq_buckets

    theirs = JEngine({}, replace(J_MODERNBERT_BASE, n_vocab=1000))
    ours = Engine({}, replace(MODERNBERT_BASE, n_vocab=1000), device="cpu")
    assert ours.seq_buckets == theirs.seq_buckets == (
        16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
    assert ours.max_batch_tokens == theirs.max_batch_tokens
    for n_ctx in (8, 100, 128, 512, 3000):
        assert long_seq_buckets(n_ctx) == JEngine(
            {}, replace(J_MODERNBERT_BASE, n_ctx=n_ctx)).seq_buckets


@pytest.fixture(scope="module")
def deberta_engines(tmp_path_factory):
    """tiny-deberta and tiny-deberta-reranker Q4_0 GGUFs (SentencePiece
    Unigram tokenizer.json, trained by the HF `tokenizers` library) through
    both engines, the JAX one with a native tokenizer library wherever the
    port can build one."""
    pytest.importorskip("tokenizers")
    out = {}
    for preset in ("tiny-deberta", "tiny-deberta-reranker"):
        path = str(tmp_path_factory.mktemp("gguf") / f"{preset}-q4_0.gguf")
        make_test_model(path, preset, "q4_0", seed=0)
        with jax_native("tokenizer") if has_compiler() else contextlib.nullcontext():
            theirs = JEngine.from_gguf(path)
        out[preset] = (Engine.from_gguf(path, device="cpu"), theirs)
    return out


@pytest.mark.parametrize("texts", [PACKED, UNPACKED], ids=["packed", "unpacked"])
def test_deberta_encode_matches_jax(deberta_engines, texts):
    ours, theirs = deberta_engines["tiny-deberta"]
    assert ours.config.arch == "deberta" and ours.config.rel_attn_buckets == 32
    # the same backend as the JAX loader's pick ("auto": native, else HF, else Python)
    assert type(ours.tokenizer).__name__ == type(theirs.tokenizer).__name__
    assert ours.tokenize_batch(texts) == theirs.tokenize_batch(texts)
    got, ref = ours.encode(texts), theirs.encode(texts)
    assert got.shape == ref.shape == (len(texts), 64)
    cos = np.sum(got * ref, -1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert cos.min() >= 0.99999
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_deberta_rerank_matches_jax(deberta_engines):
    ours, theirs = deberta_engines["tiny-deberta-reranker"]
    assert (ours.config.n_labels, ours.config.head_activation) == (1, "gelu")
    query = "the quick brown fox"
    docs = UNPACKED[:10] + ["the quick brown fox jumps", "a lazy dog"]
    assert ours.tokenize_pairs([(query, d) for d in docs]) == theirs.tokenize_pairs(
        [(query, d) for d in docs])
    got, ref = ours.rerank(query, docs), theirs.rerank(query, docs)
    assert [r["index"] for r in got] == [r["index"] for r in ref]
    np.testing.assert_allclose([r["relevance_score"] for r in got],
                               [r["relevance_score"] for r in ref], rtol=0, atol=1e-4)
    top = ours.rerank(query, docs, top_n=3)
    assert top == got[:3]
    logits = ours.score_pairs([(query, d) for d in docs])
    assert logits.shape == (len(docs),)
    np.testing.assert_allclose(logits, theirs.score_pairs([(query, d) for d in docs]),
                               rtol=0, atol=1e-4)


def test_score_plan_runs_real_rows_only():
    """The score path's batches are the JAX plan's length buckets cut to
    their real rows: no row is padded up to a row bucket."""
    from embedding_cpp_tpu.runtime.batching import pack_batches as jax_pack

    lists = [list(range(2, 4 + (i * 13) % 140)) for i in range(300)]
    eng = Engine({}, MINILM_L6, device="cpu")
    ours = eng.score_plan(lists)
    theirs = jax_pack(lists, eng.special_ids.pad, seq_buckets=eng.seq_buckets,
                      max_seq=512, max_tokens=eng.max_batch_tokens)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        n = len(b.positions)
        assert a.positions == b.positions and a.ids.shape == (n, b.ids.shape[1])
        np.testing.assert_array_equal(a.ids, b.ids[:n])
        np.testing.assert_array_equal(a.mask, b.mask[:n])
    assert sum(a.ids.shape[0] for a in ours) == len(lists)


def test_rerank_needs_a_classification_head(deberta_engines):
    ours, _ = deberta_engines["tiny-deberta"]
    with pytest.raises(RuntimeError):
        ours.rerank("a query", ["a document"])


def test_pair_framing_matches_jax():
    from embedding_cpp_tpu.tokenizer.base import SpecialIds as JSpecialIds
    from embedding_cpp_tpu.tokenizer.base import frame_pair_ids as jax_frame_pair_ids
    from embedding_cpp_tpu_torch.tokenizer import SpecialIds, frame_pair_ids

    ours_s, theirs_s = SpecialIds(cls=2, sep=3, pad=0, unk=1), JSpecialIds(2, 3, 0, 1)
    for la in (0, 1, 5, 20, 40):
        for lb in (0, 3, 20, 61):
            a, b = list(range(10, 10 + la)), list(range(100, 100 + lb))
            for n_max in (8, 24, 64):
                ours = frame_pair_ids(a, b, ours_s, n_max)
                assert ours == jax_frame_pair_ids(a, b, theirs_s, n_max)
                assert len(ours[0]) == len(ours[1]) <= n_max


# the families whose packed rows pass 1024 tokens, at a small width: two
# layers (ModernBERT one global and one local, window 128), two heads of 32
_LONG_PACKED = {
    "modernbert": dict(n_vocab=1000, n_ctx=4096, n_embd=64, n_layer=2, n_head=2, n_ff=128,
                       n_token_types=0, arch="modernbert", layer_norm_eps=1e-5,
                       rope_theta=160000.0, local_rope_theta=10000.0, global_attn_every=2,
                       local_window=128),
    "nomic-bert": dict(n_vocab=1000, n_ctx=4096, n_embd=64, n_layer=2, n_head=2, n_ff=128,
                       arch="nomic-bert", rope_theta=1000.0, rope_scaling_factor=2.0,
                       rope_max_trained=128, attn_bias=False, ffn_bias=False)}


def _packed_rows_match_jax(arch: str, pack_seq: int, packing: str) -> None:
    """Synthetic engines of both packages (same seed, same weights) at
    `pack_seq`: the same plan, every list packed, and embed_tokens within
    2e-5 on rows of one or two packed rows of pack_seq tokens."""
    from embedding_cpp_tpu.models.config import BertConfig as JConfig
    from embedding_cpp_tpu_torch.models import BertConfig

    small = _LONG_PACKED[arch]
    ours = Engine.synthetic(BertConfig(**small), "f32", seed=0, device="cpu",
                            pack_seq=pack_seq, packing=packing)
    theirs = JEngine.synthetic(JConfig(**small), "f32", seed=0, pack_seq=pack_seq,
                               packing=packing)
    rng = np.random.default_rng(pack_seq)
    n, hi = (34, 60) if packing == "auto" else (5, pack_seq // 3)
    lists = [[2] + rng.integers(5, 1000, int(m) - 2).tolist() + [3]
             for m in rng.integers(20, hi, n)]
    plan = ours._pack_plan(lists)
    assert plan == theirs._pack_plan(lists) == list(range(n))
    np.testing.assert_allclose(ours.embed_tokens(lists), theirs.embed_tokens(lists),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("pack_seq,packing,refused", [
    (2048, "auto", True), (1025, "always", True), (2048, "never", False),
    (1024, "auto", False), (None, "auto", False)])
def test_modernbert_refuses_packed_rows_past_1024(pack_seq, packing, refused):
    """Named for the refusal it replaced: ModernBERT packed rows past 1024
    tokens are served (global layers on K6, local layers on the segment +
    sliding-window mode of the long-row kernel; S % 8 != 0 padded), so
    every configuration is accepted when the engine is built, and where it
    used to be refused (`refused`) the packed forward matches the JAX
    Engine's XLA path."""
    from dataclasses import replace

    from embedding_cpp_tpu_torch.models import MODERNBERT_BASE

    config = replace(MODERNBERT_BASE, n_vocab=1000)
    eng = Engine({}, config, device="cpu", pack_seq=pack_seq, packing=packing)
    assert eng.pack_seq == (pack_seq or 512)
    if refused:
        _packed_rows_match_jax("modernbert", pack_seq, packing)


@pytest.mark.parametrize("pack_seq,packing,refused", [
    (1500, "auto", True), (1500, "always", True), (1500, "never", False),
    (1504, "auto", False), (1000, "auto", False)])
def test_nomic_refuses_unaligned_packed_rows_past_1024(pack_seq, packing, refused):
    """Named for the refusal it replaced: nomic-bert packed rows past 1024
    tokens with S % 8 != 0 (XLA in the JAX package) run K6 padded to a
    multiple of 8 inside the attention call, so every pack_seq is accepted,
    and where it used to be refused (`refused`) the packed forward matches
    the JAX Engine's."""
    from dataclasses import replace

    from embedding_cpp_tpu_torch.models import NOMIC_EMBED

    config = replace(NOMIC_EMBED, n_vocab=1000)
    eng = Engine({}, config, device="cpu", pack_seq=pack_seq, packing=packing)
    assert eng.pack_seq == pack_seq
    if refused:
        _packed_rows_match_jax("nomic-bert", pack_seq, packing)


# --- the bert.h surface: tokenize, n_max_tokens, id_to_token, decode, stats ---

def test_bert_h_members_match_jax(engines):
    ours, theirs = engines
    assert ours.n_max_tokens == theirs.n_max_tokens == ours.config.n_ctx
    for text in UNPACKED + PACKED[:5]:
        ids = ours.tokenize(text)
        assert ids == theirs.tokenize(text)
        assert ours.decode(ids) == theirs.decode(ids)
    for i in (0, 1, 2, 3, 7, 150, 999, 1000, 10**6):
        assert ours.id_to_token(i) == theirs.id_to_token(i)


@pytest.mark.parametrize("family", ["modernbert", "deberta"])
def test_decode_matches_jax_on_bpe_and_unigram(modernbert_engines, deberta_engines, family):
    ours, theirs = (modernbert_engines if family == "modernbert"
                    else deberta_engines["tiny-deberta"])
    for text in UNPACKED[:6] + ["Hello, World!  Ünïcödé 中文"]:
        ids = theirs.tokenize(text)
        assert ours.tokenize(text) == ids
        assert ours.decode(ids) == theirs.decode(ids)
        assert [ours.id_to_token(i) for i in ids] == [theirs.id_to_token(i) for i in ids]


def test_embed_tokens_counts_sentences_tokens_batches(engines):
    from embedding_cpp_tpu_torch.utils.metrics import GLOBAL as metrics

    ours, _ = engines
    ids = ours.tokenize_batch(PACKED + UNPACKED)
    before, snap0 = dict(ours.stats), metrics.snapshot()["counters"]
    ours.embed_tokens(ids)
    after, snap1 = ours.stats, metrics.snapshot()["counters"]
    n_tokens = sum(len(t) for t in ids)
    assert after["sentences"] - before["sentences"] == len(ids)
    assert after["tokens"] - before["tokens"] == n_tokens
    assert after["batches"] - before["batches"] >= 2  # one packed, plain buckets
    assert after["eval_time"] > before["eval_time"]
    for key, want in (("sentences", len(ids)), ("tokens", n_tokens)):
        assert snap1[key] - snap0.get(key, 0) == want
    assert snap1["padded_slots"] - snap0.get("padded_slots", 0) >= n_tokens


# --- architecture names (the reference's config.py:290-292) --------------------

def _kv(arch: str) -> dict:
    from embedding_cpp_tpu_torch.gguf import Keys

    return {Keys.ARCHITECTURE: arch, Keys.TOKENIZER_LIST: ["a"] * 50,
            Keys.CONTEXT_LENGTH: 128, Keys.EMBEDDING_LENGTH: 64, Keys.BLOCK_COUNT: 2,
            Keys.HEAD_COUNT: 4, Keys.FEED_FORWARD_LENGTH: 128}


@pytest.mark.parametrize("arch", ["xlm-roberta", "jina-bert-v2"])
def test_unknown_architecture_reads_as_bert_on_both_sides(arch):
    from dataclasses import fields

    from embedding_cpp_tpu.models.config import BertConfig as JConfig
    from embedding_cpp_tpu_torch.models import BertConfig

    ours, theirs = BertConfig.from_gguf_kv(_kv(arch)), JConfig.from_gguf_kv(_kv(arch))
    assert ours.arch == theirs.arch == "bert"
    for f in fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


@pytest.mark.parametrize("arch", ["mpnet", "t5", "albert"])
def test_known_unported_architecture_is_still_refused(arch):
    """The reference's last three families, once refused by name, now read
    field by field as the JAX package reads them; a name neither package
    knows still reads as BERT (above), and a config naming it is refused."""
    from dataclasses import fields

    from embedding_cpp_tpu.models.config import BertConfig as JConfig
    from embedding_cpp_tpu_torch.models import BertConfig

    ours, theirs = BertConfig.from_gguf_kv(_kv(arch)), JConfig.from_gguf_kv(_kv(arch))
    assert ours.arch == theirs.arch == arch
    for f in fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    for config in (BertConfig, JConfig):
        with pytest.raises(ValueError, match="unsupported architecture 'gpt2'"):
            config(n_vocab=50, n_ctx=16, n_embd=64, n_layer=1, n_head=4, n_ff=64, arch="gpt2")


def test_xlm_roberta_named_gguf_loads_as_bert(tmp_path, monkeypatch):
    """A BERT GGUF whose general.architecture says "xlm-roberta" loads in
    both packages as BERT and encodes alike."""
    import embedding_cpp_tpu.models.convert as convert
    from embedding_cpp_tpu.gguf.constants import Keys as JKeys
    from embedding_cpp_tpu.models.config import BertConfig as JConfig
    from embedding_cpp_tpu.models.params import random_state_dict
    from embedding_cpp_tpu.tokenizer.testvocab import build_tokenizer_json

    class Writer(convert.GGUFWriter):
        def add_string(self, key, value):
            super().add_string(key, "xlm-roberta" if key == JKeys.ARCHITECTURE else value)

    monkeypatch.setattr(convert, "GGUFWriter", Writer)
    config = JConfig(n_vocab=300, n_ctx=128, n_embd=64, n_layer=2, n_head=4, n_ff=128,
                     name="tiny-xlmr-named")
    path = str(tmp_path / "xlmr.gguf")
    convert.write_bert_gguf(path, config, random_state_dict(config, seed=0),
                            build_tokenizer_json(config.n_vocab))
    from embedding_cpp_tpu.gguf.reader import GGUFReader as JReader

    with JReader(path) as r:
        assert r.kv[JKeys.ARCHITECTURE] == "xlm-roberta"
    ours, theirs = Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)
    assert ours.config.arch == theirs.config.arch == "bert"
    np.testing.assert_allclose(ours.encode(UNPACKED), theirs.encode(UNPACKED),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("bad", [-1, 10**6], ids=["negative", "past-the-vocab"])
@pytest.mark.parametrize("n_lists", [3, 40], ids=["plain", "packed"])
def test_embed_tokens_refuses_ids_outside_the_vocab(engines, n_lists, bad):
    """An id outside 0..n_vocab-1 raises before anything launches, on the
    plain and the packed path (a gather past the table would lose the
    CUDA context on the card); the engine then still serves."""
    ours, _ = engines
    good = [[2, 5 + i % 7, 3] for i in range(n_lists)]
    assert (len(ours._pack_plan(good)) > 0) == (n_lists >= 32)
    wrong = [list(t) for t in good]
    wrong[-1][1] = bad
    with pytest.raises(ValueError, match=f"token id {bad} outside 0..{ours.config.n_vocab - 1}"):
        ours.embed_tokens(wrong)
    assert np.isfinite(ours.embed_tokens(good)).all()


def test_score_token_pairs_refuses_ids_and_types_outside_their_tables():
    from dataclasses import replace

    config = replace(MINILM_L6, n_vocab=300, n_embd=64, n_head=4, n_ff=128, n_layer=2,
                     n_ctx=128, n_labels=1)
    eng = Engine.synthetic(config, "f32", device="cpu")
    ids, types = [[2, 7, 3, 9, 3]], [[0, 0, 0, 1, 1]]
    want = eng.score_token_pairs(ids, types)
    with pytest.raises(ValueError, match="token id 300 outside 0..299"):
        eng.score_token_pairs([[2, 300, 3, 9, 3]], types)
    with pytest.raises(ValueError, match="token type id 2 outside 0..1"):
        eng.score_token_pairs(ids, [[0, 0, 0, 2, 2]])
    with pytest.raises(ValueError, match="token type id -1 outside 0..1"):
        eng.score_token_pairs(ids, [[0, 0, 0, -1, 1]])
    np.testing.assert_array_equal(eng.score_token_pairs(ids, types), want)
