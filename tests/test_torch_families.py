"""The BERT-graph families the port serves beside BERT — RoBERTa (and XLM-R,
its graph with a Unigram tokenizer), DistilBERT and ELECTRA (ELECTRA-small's
factorized embeddings) — against the JAX package, on its `make_test_model`
tiny presets (2 layers, 64 wide, 4 heads of 16, FFN 128; tiny-electra's
tables 32 wide) and their one-logit cross-encoder variants (RoBERTa's tanh
ClassificationHead, DistilBERT's relu pre_classifier, ELECTRA's gelu head).

- `from_gguf_kv` field by field, also on a file without
  `bert.position_offset` (RoBERTa then numbers positions from 2 on both
  sides); `random_state_dict` byte for byte; the parameters equal the JAX
  tree carried across by `from_jax_params` in f32 / Q4_0 / Q8_0.
- `bert_embed_batch` at S 16/64/128 and `bert_embed_packed` against the
  JAX forwards (the Pallas kernels in interpret mode at S 128 and on packed
  rows, as the JAX tests run them) within 2e-5 absolute in f32; bf16 with
  Q4_0 weights by cosine >= 0.999; a packed sentence equal to itself alone
  within 1e-5; `bert_score_batch` logits within 2e-5.
- Pair framing (the double separator for RoBERTa/XLM-R), special ids, and
  the Engine (`encode` packed and plain, `encode_queries` /
  `encode_documents` with e5's prompts and `dimensions`, `score_pairs`,
  `rerank`) against the JAX Engine on the tiny GGUFs; one rerank frame
  through the TCP server on the RoBERTa reranker.
"""
import dataclasses
import socket
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_params import assert_params_equal
from test_torch_server import _recv, _rerank_frame, serve_in_thread

from embedding_cpp_tpu.cli.make_test_model import PRESETS as J_PRESETS
from embedding_cpp_tpu.cli.make_test_model import make_test_model
from embedding_cpp_tpu.models.bert import ComputeOptions as JOpts
from embedding_cpp_tpu.models.bert import bert_embed_batch as jax_embed_batch
from embedding_cpp_tpu.models.bert import bert_embed_packed as jax_embed_packed
from embedding_cpp_tpu.models.bert import bert_score_batch as jax_score_batch
from embedding_cpp_tpu.models.config import DISTILBERT_BASE as J_DISTILBERT_BASE
from embedding_cpp_tpu.models.config import HEAD_ACT_DEFAULTS as J_HEAD_ACT
from embedding_cpp_tpu.models.config import BertConfig as JConfig
from embedding_cpp_tpu.models.convert import FTYPE_NAMES as J_FTYPES
from embedding_cpp_tpu.models.convert import write_bert_gguf
from embedding_cpp_tpu.models.params import random_params as jax_random_params
from embedding_cpp_tpu.models.params import random_state_dict as jax_random_state_dict
from embedding_cpp_tpu.runtime.engine import Engine as JEngine
from embedding_cpp_tpu.tokenizer.base import SpecialIds as JSpecialIds
from embedding_cpp_tpu.tokenizer.base import frame_pair_ids as jax_frame_pair_ids
from embedding_cpp_tpu_torch import Engine
from embedding_cpp_tpu_torch.gguf import GGUFReader, Keys
from embedding_cpp_tpu_torch.models import (
    ELECTRA_SMALL,
    MS_MARCO_ELECTRA_BASE,
    MULTI_QA_DISTILBERT,
    MULTILINGUAL_E5_BASE,
    BertConfig,
    ComputeOptions,
    bert_embed_batch,
    bert_embed_packed,
    bert_score_batch,
    from_jax_params,
    random_params,
    random_state_dict,
)
from embedding_cpp_tpu_torch.models import schema
from embedding_cpp_tpu_torch.models.config import UNPORTED_ARCHS
from embedding_cpp_tpu_torch.tokenizer import SpecialIds, frame_pair_ids
from embedding_cpp_tpu_torch.tokenizer.testvocab import _COMMON_WORDS

ATOL = 2e-5  # f32, the JAX package's own bar for its kernel paths
PACKED_ATOL = 1e-5  # a packed sentence against itself alone
COSINE = 0.999  # bf16 activations with Q4_0 weights
PRESETS = ["tiny-roberta", "tiny-xlmr", "tiny-distilbert", "tiny-electra"]
# one preset per graph: tiny-xlmr is tiny-roberta's geometry with another
# tokenizer, so the forwards run on three
ARCHS = {"roberta": "tiny-roberta", "distilbert": "tiny-distilbert",
         "electra": "tiny-electra"}
PALLAS = JOpts(dtype="float32", q4_impl="pallas", attn_impl="pallas")
SMALL_S = JOpts(dtype="float32", q4_impl="pallas", attn_impl="xla")


def _jconfig(preset: str, reranker: bool = False) -> JConfig:
    c = J_PRESETS[preset]
    if reranker:
        c = dataclasses.replace(c, n_labels=1,
                                head_activation=J_HEAD_ACT.get(c.arch, "tanh"),
                                name=c.name + "-reranker")
    return c


def _pconfig(jc: JConfig) -> BertConfig:
    return BertConfig(**{f.name: getattr(jc, f.name) for f in dataclasses.fields(BertConfig)})


def _bridge(tree) -> dict:
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, -1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def _batch(b: int, s: int, n_vocab: int, seed: int):
    """Row 0 full, row 1 a third long, the rest random lengths."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, n_vocab, (b, s)).astype(np.int32)
    lens = [s, max(1, s // 3)] + [int(n) for n in rng.integers(1, s + 1, b - 2)]
    mask = (np.arange(s)[None, :] < np.array(lens)[:, None]).astype(np.int32)
    ids[mask == 0] = 0
    return ids, mask


def _packed(s: int, n_vocab: int, seed: int):
    """Two rows of assorted segments with a -1 tail, and one padding row;
    row 0 opens with a 90-token segment, so RoBERTa's offset positions
    reach deep into its table."""
    rng = np.random.default_rng(seed)
    seg = np.full((3, s), -1, np.int32)
    pos = np.zeros((3, s), np.int32)
    for i in range(2):
        c = g = 0
        while c < s - 10:
            n = 90 if i == g == 0 else min(int(rng.integers(3, 40)), s - 4 - c)
            seg[i, c:c + n], pos[i, c:c + n] = g, np.arange(n)
            c, g = c + n, g + 1
    assert seg.max() < 16  # the slots the tests pool into
    ids = rng.integers(5, n_vocab, (3, s)).astype(np.int32)
    ids[seg < 0] = 0
    return ids, seg, pos


# --- configuration ------------------------------------------------------------------

@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    """Q4_0 GGUFs of the tiny presets and of their one-logit rerankers (the
    preset's tokenizer and vocab), written by the JAX package, made on
    first use."""
    root = tmp_path_factory.mktemp("families")
    made = {}

    def get(preset: str, reranker: bool = False) -> str:
        key = (preset, reranker)
        if key not in made:
            path = str(root / f"{preset}{'-reranker' if reranker else ''}.gguf")
            if reranker:
                with GGUFReader(get(preset)) as r:
                    blob = r.kv[Keys.TOKENIZER_JSON_BLOB]
                    n_vocab = len(r.kv[Keys.TOKENIZER_LIST])
                jc = dataclasses.replace(_jconfig(preset, True), n_vocab=n_vocab)
                write_bert_gguf(path, jc, jax_random_state_dict(jc, seed=0), blob,
                                J_FTYPES["q4_0"])
            else:
                make_test_model(path, preset, "q4_0", seed=0)
            made[key] = path
        return made[key]

    pytest.importorskip("tokenizers")  # the BPE and Unigram vocabs are trained
    return get


@pytest.mark.parametrize("drop", [(), (Keys.POSITION_OFFSET,),
                                  (Keys.POSITION_OFFSET, Keys.TOKEN_TYPE_COUNT)],
                         ids=["as-written", "no-offset", "no-offset-no-types"])
@pytest.mark.parametrize("preset", PRESETS)
def test_from_gguf_kv_matches_jax(ggufs, preset, drop):
    """Field by field, on the file's kv and with keys left out: the family's
    defaults fill them alike (RoBERTa: offset 2, one token-type row)."""
    with GGUFReader(ggufs(preset)) as r:
        kv = {k: v for k, v in r.kv.items() if k not in drop}
    ours, theirs = BertConfig.from_gguf_kv(kv), JConfig.from_gguf_kv(kv)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    preset_config = J_PRESETS[preset]
    assert (ours.arch, ours.pos_offset, ours.n_token_types, ours.n_embd_emb) == (
        preset_config.arch, preset_config.pos_offset, preset_config.n_token_types,
        preset_config.n_embd_emb)


def test_roberta_gguf_without_position_offset_encodes_alike(tmp_path, monkeypatch):
    """A RoBERTa file without `bert.position_offset` numbers positions from
    2 in both packages (the port once read 0 there)."""
    import embedding_cpp_tpu.models.convert as convert
    from embedding_cpp_tpu.gguf.constants import Keys as JKeys

    class Writer(convert.GGUFWriter):
        def add_uint32(self, key, value):
            if key != JKeys.POSITION_OFFSET:
                super().add_uint32(key, value)

    pytest.importorskip("tokenizers")
    monkeypatch.setattr(convert, "GGUFWriter", Writer)
    path = str(tmp_path / "roberta-no-offset.gguf")
    make_test_model(path, "tiny-roberta", "q4_0", seed=3)
    with GGUFReader(path) as r:
        assert Keys.POSITION_OFFSET not in r.kv
    ours, theirs = Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)
    assert ours.config.pos_offset == theirs.config.pos_offset == 2
    texts = _texts(12, 3, 100, seed=4)
    np.testing.assert_allclose(ours.encode(texts), theirs.encode(texts), rtol=0, atol=ATOL)


def test_family_rules():
    """The port refuses none of the reference's families; the BERT-graph
    ones add a position table, T5 does not; only ALBERT and ELECTRA may
    factorize their embeddings, and only ALBERT shares its layer."""
    assert UNPORTED_ARCHS == ()
    small = dict(n_vocab=50, n_ctx=16, n_embd=64, n_layer=1, n_head=4, n_ff=64)
    for arch in ("roberta", "distilbert", "electra", "mpnet", "albert"):
        assert BertConfig(**small, arch=arch).abs_positions
    assert not BertConfig(**small, arch="t5").abs_positions
    for arch in ("albert", "electra"):
        config = BertConfig(**small, arch=arch, n_embd_emb=32)
        assert config.emb_width == 32 and config.shared_layers == (arch == "albert")
    for arch in ("roberta", "mpnet", "t5"):
        with pytest.raises(ValueError, match="factorized"):
            BertConfig(**small, arch=arch, n_embd_emb=32)
    assert BertConfig.from_gguf_kv({
        Keys.ARCHITECTURE: "distilbert", Keys.TOKENIZER_LIST: ["a"] * 50,
        Keys.CONTEXT_LENGTH: 16, Keys.EMBEDDING_LENGTH: 64, Keys.BLOCK_COUNT: 1,
        Keys.HEAD_COUNT: 4, Keys.FEED_FORWARD_LENGTH: 64,
        Keys.N_LABELS: 1}).head_activation == "relu"


def test_presets_have_the_published_geometry():
    """The card's presets: multi-qa-distilbert-cos-v1 as the JAX package
    has it, and each preset's tensor count from the schema equal to the
    published checkpoint's encoder (its pooler and heads apart)."""
    for f in dataclasses.fields(MULTI_QA_DISTILBERT):
        assert getattr(MULTI_QA_DISTILBERT, f.name) == getattr(J_DISTILBERT_BASE, f.name), f.name

    def n_params(c: BertConfig) -> int:
        maps = [schema.embedding_tensors(c), schema.layer_tensor_names(0, c)]
        per = [sum(int(np.prod(fn(c))) for _, fn in m.values()) for m in maps]
        return per[0] + c.n_layer * per[1]

    # xlm-roberta-base without its pooler, distilbert-base, electra-small
    assert n_params(MULTILINGUAL_E5_BASE) == 277_453_056
    assert n_params(MULTI_QA_DISTILBERT) == 66_362_880
    assert n_params(ELECTRA_SMALL) == 13_483_008
    assert (MULTILINGUAL_E5_BASE.pos_offset, MULTILINGUAL_E5_BASE.n_token_types,
            MULTILINGUAL_E5_BASE.layer_norm_eps) == (2, 1, 1e-5)
    assert n_params(MS_MARCO_ELECTRA_BASE) == 108_891_648  # bert-base's encoder
    assert (MS_MARCO_ELECTRA_BASE.n_labels, MS_MARCO_ELECTRA_BASE.head_activation) == (1, "gelu")


# --- parameters ---------------------------------------------------------------------

@pytest.mark.parametrize("reranker", [False, True], ids=["embedder", "reranker"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_random_state_dict_is_byte_identical(arch, reranker):
    jc = _jconfig(ARCHS[arch], reranker)
    ours, theirs = random_state_dict(_pconfig(jc), seed=5), jax_random_state_dict(jc, seed=5)
    assert list(ours) == list(theirs)
    for name in theirs:
        assert ours[name].dtype == theirs[name].dtype
        assert ours[name].tobytes() == theirs[name].tobytes(), name
    assert ("embeddings_project.weight" in ours) == (arch == "electra")
    assert ("embeddings.token_type_embeddings.weight" in ours) == (arch != "distilbert")


@pytest.mark.parametrize("ftype", ["f32", "q4_0", "q8_0"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_random_params_match_jax_tree(arch, ftype):
    jc = _jconfig(ARCHS[arch], reranker=True)
    ours = random_params(_pconfig(jc), ftype, seed=1)
    assert_params_equal(ours, _bridge(jax_random_params(jc, J_FTYPES[ftype], seed=1)))
    emb = ours["embeddings"]
    assert emb["position"].shape == (jc.n_ctx + jc.pos_offset, jc.emb_width)
    assert set(ours["head"]) == {"dense_w", "dense_b", "out_w", "out_b"}
    if arch == "electra":  # dense and contraction-major, bias f32
        assert emb["emb_proj_w"].shape == (32, 64) and emb["emb_proj_b"].dtype == torch.float32


# --- forwards -----------------------------------------------------------------------

@pytest.fixture(scope="module", params=["f32", "q4_0"])
def models(request):
    """{arch: (JAX config, JAX tree, port params)} from seed 1."""
    out = {}
    for arch, preset in ARCHS.items():
        jc = _jconfig(preset)
        jp = jax_random_params(jc, J_FTYPES[request.param], seed=1)
        out[arch] = (jc, jp, _bridge(jp))
    return out


@pytest.mark.parametrize("s", [16, 64, 128])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_embed_batch_matches_jax(models, arch, s):
    jc, jp, tp = models[arch]
    ids, mask = _batch(3, s, jc.n_vocab, seed=s)
    ref = np.asarray(jax_embed_batch(jp, jnp.asarray(ids), jnp.asarray(mask), jc,
                                     PALLAS if s >= 128 else SMALL_S))
    got = bert_embed_batch(tp, *_t(ids, mask), _pconfig(jc)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_embed_packed_matches_jax(models, arch):
    jc, jp, tp = models[arch]
    ids, seg, pos = _packed(128, jc.n_vocab, seed=7)
    n_seg = 16
    slots = np.array([0, 1, n_seg, n_seg + 1, n_seg + 2], np.int64)
    ref = np.asarray(jax_embed_packed(jp, *map(jnp.asarray, (ids, seg, pos)), jc, PALLAS,
                                      n_seg=n_seg, gather_idx=jnp.asarray(slots, jnp.int32)))
    got = bert_embed_packed(tp, *_t(ids, seg, pos), _pconfig(jc), n_seg=n_seg,
                            gather_idx=torch.from_numpy(slots)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_packed_segments_equal_unpacked_sentences(models, arch):
    """A packed sentence embeds as it does alone: positions restart at the
    family's offset in every segment, other segments are masked."""
    jc, _, tp = models[arch]
    config = _pconfig(jc)
    ids, seg, pos = _packed(128, jc.n_vocab, seed=3)
    packed = bert_embed_packed(tp, *_t(ids, seg, pos), config, n_seg=16).numpy()
    for row, g in ((0, 0), (0, 1), (1, 0), (1, 2)):
        cols = np.nonzero(seg[row] == g)[0]
        one = np.zeros((1, 96), np.int32)
        one[0, :len(cols)] = ids[row, cols]
        mask = (np.arange(96) < len(cols)).astype(np.int32)[None]
        alone = bert_embed_batch(tp, *_t(one, mask), config).numpy()
        np.testing.assert_allclose(packed[row, g], alone[0], rtol=0, atol=PACKED_ATOL)


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bf16_q4_tracks_jax(arch, packed):
    jc = _jconfig(ARCHS[arch])
    jp = jax_random_params(jc, J_FTYPES["q4_0"], seed=2, dense_dtype=jnp.bfloat16)
    tp = _bridge(jp)
    jo = JOpts(dtype="bfloat16", q4_impl="pallas", attn_impl="pallas")
    to = ComputeOptions(dtype="bfloat16")
    if packed:
        ids, seg, pos = _packed(128, jc.n_vocab, seed=9)
        ref = np.asarray(jax_embed_packed(jp, *map(jnp.asarray, (ids, seg, pos)), jc, jo,
                                          n_seg=16))[:2]
        got = bert_embed_packed(tp, *_t(ids, seg, pos), _pconfig(jc), to, n_seg=16).numpy()[:2]
        real = np.linalg.norm(ref, axis=-1) > 0
        got, ref = got[real], ref[real]
    else:
        ids, mask = _batch(3, 128, jc.n_vocab, seed=8)
        ref = np.asarray(jax_embed_batch(jp, jnp.asarray(ids), jnp.asarray(mask), jc, jo))
        got = bert_embed_batch(tp, *_t(ids, mask), _pconfig(jc), to).numpy()
    assert _cosines(got, ref).min() >= COSINE


@pytest.mark.parametrize("ftype", ["f32", "q4_0"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_score_batch_matches_jax(arch, ftype):
    """The one-logit heads (tanh / relu / gelu) on the CLS state; the pair
    types as the family frames them (RoBERTa one segment, the others 0/1;
    DistilBERT has no table to read them)."""
    jc = _jconfig(ARCHS[arch], reranker=True)
    jp = jax_random_params(jc, J_FTYPES[ftype], seed=2)
    ids, mask = _batch(4, 64, jc.n_vocab, seed=5)
    types = np.zeros_like(ids) if arch == "roberta" else (
        (np.arange(64)[None, :] >= 10).astype(np.int32) * mask)
    ref = np.asarray(jax_score_batch(jp, jnp.asarray(ids), jnp.asarray(mask), jc, SMALL_S,
                                     type_ids=jnp.asarray(types)))
    got = bert_score_batch(_bridge(jp), *_t(ids, mask), _pconfig(jc),
                           type_ids=torch.from_numpy(types)).numpy()
    assert got.shape == ref.shape == (4, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


# --- tokenizer and Engine -------------------------------------------------------------

def _texts(n: int, lo: int, hi: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    words = np.array(_COMMON_WORDS)
    return [" ".join(rng.choice(words, size=int(rng.integers(lo, hi)))) for _ in range(n)]


PACKED = _texts(40, 3, 14, seed=0)  # short: the engine packs these
UNPACKED = _texts(12, 3, 110, seed=1) + ["", "Hello, World!  Ünïcödé 中文",
                                         " ".join(["word"] * 200)]
PROMPTS = {"query": "query: ", "passage": "passage: "}  # multilingual-e5's


@pytest.fixture(scope="module")
def engines(ggufs):
    made = {}

    def get(preset: str, reranker: bool = False):
        key = (preset, reranker)
        if key not in made:
            path = ggufs(preset, reranker)
            made[key] = (Engine.from_gguf(path, device="cpu", prompts=PROMPTS),
                         JEngine.from_gguf(path, prompts=PROMPTS))
        return made[key]

    return get


@pytest.mark.parametrize("double_sep", [False, True])
def test_frame_pair_ids_matches_jax(double_sep):
    """Every split of a budget between the two texts, and their truncation
    longest-first around the three or four specials."""
    special = (0, 2, 1, 3) if double_sep else (2, 3, 0, 1)
    ours, theirs = SpecialIds(*special), JSpecialIds(*special)
    for n_max in (8, 9, 16):
        for la in range(0, 14):
            for lb in range(0, 14):
                a, b = list(range(10, 10 + la)), list(range(40, 40 + lb))
                got = frame_pair_ids(a, b, ours, n_max, double_sep=double_sep)
                assert got == jax_frame_pair_ids(a, b, theirs, n_max, double_sep=double_sep)
                assert len(got[0]) == len(got[1]) <= n_max
    ids, types = frame_pair_ids([10, 11], [40], ours, 16, double_sep=double_sep)
    if double_sep:
        assert ids == [0, 10, 11, 2, 2, 40, 2] and types == [0] * 7
    else:
        assert ids == [2, 10, 11, 3, 40, 3] and types == [0, 0, 0, 0, 1, 1]


@pytest.mark.parametrize("preset", PRESETS)
def test_special_ids_and_tokens_match_jax(engines, preset):
    """The file's special ids (RoBERTa and XLM-R: <s> 0, </s> 2, <pad> 1)
    and every token id of the texts, as the JAX Engine reads them."""
    ours, theirs = engines(preset)
    assert ours.special_ids == SpecialIds(**dataclasses.asdict(theirs.special_ids))
    if ours.config.arch == "roberta":
        assert (ours.special_ids.cls, ours.special_ids.sep, ours.special_ids.pad) == (0, 2, 1)
    texts = PACKED + UNPACKED
    assert ours.tokenize_batch(texts) == theirs.tokenize_batch(texts)


@pytest.mark.parametrize("preset", PRESETS)
def test_tokenize_pairs_matches_jax(engines, preset):
    ours, theirs = engines(preset)
    pairs = list(zip(PACKED[:10], UNPACKED[:10])) + [("", UNPACKED[-1]), (UNPACKED[-1], "a")]
    got, want = ours.tokenize_pairs(pairs), theirs.tokenize_pairs(pairs)
    assert got == want
    ids, types = got
    assert max(map(len, ids)) == ours.config.n_ctx  # the long pairs are cut
    sep = ours.special_ids.sep
    double = [any(t[i] == t[i + 1] == sep for i in range(len(t) - 2)) for t in ids]
    if ours.config.arch == "roberta":
        assert all(double) and not any(map(any, types))
    else:
        assert not any(double) and all(1 in t for t in types)


@pytest.mark.parametrize("texts", [PACKED, UNPACKED], ids=["packed", "plain"])
@pytest.mark.parametrize("preset", PRESETS)
def test_encode_matches_jax(engines, preset, texts):
    ours, theirs = engines(preset)
    ids = ours.tokenize_batch(texts)
    assert ours._pack_plan(ids) == theirs._pack_plan(theirs.tokenize_batch(texts))
    assert bool(ours._pack_plan(ids)) == (texts is PACKED)
    got, ref = ours.encode(texts), theirs.encode(texts)
    assert got.shape == ref.shape == (len(texts), 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("preset", PRESETS)
def test_prompts_and_dimensions_match_jax(engines, preset):
    """multilingual-e5's "query: " / "passage: " prefixes through
    encode_queries / encode_documents, with Matryoshka `dimensions`, and
    the token counts a usage report reads."""
    ours, theirs = engines(preset)
    texts = UNPACKED[:6]
    for fn in ("encode_queries", "encode_documents"):
        np.testing.assert_allclose(getattr(ours, fn)(texts, dimensions=24),
                                   getattr(theirs, fn)(texts, dimensions=24), rtol=0, atol=ATOL)
    got, counts = ours.encode_with_counts(texts, prompt_name="query")
    want, want_counts = theirs.encode_with_counts(texts, prompt_name="query")
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert counts == want_counts
    assert counts == [len(t) for t in ours.tokenize_batch(["query: " + t for t in texts])]


@pytest.mark.parametrize("preset", PRESETS)
def test_score_pairs_and_rerank_match_jax(engines, preset):
    ours, theirs = engines(preset, reranker=True)
    assert ours.config.n_labels == 1
    assert type(ours.tokenizer) is type(engines(preset)[0].tokenizer)
    query = UNPACKED[0]
    docs = UNPACKED[1:8] + [""]
    pairs = [(query, d) for d in docs]
    np.testing.assert_allclose(ours.score_pairs(pairs), theirs.score_pairs(pairs),
                               rtol=0, atol=ATOL)
    got, want = ours.rerank(query, docs, top_n=5), theirs.rerank(query, docs, top_n=5)
    assert [r["index"] for r in got] == [r["index"] for r in want]
    np.testing.assert_allclose([r["relevance_score"] for r in got],
                               [r["relevance_score"] for r in want], rtol=0, atol=1e-5)


def test_rerank_frame_on_the_roberta_reranker(engines):
    """The server's rerank frame over an XLM-R-style cross-encoder (double
    separator, one segment) answers with Engine.rerank's order and scores."""
    ours, theirs = engines("tiny-roberta", reranker=True)
    query, docs = UNPACKED[2], UNPACKED[3:9]
    want = ours.rerank(query, docs, top_n=4)
    with serve_in_thread(ours) as port, socket.create_connection(("127.0.0.1", port), 10) as s:
        _recv(s, 4)
        s.sendall(_rerank_frame(query, docs, 4))
        (m,) = struct.unpack("<I", _recv(s, 4))
        idx = np.frombuffer(_recv(s, 4 * m), np.int32).tolist()
        scores = np.frombuffer(_recv(s, 4 * m), np.float32)
    assert m == 4 and idx == [r["index"] for r in want]
    assert idx == [r["index"] for r in theirs.rerank(query, docs, top_n=4)]
    np.testing.assert_allclose(scores, [r["relevance_score"] for r in want], rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bf16_noise_matches_the_pallas_path(arch):
    """At the published width (768, 12 heads of 64, FFN 3072; two layers)
    the port's bf16 hidden states stray from the f32 forward as far as the
    JAX package's Pallas path does, layer for layer: the rms error, over
    every token, within 5% of the reference's (the two sum in different
    orders, so their bf16 roundings differ, not their size)."""
    from embedding_cpp_tpu.models import bert as jbert
    from embedding_cpp_tpu_torch.models import bert as tbert

    jc = dataclasses.replace(_jconfig(ARCHS[arch]), n_vocab=300, n_embd=768, n_head=12,
                             n_ff=3072, n_embd_emb=128 if arch == "electra" else 0)
    config = _pconfig(jc)
    tree16 = jax_random_params(jc, J_FTYPES["q4_0"], seed=4, dense_dtype=jnp.bfloat16)
    t32 = _bridge(jax_random_params(jc, J_FTYPES["q4_0"], seed=4))
    t16 = _bridge(tree16)
    ids, mask = _batch(4, 128, jc.n_vocab, seed=6)
    bias = np.where(mask > 0, 0.0, -1e9).astype(np.float32)

    def port(params, dtype):
        x = tbert.embed_tokens(params, torch.from_numpy(ids), config, ComputeOptions(dtype=dtype))
        for i in range(config.n_layer):
            x = tbert.encoder_layer(x, {k: v[i] for k, v in params["layers"].items()},
                                    torch.from_numpy(bias), config)
            yield x.float().numpy()

    def reference():
        opts = JOpts(dtype="bfloat16", q4_impl="pallas", attn_impl="pallas")
        x = jbert.embed_tokens(tree16, jnp.asarray(ids), jc, opts)
        for i in range(jc.n_layer):
            lp = jax.tree_util.tree_map(lambda a: a[i], tree16["layers"])
            x = jbert.encoder_layer(x, lp, jnp.asarray(bias), jc, opts)
            yield np.asarray(x.astype(jnp.float32))

    real = mask.astype(bool)
    for f32, ours, theirs in zip(port(t32, "float32"), port(t16, "bfloat16"), reference()):
        rms = [float(np.sqrt(np.mean((a[real] - f32[real]) ** 2))) for a in (ours, theirs)]
        assert 0 < rms[0] <= 1.05 * rms[1], rms
