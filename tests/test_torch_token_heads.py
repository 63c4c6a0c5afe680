"""The token-level surfaces of the port against the JAX package: per-token
final states in every family, ColBERT late interaction and SPLADE sparse
vectors.

- `bert_embed_batch(token_states=True)` for bert, roberta, distilbert,
  modernbert, deberta, nomic-bert and t5 (the JAX package's tiny presets,
  f32 and Q4_0 weights carried across by `from_jax_params`) at S = 16 and
  128, and `Engine.encode_token_states` on tiny GGUFs.
- ColBERT: the config (GGUF keys and the reference's checks), the state
  dict with the projection, `project_token_states` / `maxsim_scores` with a
  skiplist mask, the Engine's framing (query [MASK] augmentation, [D]
  documents, the punctuation skiplist), `maxsim`, `maxsim_tokens`,
  `maxsim_rerank` and `colbert_query_vectors` on `tiny-colbert`, and MaxSim
  over a plain model's states.
- SPLADE: the MLM head's schema and state dict for bert/roberta/distilbert,
  its parameters (the tied decoder in matmul orientation, packed where the
  file is quantized), the chunk rule, the top-k packing, `bert_sparse_batch`
  and `Engine.encode_sparse` / `sparse_tokens` on `tiny-splade`.  Top-k
  orders ties freely, so ids compare as sets with their weights.

The JAX side runs as its own tests run it on the CPU (its XLA paths under
the tier-1 run's 8 CPU devices); the port runs its kernels' plain versions.
Tolerance: f32 2e-5 absolute; bf16 by cosine.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_params import assert_params_equal

from embedding_cpp_tpu.cli.make_test_model import PRESETS as J_PRESETS
from embedding_cpp_tpu.cli.make_test_model import make_test_model
from embedding_cpp_tpu.models.bert import ComputeOptions as JOpts
from embedding_cpp_tpu.models.bert import _sparse_chunk as jax_sparse_chunk
from embedding_cpp_tpu.models.bert import bert_embed_batch as jax_embed_batch
from embedding_cpp_tpu.models.bert import bert_sparse_batch as jax_sparse_batch
from embedding_cpp_tpu.models.bert import maxsim_scores as jax_maxsim_scores
from embedding_cpp_tpu.models.bert import project_token_states as jax_project
from embedding_cpp_tpu.models.bert import unpack_sparse_topk as jax_unpack
from embedding_cpp_tpu.models.config import BertConfig as JConfig
from embedding_cpp_tpu.models.convert import FTYPE_NAMES as J_FTYPES
from embedding_cpp_tpu.models.params import random_params as jax_random_params
from embedding_cpp_tpu.models.params import random_state_dict as jax_random_state_dict
from embedding_cpp_tpu.models.schema import mlm_tensors as jax_mlm_tensors
from embedding_cpp_tpu.runtime.engine import Engine as JEngine
from embedding_cpp_tpu_torch import Engine
from embedding_cpp_tpu_torch.gguf import GGUFReader
from embedding_cpp_tpu_torch.models import (
    BertConfig,
    ComputeOptions,
    bert_embed_batch,
    bert_sparse_batch,
    from_jax_params,
    maxsim_scores,
    project_token_states,
    random_params,
    random_state_dict,
)
from embedding_cpp_tpu_torch.models.bert import (
    pack_sparse_topk,
    sparse_chunk,
    unpack_sparse_topk,
)
from embedding_cpp_tpu_torch.models.schema import mlm_tensors
from embedding_cpp_tpu_torch.ops.qtensor import QTensor

ATOL = 2e-5
FAMILIES = {"bert": "tiny", "roberta": "tiny-roberta", "distilbert": "tiny-distilbert",
            "modernbert": "tiny-modernbert", "deberta": "tiny-deberta",
            "nomic-bert": "tiny-nomic", "t5": "tiny-t5"}


def _pconfig(jc: JConfig) -> BertConfig:
    names = {f.name for f in dataclasses.fields(BertConfig)}
    return BertConfig(**{k: v for k, v in dataclasses.asdict(jc).items() if k in names})


def _bridge(tree) -> dict:
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _batch(b: int, s: int, n_vocab: int, seed: int):
    """Row 0 full, row 1 a third long, the rest random lengths."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, n_vocab, (b, s)).astype(np.int32)
    lens = [s, max(1, s // 3)] + [int(n) for n in rng.integers(1, s + 1, b - 2)]
    mask = (np.arange(s)[None, :] < np.array(lens)[:, None]).astype(np.int32)
    ids[mask == 0] = 0
    return ids, mask


# --- token states in every family --------------------------------------------

@pytest.fixture(scope="module", params=["f32", "q4_0"])
def family_models(request):
    out = {}
    for arch, preset in FAMILIES.items():
        jc = J_PRESETS[preset]
        jp = jax_random_params(jc, J_FTYPES[request.param], seed=3)
        out[arch] = jc, jp, _bridge(jp)
    return out


@pytest.mark.parametrize("s", [16, 128])
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_token_states_match_jax(family_models, arch, s):
    jc, jp, tp = family_models[arch]
    ids, mask = _batch(3, s, jc.n_vocab, seed=s)
    ref = np.asarray(jax_embed_batch(jp, jnp.asarray(ids), jnp.asarray(mask), jc,
                                     JOpts(dtype="float32"), token_states=True))
    got = bert_embed_batch(tp, *_t(ids, mask), _pconfig(jc), token_states=True)
    assert got.dtype == torch.float32 and got.shape == (3, s, jc.n_embd)
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], ref[real], rtol=0, atol=ATOL)


@pytest.mark.parametrize("arch", ["bert", "modernbert"])
def test_token_states_bf16_track_f32(arch):
    jc = J_PRESETS[FAMILIES[arch]]
    config = _pconfig(jc)
    ids, mask = _batch(3, 64, jc.n_vocab, seed=1)
    states = [bert_embed_batch(random_params(config, "q4_0", seed=1, dense_dtype=dt),
                               *_t(ids, mask), config, ComputeOptions(dtype=name),
                               token_states=True).numpy()
              for dt, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"))]
    real = mask.astype(bool)
    a, b = states[0][real], states[1][real]
    cos = np.sum(a * b, -1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
    assert cos.min() >= 0.999


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    cache = {}

    def get(preset: str, ftype: str = "f32") -> str:
        if (preset, ftype) not in cache:
            path = str(tmp_path_factory.mktemp("gguf") / f"{preset}-{ftype}.gguf")
            make_test_model(path, preset, ftype, seed=0)
            cache[preset, ftype] = path
        return cache[preset, ftype]

    return get


TEXTS = ["the quick brown fox jumps over the lazy dog", "hello world", "a",
         "what is the capital of france? paris, of course!",
         "Hello, World!  Ünïcödé 中文", " ".join(["word"] * 90)]


@pytest.mark.parametrize("preset", ["tiny", "tiny-modernbert", "tiny-colbert"])
def test_engine_token_states_match_jax(ggufs, preset):
    path = ggufs(preset)
    ours, theirs = Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)
    got, ref = ours.encode_token_states(TEXTS), theirs.encode_token_states(TEXTS)
    assert len(got) == len(ref) == len(TEXTS)
    width = ours.config.colbert_dim or ours.config.n_embd
    for g, r, ids in zip(got, ref, ours.tokenize_batch(TEXTS)):
        assert g.shape == r.shape == (len(ids), width)
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL)


# --- ColBERT -----------------------------------------------------------------

COLBERT = dict(n_vocab=300, n_ctx=64, n_embd=64, n_layer=2, n_head=4, n_ff=128,
               colbert_dim=32, query_maxlen=16, q_marker_id=5, d_marker_id=6, mask_id=4)


@pytest.mark.parametrize("bad", [
    dict(arch="t5", n_token_types=0), dict(mlm_head=True), dict(n_labels=1),
    dict(dense_out=16), dict(q_marker_id=-1), dict(mask_id=-1), dict(query_maxlen=3)])
def test_colbert_config_checks_match_jax(bad):
    kw = {**COLBERT, **bad}
    with pytest.raises(ValueError) as theirs:
        JConfig(**kw)
    with pytest.raises(ValueError) as ours:
        BertConfig(**kw)
    assert str(ours.value) == str(theirs.value)


def test_colbert_and_mlm_config_from_gguf_match_jax(ggufs):
    for preset in ("tiny-colbert", "tiny-splade"):
        with GGUFReader(ggufs(preset)) as r:
            ours = BertConfig.from_gguf_kv(r.kv)
        theirs = JEngine.from_gguf(ggufs(preset)).config
        for f in ("mlm_head", "colbert_dim", "query_maxlen", "mask_punctuation",
                  "q_marker_id", "d_marker_id", "mask_id", "n_vocab", "n_embd"):
            assert getattr(ours, f) == getattr(theirs, f), (preset, f)


@pytest.mark.parametrize("ftype", ["f32", "q4_0"])
def test_colbert_state_dict_and_params_match_jax(ftype):
    jc = JConfig(**COLBERT)
    ours = random_state_dict(BertConfig(**COLBERT), seed=2)
    theirs = jax_random_state_dict(jc, seed=2)
    assert list(ours) == list(theirs) and "linear.weight" in ours
    for name in ours:
        assert ours[name].tobytes() == np.asarray(theirs[name]).tobytes(), name
    tp = random_params(BertConfig(**COLBERT), ftype, seed=2)
    assert tp["colbert"]["w"].shape == (64, 32) and tp["colbert"]["w"].dtype == torch.float32
    assert_params_equal(tp, _bridge(jax_random_params(jc, J_FTYPES[ftype], seed=2)))


def test_project_and_maxsim_scores_match_jax():
    jc = JConfig(**COLBERT)
    jp = jax_random_params(jc, J_FTYPES["f32"], seed=4)
    tp = _bridge(jp)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(16, 32)).astype(np.float32)
    q_mask = (np.arange(16) < 11).astype(np.int32)
    ids, mask = _batch(4, 32, 300, seed=4)
    keep = mask * (ids % 7 != 0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    np.testing.assert_allclose(project_token_states(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jax_project(jp, jnp.asarray(x))), rtol=0, atol=1e-6)
    for d_keep in (None, keep):
        ref = np.asarray(jax_maxsim_scores(jp, jnp.asarray(q), jnp.asarray(q_mask),
                                           jnp.asarray(ids), jnp.asarray(mask), jc,
                                           JOpts(dtype="float32"),
                                           d_keep=None if d_keep is None else jnp.asarray(d_keep)))
        got = maxsim_scores(tp, *_t(q, q_mask, ids, mask), BertConfig(**COLBERT),
                            d_keep=None if d_keep is None else torch.from_numpy(d_keep)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.fixture(scope="module", params=["f32", "q4_0"])
def colbert_engines(request, ggufs):
    path = ggufs("tiny-colbert", request.param)
    return Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)


DOCS = ["paris is the capital of france.", "the quick brown fox; the lazy dog!",
        "hello world", "what, when, where?", " ".join(["water"] * 70), ""]


def test_colbert_framing_matches_jax(colbert_engines):
    ours, theirs = colbert_engines
    assert ours.colbert_skiplist() == theirs.colbert_skiplist() != frozenset()
    assert ours.colbert_doc_tokens(DOCS) == theirs.colbert_doc_tokens(DOCS)
    assert ours.colbert_doc_tokens(DOCS, cap=8) == theirs.colbert_doc_tokens(DOCS, cap=8)
    for got, ref in zip(ours.colbert_query_ids(DOCS), theirs.colbert_query_ids(DOCS)):
        np.testing.assert_array_equal(got, ref)
    q_ids, q_mask = ours.colbert_query_ids(["what is it"])
    assert q_ids[0, 1] == ours.config.q_marker_id
    assert (q_ids[0][q_mask[0] == 0] == ours.config.mask_id).all()


def test_colbert_maxsim_matches_jax(colbert_engines):
    ours, theirs = colbert_engines
    query = "where is paris, the capital?"
    np.testing.assert_allclose(ours.maxsim(query, DOCS), theirs.maxsim(query, DOCS),
                               rtol=0, atol=ATOL)
    got, ref = ours.maxsim_rerank(query, DOCS, top_n=4), theirs.maxsim_rerank(query, DOCS,
                                                                             top_n=4)
    assert [r["index"] for r in got] == [r["index"] for r in ref]
    np.testing.assert_allclose([r["relevance_score"] for r in got],
                               [r["relevance_score"] for r in ref], rtol=0, atol=ATOL)
    for g, r in zip(ours.colbert_query_vectors(DOCS[:3]), theirs.colbert_query_vectors(DOCS[:3])):
        assert g.shape == r.shape == (16, 32)
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL)


def test_maxsim_over_a_plain_model_matches_jax(ggufs):
    path = ggufs("tiny")
    ours, theirs = Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)
    np.testing.assert_allclose(ours.maxsim("the quick fox", DOCS[:5]),
                               theirs.maxsim("the quick fox", DOCS[:5]), rtol=0, atol=ATOL)
    q = ours.tokenize("hello")
    np.testing.assert_allclose(ours.maxsim_tokens(q, [ours.tokenize(d) for d in DOCS[:3]]),
                               theirs.maxsim_tokens(q, [theirs.tokenize(d) for d in DOCS[:3]]),
                               rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="empty query"):
        ours.maxsim_tokens([], [q])
    with pytest.raises(RuntimeError, match="not a ColBERT checkpoint"):
        ours.colbert_doc_tokens(DOCS)


# --- SPLADE ------------------------------------------------------------------

SPLADE = dict(n_vocab=300, n_ctx=128, n_embd=64, n_layer=2, n_head=4, n_ff=128, mlm_head=True)
MLM_ARCHS = {"bert": {}, "roberta": dict(arch="roberta", n_token_types=1, pos_offset=2,
                                         layer_norm_eps=1e-5),
             "distilbert": dict(arch="distilbert", n_token_types=0)}


def _splade(arch: str, **kw) -> dict:
    return {**SPLADE, **MLM_ARCHS[arch], **kw}


@pytest.mark.parametrize("arch", sorted(MLM_ARCHS))
def test_mlm_schema_and_state_dict_match_jax(arch):
    config = _splade(arch)
    ours = {k: (v[0], v[1](BertConfig(**config))) for k, v in
            mlm_tensors(BertConfig(**config)).items()}
    theirs = {k: (v[0], v[1](JConfig(**config))) for k, v in
              jax_mlm_tensors(JConfig(**config)).items()}
    assert ours == theirs and len(ours) == 5
    sd, jsd = random_state_dict(BertConfig(**config), seed=5), jax_random_state_dict(
        JConfig(**config), seed=5)
    assert list(sd) == list(jsd)
    for name in sd:
        assert sd[name].tobytes() == np.asarray(jsd[name]).tobytes(), name


def test_mlm_head_is_refused_outside_its_families():
    for arch in ("modernbert", "deberta", "t5"):
        with pytest.raises(ValueError, match="mlm_head"):
            BertConfig(**{**SPLADE, "arch": arch, "n_token_types": 0})


@pytest.mark.parametrize("ftype", ["f32", "q4_0", "q8_0"])
def test_mlm_params_match_jax(ftype):
    jc = JConfig(**_splade("bert"))
    tp = random_params(BertConfig(**_splade("bert")), ftype, seed=6)
    dec = tp["mlm"]["decoder_w"]
    if ftype == "f32":
        assert dec.shape == (64, 300) and dec.dtype == torch.float32
    else:
        assert isinstance(dec, QTensor) and dec.shape == (64, 300)
    assert_params_equal(tp, _bridge(jax_random_params(jc, J_FTYPES[ftype], seed=6)))


@pytest.mark.parametrize("s,b,v", [(16, 8, 30522), (512, 64, 30522), (96, 3, 300),
                                   (7, 2048, 30522), (128, 512, 250002)])
def test_sparse_chunk_matches_jax(s, b, v):
    assert sparse_chunk(s, b, v) == jax_sparse_chunk(s, b, v)
    c = sparse_chunk(s, b, v, budget=1 << 30)
    assert s % c == 0 and c <= 64


def test_sparse_topk_packing_round_trips():
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, 30522, (3, 8)).astype(np.int64))
    val = torch.from_numpy(rng.random((3, 8)).astype(np.float32))
    packed = pack_sparse_topk(idx, val).numpy()
    for unpack in (unpack_sparse_topk, jax_unpack):
        i, v = unpack(packed)
        np.testing.assert_array_equal(i, idx.numpy())
        np.testing.assert_array_equal(v, val.numpy())


def _as_dicts(packed) -> list[dict]:
    idx, val = unpack_sparse_topk(np.asarray(packed))
    return [dict(zip(i.tolist(), v.tolist())) for i, v in zip(idx, val)]


@pytest.mark.parametrize("arch", sorted(MLM_ARCHS))
@pytest.mark.parametrize("ftype", ["f32", "q4_0"])
def test_sparse_batch_matches_jax(arch, ftype):
    config = _splade(arch)
    jp = jax_random_params(JConfig(**config), J_FTYPES[ftype], seed=7)
    tp = _bridge(jp)
    ids, mask = _batch(4, 32, 300, seed=7)
    gather = np.array([2, 0, 3], np.int64)
    ref = jax_sparse_batch(jp, jnp.asarray(ids), jnp.asarray(mask), JConfig(**config),
                           JOpts(dtype="float32"), 40, gather_idx=jnp.asarray(gather, jnp.int32))
    got = bert_sparse_batch(tp, *_t(ids, mask), BertConfig(**config),
                            ComputeOptions(), 40, gather_idx=torch.from_numpy(gather))
    assert got.shape == (3, 80)
    for g, r in zip(_as_dicts(got.numpy()), _as_dicts(np.asarray(ref))):
        assert set(g) == set(r)
        np.testing.assert_allclose([g[k] for k in r], list(r.values()), rtol=0, atol=ATOL)


def test_sparse_batch_chunking_is_exact():
    """The running max over token chunks equals one chunk of every token."""
    config = BertConfig(**_splade("bert"))
    tp = random_params(config, "q4_0", seed=8)
    ids, mask = _batch(3, 64, 300, seed=8)
    one = bert_sparse_batch(tp, *_t(ids, mask), config, ComputeOptions(), 300, budget=1 << 40)
    small = bert_sparse_batch(tp, *_t(ids, mask), config, ComputeOptions(), 300, budget=1)
    assert sparse_chunk(64, 3, 300, budget=1) == 1
    for a, b in zip(_as_dicts(one.numpy()), _as_dicts(small.numpy())):
        assert a == b


@pytest.fixture(scope="module", params=["f32", "q4_0"])
def splade_engines(request, ggufs):
    path = ggufs("tiny-splade", request.param)
    return Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)


@pytest.mark.parametrize("k", [1, 16, 20, 300, 5000])
def test_engine_encode_sparse_matches_jax(splade_engines, k):
    ours, theirs = splade_engines
    got, ref = ours.encode_sparse(TEXTS, k=k), theirs.encode_sparse(TEXTS, k=k)
    assert len(got) == len(ref) == len(TEXTS)
    for (gi, gv), (ri, rv) in zip(got, ref):
        assert gi.dtype == np.int32 and gv.dtype == np.float32
        assert len(gi) <= min(k, ours.config.n_vocab) and np.all(gv > 0)
        assert np.all(np.diff(gv) <= 0)  # descending
        assert set(gi.tolist()) == set(ri.tolist())
        np.testing.assert_allclose(dict(zip(gi.tolist(), gv))[int(ri[0])], rv[0], atol=ATOL)
        g = dict(zip(gi.tolist(), gv.tolist()))
        np.testing.assert_allclose([g[i] for i in ri.tolist()], rv, rtol=0, atol=ATOL)


def test_sparse_tokens_and_errors(splade_engines, ggufs):
    ours, theirs = splade_engines
    lists = [ours.tokenize(t) for t in TEXTS[:3]]
    for (gi, _), (ri, _) in zip(ours.sparse_tokens(lists, k=32), theirs.sparse_tokens(lists, k=32)):
        assert set(gi.tolist()) == set(ri.tolist())
    with pytest.raises(ValueError, match="k must be positive"):
        ours.sparse_tokens(lists, k=0)
    plain = Engine.from_gguf(ggufs("tiny"), device="cpu")
    with pytest.raises(ValueError, match="no MLM head"):
        plain.encode_sparse(TEXTS[:1])


def test_sparse_bf16_tracks_f32(splade_engines):
    """Whole vectors (every positive term): the bf16 path by cosine."""
    ours, _ = splade_engines
    bf16 = Engine(ours.params, ours.config, ours.tokenizer, ours.special_ids, device="cpu",
                  opts=ComputeOptions(dtype="bfloat16"))
    n = ours.config.n_vocab
    vecs = []
    for eng in (ours, bf16):
        v = np.zeros((len(TEXTS), n), np.float32)
        for row, (i, w) in enumerate(eng.encode_sparse(TEXTS, k=n)):
            v[row, i] = w
        vecs.append(v)
    cos = np.sum(vecs[0] * vecs[1], -1) / np.linalg.norm(vecs[0], axis=-1) / np.linalg.norm(
        vecs[1], axis=-1)
    assert cos.min() >= 0.999


# --- the token surfaces' batching: lists past n_ctx, and nomic's padded S ---

LONG = 200  # ids in a list past tiny's and tiny-splade's 128-token context


def _long_list(n: int = LONG) -> list[int]:
    return [2] + np.random.default_rng(5).integers(5, 250, n - 2).tolist() + [3]


@pytest.mark.parametrize("preset,surface", [
    ("tiny", "token_states_tokens"), ("tiny", "maxsim_tokens"),
    ("tiny", "maxsim_query"), ("tiny", "token_states_device"),
    ("tiny-splade", "sparse_tokens")])
def test_a_list_past_the_context_is_refused_as_the_reference_refuses_it(ggufs, preset,
                                                                       surface):
    """A 200-id list on a 128-token model: the JAX Engine raises ValueError,
    and so does the port, naming the list's length, before any launch."""
    path = ggufs(preset)
    ours, theirs = Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)
    short = [2, 10, 11, 3]
    calls = {
        "token_states_tokens": lambda e: e.token_states_tokens([short, _long_list()]),
        "maxsim_tokens": lambda e: e.maxsim_tokens(short, [short, _long_list()]),
        "maxsim_query": lambda e: e.maxsim_tokens(_long_list(), [short]),
        "token_states_device": lambda e: list(e.token_states_device([short, _long_list()])),
        "sparse_tokens": lambda e: e.sparse_tokens([short, _long_list()], k=16),
    }
    with pytest.raises(ValueError):
        calls[surface](theirs)
    from embedding_cpp_tpu_torch.models import bert as port_bert

    launched = []
    real = port_bert.bert_embed_batch
    port_bert.bert_embed_batch = lambda *a, **kw: launched.append(1) or real(*a, **kw)
    try:
        with pytest.raises(ValueError, match=f"has {LONG} ids, over the model's 128-token"):
            calls[surface](ours)
    finally:
        port_bert.bert_embed_batch = real
    assert not launched


def test_embed_tokens_still_cuts_a_list_past_the_context(ggufs):
    """embed_tokens cuts such a list in both packages (F4 leaves it)."""
    path = ggufs("tiny")
    ours, theirs = Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)
    lists = [_long_list(), [2, 10, 11, 3]]
    np.testing.assert_allclose(ours.embed_tokens(lists), theirs.embed_tokens(lists),
                               rtol=0, atol=ATOL)


@pytest.fixture(scope="module")
def nomic_pair(ggufs):
    path = ggufs("tiny-nomic")
    return Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)


def _nomic_lists(n_long: int = 129) -> list[list[int]]:
    """[n_long random ids, its first 10]: padded together past tiny-nomic's
    rope_max_trained (128), the short list's RoPE base is the long one's."""
    long = np.random.default_rng(0).integers(5, 1000, n_long).tolist()
    return [long, long[:10]]


@pytest.mark.parametrize("n_long", [129, 200, 256])
def test_nomic_token_states_of_mixed_lengths_match_jax(nomic_pair, n_long):
    ours, theirs = nomic_pair
    lists = _nomic_lists(n_long)
    got, ref = ours.token_states_tokens(lists), theirs.token_states_tokens(lists)
    for g, r, ids in zip(got, ref, lists):
        assert g.shape == r.shape == (len(ids), 64)
        np.testing.assert_allclose(g, r, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_long", [129, 200])
def test_nomic_maxsim_of_mixed_lengths_matches_jax(nomic_pair, n_long):
    ours, theirs = nomic_pair
    long, short = _nomic_lists(n_long)
    query = np.random.default_rng(1).integers(5, 1000, 129).tolist()
    docs = [long[:50], short, long]
    np.testing.assert_allclose(ours.maxsim_tokens(query, docs),
                               theirs.maxsim_tokens(query, docs), rtol=0, atol=ATOL)


def test_nomic_maxsim_frame_of_mixed_lengths_matches_the_reference(nomic_pair):
    """\x01TPX on tiny-nomic: a document past 128 tokens beside short ones,
    from both servers."""
    import struct

    from test_torch_server import _ranked, both_servers

    from embedding_cpp_tpu_torch.tokenizer.testvocab import _COMMON_WORDS as words

    ours, _ = nomic_pair
    rng = np.random.default_rng(2)
    query = " ".join(rng.choice(words, 140))
    docs = [" ".join(rng.choice(words, 150)), "hello world", " ".join(rng.choice(words, 20))]
    assert len(ours.tokenize(docs[0])) > 128 and len(ours.tokenize(query)) > 128
    body = struct.pack("<I", len(docs)) + b"".join(
        struct.pack("<I", len(d.encode())) + d.encode() for d in docs)
    frame = b"\x01TPX" + struct.pack("<II", 0, len(query.encode())) + query.encode() + body
    with both_servers(nomic_pair) as socks:
        replies = []
        for s in socks:
            s.sendall(frame)
            replies.append(_ranked(s))
    (idx, scores), (idx_ref, scores_ref) = replies
    assert idx == idx_ref
    np.testing.assert_allclose(scores, scores_ref, rtol=0, atol=ATOL)


def test_nomic_token_plan_pads_each_chunk_as_the_reference(nomic_pair):
    """2100 lists of random lengths: every list gets the padded S the JAX
    Engine's `_padded_chunks` gives it (chunks of 2048 in input order), and
    the plan covers each list once."""
    ours, theirs = nomic_pair
    rng = np.random.default_rng(3)
    lens = np.concatenate([rng.integers(1, 257, 2048), rng.integers(1, 101, 52)])
    lists = [[7] * int(n) for n in lens]
    want = []
    for ids, _, lens in theirs._padded_chunks(lists, max(theirs.batch_buckets)):
        want += [ids.shape[1]] * len(lens)
    got = [0] * len(lists)
    for b in ours.token_plan(lists):
        for row, i in enumerate(b.positions):
            assert b.mask[row].sum() == len(lists[i])
            got[i] = b.ids.shape[1]
    assert got == want and len(set(want)) > 1


@pytest.mark.parametrize("preset", ["tiny", "tiny-roberta", "tiny-modernbert", "tiny-deberta",
                                    "tiny-t5"])
def test_length_buckets_and_padded_chunks_give_the_same_states(ggufs, preset, monkeypatch):
    """Where states do not depend on the padded S, the port keeps the
    length-bucket plan: forcing the reference's padded chunks instead gives
    the same states for lists of mixed lengths."""
    ours = Engine.from_gguf(ggufs(preset), device="cpu")
    rng = np.random.default_rng(4)
    top = min(250, ours.config.n_vocab)
    lists = [[2] + rng.integers(5, top, int(n)).tolist() + [3] for n in (3, 100, 20, 60, 1)]
    assert not ours._length_dependent()
    bucketed = ours.token_states_tokens(lists)
    monkeypatch.setattr(Engine, "_length_dependent", lambda self: True)
    assert len({b.ids.shape[1] for b in ours.token_plan(lists)}) == 1
    for a, b in zip(bucketed, ours.token_states_tokens(lists)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("preset", ["tiny", "tiny-nomic"])
def test_token_states_device_equals_token_states_tokens(ggufs, preset):
    """Each yielded batch: its positions, the [B, S, E] states on the
    engine's device, the mask and the lengths, equal to token_states_tokens
    row for row."""
    ours = Engine.from_gguf(ggufs(preset), device="cpu")
    lists = _nomic_lists(129) + [[2, 9, 3]] if preset == "tiny-nomic" else \
        [ours.tokenize(t) for t in TEXTS]
    want = ours.token_states_tokens(lists)
    seen = []
    for positions, dev, mask, lens in ours.token_states_device(lists):
        assert isinstance(dev, torch.Tensor) and dev.device == ours.device
        assert dev.shape[:2] == mask.shape and dev.dtype == torch.float32
        for row, (i, n) in enumerate(zip(positions, lens)):
            assert n == len(lists[i]) and mask[row].sum() == n
            np.testing.assert_array_equal(dev[row, :n].numpy(), want[i])
            seen.append(i)
    assert sorted(seen) == list(range(len(lists)))
