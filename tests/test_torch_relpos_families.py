"""The last three encoder families the port serves — MPNet (a T5-bucketed
relative position bias on BERT's graph), the T5 encoder (pre-norm RMSNorm
blocks, unscaled attention, the same bias) and ALBERT (one shared layer,
factorized embeddings) — against the JAX package, on its `make_test_model`
tiny presets (64 wide, 4 heads; tiny-albert's tables 32 wide, 3
applications of its one layer), a gated-GELU tiny-t5 and one whose d_kv
(32) is not n_embd / n_head, and their one-logit cross-encoder variants
(MPNet's RoBERTa-named tanh head, ALBERT's bare pooler + classifier).

- The bucket matrix bit for bit over rel in [-1023, 1023]; the [H, S, S]
  bias; K4's plain version at PH = H against the Pallas
  `flash_attention_bias_bse` / `flash_attention_bias_packed_bse` in
  interpret mode (f32 2e-5, bf16 1e-2 of the largest output).
- `from_gguf_kv` field by field; `random_state_dict` byte for byte; the
  parameters equal the JAX tree carried across by `from_jax_params`.
- Plain and packed forwards within 2e-5 in f32 (the JAX side on its Pallas
  kernels in interpret mode where its dispatch takes them), bf16 with
  Q4_0 weights by cosine >= 0.999, a packed sentence equal to itself
  alone, MPNet and ALBERT score logits within 2e-5.
- The Engine against the JAX Engine on the tiny GGUFs: token ids, T5's
  framing without CLS and its `truncate=False` context check, MPNet's
  double-separator pairs, `encode` packed, plain and at another
  `pack_seq`, `score_pairs` / `rerank`, and each GGUF's config and
  parameters.
"""
import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import _batch, _bridge, _cosines, _packed, _pconfig, _t, _texts
from test_torch_params import assert_params_equal

from embedding_cpp_tpu.cli.make_test_model import PRESETS as J_PRESETS
from embedding_cpp_tpu.cli.make_test_model import make_test_model
from embedding_cpp_tpu.models import bert as jbert
from embedding_cpp_tpu.models.bert import ComputeOptions as JOpts
from embedding_cpp_tpu.models.bert import bert_embed_batch as jax_embed_batch
from embedding_cpp_tpu.models.bert import bert_embed_packed as jax_embed_packed
from embedding_cpp_tpu.models.bert import bert_score_batch as jax_score_batch
from embedding_cpp_tpu.models.config import GTR_BASE as J_GTR_BASE
from embedding_cpp_tpu.models.config import HEAD_ACT_DEFAULTS as J_HEAD_ACT
from embedding_cpp_tpu.models.config import MPNET_BASE as J_MPNET_BASE
from embedding_cpp_tpu.models.config import BertConfig as JConfig
from embedding_cpp_tpu.models.convert import FTYPE_NAMES as J_FTYPES
from embedding_cpp_tpu.models.convert import write_bert_gguf
from embedding_cpp_tpu.models.params import load_params as jax_load_params
from embedding_cpp_tpu.models.params import random_params as jax_random_params
from embedding_cpp_tpu.models.params import random_state_dict as jax_random_state_dict
from embedding_cpp_tpu.ops import attention as jattn
from embedding_cpp_tpu.gguf.reader import GGUFReader as JReader
from embedding_cpp_tpu.runtime.engine import Engine as JEngine
from embedding_cpp_tpu.tokenizer.testvocab import build_unigram_tokenizer_json
from embedding_cpp_tpu_torch import Engine
from embedding_cpp_tpu_torch.gguf import GGUFReader, Keys
from embedding_cpp_tpu_torch.models import (
    ALBERT_BASE,
    GTR_BASE,
    MPNET_BASE,
    BertConfig,
    ComputeOptions,
    bert_embed_batch,
    bert_embed_packed,
    bert_score_batch,
    load_params,
    random_params,
    random_state_dict,
)
from embedding_cpp_tpu_torch.models import schema
from embedding_cpp_tpu_torch.models.bert import rel_attn_bias, t5_relative_bucket
from embedding_cpp_tpu_torch.models.t5 import unscale_q
from embedding_cpp_tpu_torch.ops.attention import (
    flash_attention_bias_bse,
    flash_attention_bias_packed_bse,
)

ATOL = 2e-5  # f32, the JAX package's own bar for its kernel paths
PACKED_ATOL = 1e-5  # a packed sentence against itself alone
BF16_REL = 1e-2  # bf16 kernels: max|err| / max|ref|
COSINE = 0.999  # bf16 activations with Q4_0 weights
PRESETS = ["tiny-mpnet", "tiny-t5", "tiny-albert"]
# the forwards' configurations: the three presets, a gated-GELU T5 (v1.1,
# K1's prologue) and a T5 whose d_kv is not n_embd / n_head
MODELS = {
    "mpnet": J_PRESETS["tiny-mpnet"],
    "albert": J_PRESETS["tiny-albert"],
    "t5": J_PRESETS["tiny-t5"],
    "t5-gated": dataclasses.replace(J_PRESETS["tiny-t5"], ffn_act="gelu_tanh",
                                    ffn_gated=True, name="tiny-t5-gated"),
    "t5-dkv32": dataclasses.replace(J_PRESETS["tiny-t5"], n_head_dim=32, name="tiny-t5-dkv32"),
}
RERANKERS = ("mpnet", "albert")  # the families with a classification head
# (model, with its head): T5 encoders have none
HEADS = [(name, False) for name in sorted(MODELS)] + [(name, True) for name in RERANKERS]
PALLAS = JOpts(dtype="float32", q4_impl="pallas", attn_impl="pallas")
SMALL_S = JOpts(dtype="float32", q4_impl="pallas", attn_impl="xla")


def _reranker(jc: JConfig) -> JConfig:
    return dataclasses.replace(jc, n_labels=1, head_activation=J_HEAD_ACT.get(jc.arch, "tanh"),
                               name=jc.name + "-reranker")


# --- the relative position bias -----------------------------------------------------

@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (32, 64), (64, 256)])
def test_bucket_matrix_is_bit_equal_to_jax(buckets, max_distance):
    """Every rel in [-1023, 1023], against the JAX package's host fold
    (numpy) and its traced form (jnp, the per-row packed bias)."""
    rel = np.arange(-1023, 1024)
    got = t5_relative_bucket(rel, buckets, max_distance)
    np.testing.assert_array_equal(
        got, jbert.t5_relative_bucket(rel, buckets, max_distance=max_distance, xp=np))
    np.testing.assert_array_equal(got, np.asarray(jbert.t5_relative_bucket(
        jnp.asarray(rel), buckets, max_distance=max_distance, xp=jnp)))
    assert got.min() == 0 and got.max() == buckets - 1
    # the exact near field, each sign in its own half: k before q in
    # 0..half-1, k after q from half on
    half = buckets // 2
    exact = half // 2
    near = got[1023 - exact + 1:1023 + exact]
    np.testing.assert_array_equal(near, [*range(exact - 1, 0, -1), 0,
                                         *range(half + 1, half + exact)])


@pytest.mark.parametrize("max_distance", [128, 64])
@pytest.mark.parametrize("s", [16, 100, 512])
def test_rel_attn_bias_matches_jax(s, max_distance):
    table = np.random.default_rng(s).normal(size=(32, 4)).astype(np.float32)
    got = rel_attn_bias(torch.from_numpy(table), s, max_distance)
    ref = np.asarray(jbert._rel_attn_bias(jnp.asarray(table), s, max_distance=max_distance))
    assert got.shape == (4, s, s) and got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)


def _attention_inputs(b: int, s: int, h: int, d: int, dtype, seed: int):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, h * d)).astype(np.float32) for _ in range(3))
    table = (rng.normal(size=(32, h)) * 2).astype(np.float32)
    pos_bias = np.array(jbert._rel_attn_bias(jnp.asarray(table), s))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    return (jq, jk, jv), (tq, tk, tv), pos_bias


def _assert_close(got: torch.Tensor, ref, dtype: str) -> None:
    got = got.to(torch.float32).numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    else:
        assert np.abs(got - ref).max() <= BF16_REL * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s", [(6, 16), (4, 32), (2, 128)])
def test_k4_per_head_plain_matches_pallas(b, s, dtype):
    """K4's plain version with a per-head [H, S, S] bias (PH = H) and a key
    bias against the Pallas `flash_attention_bias_bse` in interpret mode;
    S <= 32 is where the card's kernel takes several batch rows a block."""
    h, d = 4, 16
    (jq, jk, jv), (tq, tk, tv), pos_bias = _attention_inputs(b, s, h, d, dtype, seed=s)
    _, mask = _batch(b, s, 100, seed=s + 1)
    bias = np.where(mask > 0, 0.0, -1e9).astype(np.float32)
    ref = jattn.flash_attention_bias_bse(jq, jk, jv, jnp.asarray(bias), jnp.asarray(pos_bias), h)
    got = flash_attention_bias_bse(tq, tk, tv, torch.from_numpy(bias),
                                   torch.from_numpy(pos_bias), h)
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [128, 256])
def test_k4_per_head_packed_matches_pallas(s, dtype):
    """K4's packed form at PH = H: the batch-invariant bias added to the
    pairs that share a segment id, against the Pallas
    `flash_attention_bias_packed_bse` in interpret mode."""
    h, d = 4, 16
    seg = _packed(s, 100, seed=s)[1]
    (jq, jk, jv), (tq, tk, tv), pos_bias = _attention_inputs(3, s, h, d, dtype, seed=s + 2)
    ref = jattn.flash_attention_bias_packed_bse(jq, jk, jv, jnp.asarray(seg),
                                                jnp.asarray(pos_bias), h)
    got = flash_attention_bias_packed_bse(tq, tk, tv, torch.from_numpy(seg),
                                          torch.from_numpy(pos_bias), h)
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("d", [64, 128])
def test_t5_unscaled_q_is_bit_equal_to_jax(d):
    """q * sqrt(d) in bf16, the product the T5 attention hands the kernel
    (which divides by sqrt(d) again): exact at d = 64; at d = 128
    (gtr-t5-xl) the factor and each product round to bf16, the same
    roundings on both sides."""
    q = np.random.default_rng(d).normal(size=(4, 8, 2 * d)).astype(np.float32)
    got = unscale_q(torch.from_numpy(q).to(torch.bfloat16), d)
    jq = jnp.asarray(q, jnp.bfloat16)
    ref = (jq * math.sqrt(d)).astype(jq.dtype)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    exact = got.to(torch.float32) == torch.from_numpy(q).to(torch.bfloat16).float() * math.sqrt(d)
    assert bool(exact.all()) == (d == 64)


# --- configuration ----------------------------------------------------------------

@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    """Q4_0 GGUFs of the tiny presets and of the MPNet / ALBERT one-logit
    rerankers (the preset's tokenizer and vocab), written by the JAX
    package, made on first use."""
    root = tmp_path_factory.mktemp("relpos")
    made = {}

    def get(preset: str, reranker: bool = False) -> str:
        key = (preset, reranker)
        if key not in made:
            path = str(root / f"{preset}{'-reranker' if reranker else ''}.gguf")
            if reranker:
                with GGUFReader(get(preset)) as r:
                    blob = r.kv[Keys.TOKENIZER_JSON_BLOB]
                    n_vocab = len(r.kv[Keys.TOKENIZER_LIST])
                jc = dataclasses.replace(_reranker(J_PRESETS[preset]), n_vocab=n_vocab)
                write_bert_gguf(path, jc, jax_random_state_dict(jc, seed=0), blob,
                                J_FTYPES["q4_0"])
            else:
                make_test_model(path, preset, "q4_0", seed=0)
            made[key] = path
        return made[key]

    pytest.importorskip("tokenizers")  # tiny-t5's Unigram vocab is trained
    return get


@pytest.mark.parametrize("drop", [(), (Keys.HEAD_DIM, Keys.FFN_ACT, Keys.FFN_GATED),
                                  (Keys.POSITION_OFFSET, Keys.TOKEN_TYPE_COUNT,
                                   Keys.REL_ATTN_BUCKETS, Keys.GELU)],
                         ids=["as-written", "no-t5-keys", "no-family-keys"])
@pytest.mark.parametrize("preset", PRESETS)
def test_from_gguf_kv_matches_jax(ggufs, preset, drop):
    """Field by field, on the file's kv and with keys left out: the
    family's defaults fill them alike (MPNet offset 2 and 32 buckets,
    ALBERT gelu tanh, T5 relu and d_kv n_embd / n_head)."""
    with GGUFReader(ggufs(preset)) as r:
        kv = {k: v for k, v in r.kv.items() if k not in drop}
    ours, theirs = BertConfig.from_gguf_kv(kv), JConfig.from_gguf_kv(kv)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert (ours.head_dim, ours.attn_inner, ours.shared_layers) == (
        theirs.head_dim, theirs.attn_inner, theirs.shared_layers)
    assert ours.arch == J_PRESETS[preset].arch


@pytest.mark.parametrize("variant", ["t5-gated", "t5-dkv32"])
def test_t5_variants_read_back_from_kv(tmp_path, variant):
    """The gated FFN and d_kv 32 go through the file's kv to both readers."""
    jc = MODELS[variant]
    path = str(tmp_path / f"{variant}.gguf")
    pytest.importorskip("tokenizers")
    blob = build_unigram_tokenizer_json(jc.n_vocab)
    n = len(json.loads(blob)["model"]["vocab"])
    jc = dataclasses.replace(jc, n_vocab=n)
    write_bert_gguf(path, jc, jax_random_state_dict(jc, seed=0), blob, J_FTYPES["f32"])
    with GGUFReader(path) as r:
        ours = BertConfig.from_gguf_kv(r.kv)
    with JReader(path) as r:
        theirs = JConfig.from_gguf_kv(r.kv)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert (ours.ffn_act, ours.ffn_gated, ours.head_dim) == (
        jc.ffn_act, jc.ffn_gated, jc.head_dim)


def test_presets_have_the_published_geometry():
    """MPNET_BASE and GTR_BASE as the JAX package has them; each preset's
    parameter count from the schema equal to the published checkpoint's
    encoder (pooler and heads apart): all-mpnet-base-v2 109,486,464 with
    its 590,592-parameter pooler, T5EncoderModel t5-base 109,628,544,
    albert-base-v2 11,683,584 with its pooler."""
    for ours, theirs in ((MPNET_BASE, J_MPNET_BASE), (GTR_BASE, J_GTR_BASE)):
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name

    def n_params(c: BertConfig) -> int:
        maps = [schema.embedding_tensors(c), schema.extra_tensors(c)]
        once = sum(int(np.prod(fn(c))) for m in maps for _, fn in m.values())
        layer = sum(int(np.prod(fn(c))) for _, fn in schema.layer_tensor_names(0, c).values())
        return once + (1 if c.shared_layers else c.n_layer) * layer

    pooler = 768 * 768 + 768
    assert n_params(MPNET_BASE) == 109_486_464 - pooler
    assert n_params(GTR_BASE) == 109_628_544
    assert n_params(ALBERT_BASE) == 11_683_584 - pooler
    assert (ALBERT_BASE.n_embd_emb, ALBERT_BASE.gelu, ALBERT_BASE.shared_layers) == (
        128, "tanh", True)


# --- parameters ---------------------------------------------------------------------

@pytest.mark.parametrize("name,reranker", HEADS)
def test_random_state_dict_is_byte_identical(name, reranker):
    jc = _reranker(MODELS[name]) if reranker else MODELS[name]
    ours, theirs = random_state_dict(_pconfig(jc), seed=5), jax_random_state_dict(jc, seed=5)
    assert list(ours) == list(theirs)
    for name_ in theirs:
        assert ours[name_].dtype == theirs[name_].dtype
        assert ours[name_].tobytes() == theirs[name_].tobytes(), name_
    assert ("encoder.embedding_hidden_mapping_in.weight" in ours) == (name == "albert")
    assert ("encoder.relative_attention_bias.weight" in ours) == (name == "mpnet")
    assert ("encoder.final_layer_norm.weight" in ours) == name.startswith("t5")


@pytest.mark.parametrize("ftype", ["f32", "q4_0", "q8_0"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_random_params_match_jax_tree(name, ftype):
    jc = _reranker(MODELS[name]) if name in RERANKERS else MODELS[name]
    ours = random_params(_pconfig(jc), ftype, seed=1)
    assert_params_equal(ours, _bridge(jax_random_params(jc, J_FTYPES[ftype], seed=1)))
    stack = 1 if name == "albert" else jc.n_layer
    assert ours["layers"]["ln_out_scale"].shape == (stack, jc.n_embd)
    if name != "albert":
        assert tuple(ours["rel_attn_bias"].shape) == (32, jc.n_head)
        assert ours["rel_attn_bias"].dtype == torch.float32
    if name.startswith("t5"):
        assert "final_ln_scale" in ours and "q_b" not in ours["layers"]
        assert ("ffn_gate_w" in ours["layers"]) == (name == "t5-gated")


# --- forwards -----------------------------------------------------------------------

@pytest.fixture(scope="module", params=["f32", "q4_0"])
def models(request):
    """{name: (JAX config, JAX tree, port params)} from seed 1, MPNet and
    ALBERT with their heads."""
    out = {}
    for name, jc in MODELS.items():
        if name in RERANKERS:
            jc = _reranker(jc)
        jp = jax_random_params(jc, J_FTYPES[request.param], seed=1)
        out[name] = (jc, jp, _bridge(jp))
    return out


@pytest.mark.parametrize("s", [16, 64, 128])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_embed_batch_matches_jax(models, name, s):
    jc, jp, tp = models[name]
    ids, mask = _batch(3, s, jc.n_vocab, seed=s)
    ref = np.asarray(jax_embed_batch(jp, jnp.asarray(ids), jnp.asarray(mask), jc,
                                     PALLAS if s >= 128 else SMALL_S))
    got = bert_embed_batch(tp, *_t(ids, mask), _pconfig(jc)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_embed_packed_matches_jax(models, name):
    jc, jp, tp = models[name]
    ids, seg, pos = _packed(128, jc.n_vocab, seed=7)
    n_seg = 16
    slots = np.array([0, 1, n_seg, n_seg + 1, n_seg + 2], np.int64)
    ref = np.asarray(jax_embed_packed(jp, *map(jnp.asarray, (ids, seg, pos)), jc, PALLAS,
                                      n_seg=n_seg, gather_idx=jnp.asarray(slots, jnp.int32)))
    got = bert_embed_packed(tp, *_t(ids, seg, pos), _pconfig(jc), n_seg=n_seg,
                            gather_idx=torch.from_numpy(slots)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_packed_segments_equal_unpacked_sentences(models, name):
    """A packed sentence embeds as it does alone: positions (and the bias's
    offsets) restart in every segment, other segments are masked."""
    jc, _, tp = models[name]
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
@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_q4_tracks_jax(name, packed):
    jc = MODELS[name]
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


def test_t5_dkv128_bf16_tracks_jax():
    """d_kv 128 (gtr-t5-xl's head width; 2 heads of a 64-wide model): the
    bf16 product q * sqrt(128) rounds once before the kernel divides it
    out, on both sides; the forward holds the JAX one by cosine."""
    jc = dataclasses.replace(J_PRESETS["tiny-t5"], n_head=2, n_head_dim=128)
    jp = jax_random_params(jc, J_FTYPES["q4_0"], seed=3, dense_dtype=jnp.bfloat16)
    ids, mask = _batch(3, 128, jc.n_vocab, seed=4)
    ref = np.asarray(jax_embed_batch(jp, jnp.asarray(ids), jnp.asarray(mask), jc,
                                     JOpts(dtype="bfloat16", q4_impl="pallas",
                                           attn_impl="pallas")))
    got = bert_embed_batch(_bridge(jp), *_t(ids, mask), _pconfig(jc),
                           ComputeOptions(dtype="bfloat16")).numpy()
    assert _pconfig(jc).attn_inner == 256
    assert _cosines(got, ref).min() >= COSINE


@pytest.mark.parametrize("ftype", ["f32", "q4_0"])
@pytest.mark.parametrize("name", RERANKERS)
def test_score_batch_matches_jax(name, ftype):
    """MPNet's tanh ClassificationHead (one segment, no token-type table)
    and ALBERT's bare pooler + classifier (segments 0/1) on the first
    token, over the shared bias / the shared layer."""
    jc = _reranker(MODELS[name])
    jp = jax_random_params(jc, J_FTYPES[ftype], seed=2)
    ids, mask = _batch(4, 64, jc.n_vocab, seed=5)
    types = np.zeros_like(ids) if name == "mpnet" else (
        (np.arange(64)[None, :] >= 10).astype(np.int32) * mask)
    ref = np.asarray(jax_score_batch(jp, jnp.asarray(ids), jnp.asarray(mask), jc, SMALL_S,
                                     type_ids=jnp.asarray(types)))
    got = bert_score_batch(_bridge(jp), *_t(ids, mask), _pconfig(jc),
                           type_ids=torch.from_numpy(types)).numpy()
    assert got.shape == ref.shape == (4, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_t5_score_is_refused_on_both_sides():
    jc = MODELS["t5"]
    jp = jax_random_params(jc, J_FTYPES["f32"], seed=0)
    ids, mask = _batch(2, 16, jc.n_vocab, seed=1)
    with pytest.raises(ValueError, match="t5 encoders have no classification head"):
        jax_score_batch(jp, jnp.asarray(ids), jnp.asarray(mask), jc, SMALL_S)
    with pytest.raises(ValueError, match="t5 encoders have no classification head"):
        bert_score_batch(_bridge(jp), *_t(ids, mask), _pconfig(jc))


# --- tokenizer and Engine -------------------------------------------------------------

PACKED = _texts(40, 3, 14, seed=0)  # short: the engine packs these
UNPACKED = _texts(12, 3, 110, seed=1) + ["", "Hello, World!  Ünïcödé 中文",
                                         " ".join(["word"] * 200)]


@pytest.fixture(scope="module")
def engines(ggufs):
    made = {}

    def get(preset: str, reranker: bool = False, **kw):
        key = (preset, reranker, tuple(sorted(kw.items())))
        if key not in made:
            path = ggufs(preset, reranker)
            made[key] = (Engine.from_gguf(path, device="cpu", **kw),
                         JEngine.from_gguf(path, **kw))
        return made[key]

    return get


@pytest.mark.parametrize("preset", PRESETS)
def test_special_ids_and_tokens_match_jax(engines, preset):
    """The file's special ids and every framed token id of the texts; T5
    frames ids + </s> with no CLS, the others [CLS] .. [SEP]."""
    ours, theirs = engines(preset)
    assert dataclasses.asdict(ours.special_ids) == dataclasses.asdict(theirs.special_ids)
    texts = PACKED + UNPACKED
    got = ours.tokenize_batch(texts)
    assert got == theirs.tokenize_batch(texts)
    assert [ours.tokenize(t) for t in texts[:5]] == [theirs.tokenize(t) for t in texts[:5]]
    sep, cls = ours.special_ids.sep, ours.special_ids.cls
    assert all(t[-1] == sep for t in got)
    assert all((t[0] == cls) == (preset != "tiny-t5") for t in got)
    assert max(map(len, got)) == ours.config.n_ctx


@pytest.mark.parametrize("preset", PRESETS)
def test_truncate_false_context_check_matches_jax(engines, preset, monkeypatch):
    """truncate=False refuses exactly the id lists the JAX Engine refuses:
    n_ctx - 1 ids frame to n_ctx tokens under T5 (no CLS) and are served,
    to n_ctx + 1 elsewhere and are refused.  Both tokenizers hand the
    framing the same id lists of n_ctx - 3 .. n_ctx + 1 ids."""
    ours, theirs = engines(preset)
    n_ctx = ours.config.n_ctx
    lists = [list(range(5, 5 + n)) for n in range(n_ctx - 3, n_ctx + 2)]
    specials = 1 if preset == "tiny-t5" else 2
    for engine in (ours, theirs):
        monkeypatch.setattr(engine.tokenizer, "encode_batch", lambda texts: [lists[int(t)]
                                                                             for t in texts])
    for i, ids in enumerate(lists):
        outcomes = []
        for engine in (ours, theirs):
            try:
                outcomes.append(engine.tokenize_batch([str(i)], truncate=False)[0])
            except ValueError as e:
                assert "tokens framed" in str(e)
                outcomes.append(None)
        assert outcomes[0] == outcomes[1], len(ids)
        assert (outcomes[0] is None) == (len(ids) + specials > n_ctx), len(ids)
    assert ours.tokenize_batch([str(len(lists) - 1)])[0] == theirs.tokenize_batch(
        [str(len(lists) - 1)])[0]  # truncated alike


@pytest.mark.parametrize("preset", ["tiny-mpnet", "tiny-albert"])
def test_tokenize_pairs_matches_jax(engines, preset):
    """MPNet pairs frame <s> a </s></s> b </s> with one segment; ALBERT
    [CLS] a [SEP] b [SEP] with segments 0/1."""
    ours, theirs = engines(preset)
    pairs = list(zip(PACKED[:10], UNPACKED[:10])) + [("", UNPACKED[-1]), (UNPACKED[-1], "a")]
    got, want = ours.tokenize_pairs(pairs), theirs.tokenize_pairs(pairs)
    assert got == want
    ids, types = got
    assert max(map(len, ids)) == ours.config.n_ctx
    sep = ours.special_ids.sep
    double = [any(t[i] == t[i + 1] == sep for i in range(len(t) - 2)) for t in ids]
    if preset == "tiny-mpnet":
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
def test_pack_seq_and_packing_always_match_jax(engines, preset):
    """Rows of 64 tokens packed "always" (the long texts that fit take the
    packed path too), and `encode_with_counts`' framed token counts."""
    ours, theirs = engines(preset, pack_seq=64, packing="always")
    assert ours.pack_seq == theirs.pack_seq == 64
    texts = PACKED[:20] + UNPACKED[:6]
    ids = ours.tokenize_batch(texts)
    assert ours._pack_plan(ids) == theirs._pack_plan(theirs.tokenize_batch(texts))
    got, counts = ours.encode_with_counts(texts)
    want, want_counts = theirs.encode_with_counts(texts)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert counts == want_counts == [len(t) for t in ids]


@pytest.mark.parametrize("preset", ["tiny-mpnet", "tiny-albert"])
def test_score_pairs_and_rerank_match_jax(engines, preset):
    ours, theirs = engines(preset, reranker=True)
    assert ours.config.n_labels == 1
    query = UNPACKED[0]
    docs = UNPACKED[1:8] + [""]
    pairs = [(query, d) for d in docs]
    np.testing.assert_allclose(ours.score_pairs(pairs), theirs.score_pairs(pairs),
                               rtol=0, atol=ATOL)
    got, want = ours.rerank(query, docs, top_n=5), theirs.rerank(query, docs, top_n=5)
    assert [r["index"] for r in got] == [r["index"] for r in want]
    np.testing.assert_allclose([r["relevance_score"] for r in got],
                               [r["relevance_score"] for r in want], rtol=0, atol=1e-5)


def test_t5_engine_has_no_rerank(engines):
    ours, _ = engines("tiny-t5")
    with pytest.raises(RuntimeError, match="no classification head"):
        ours.score_pairs([("a", "b")])


@pytest.mark.parametrize("preset,reranker", [(p, False) for p in PRESETS]
                         + [("tiny-mpnet", True), ("tiny-albert", True)])
def test_gguf_round_trip(ggufs, preset, reranker):
    """The same GGUF through both loaders: the same config, the same leaves
    bit for bit (ALBERT's one-layer stack, the relative-bias tables, T5's
    final norm, the heads)."""
    path = ggufs(preset, reranker)
    with GGUFReader(path) as r:
        ours, config = load_params(r)
    with JReader(path) as r:
        theirs, jconfig = jax_load_params(r)
    for f in dataclasses.fields(config):
        assert getattr(config, f.name) == getattr(jconfig, f.name), f.name
    assert_params_equal(ours, _bridge(theirs))
    assert ("head" in ours) == reranker
