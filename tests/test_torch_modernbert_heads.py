"""The rest of ModernBERT in the port against the JAX package: the
cross-encoder head (gte-reranker-modernbert-base), packed rows past 1024
tokens, and mode 3 of the long-row kernel (the segment mask with the
sliding window) through its plain version.

The JAX side runs as its own tests run it on the CPU: under the tier-1 run
it sees 8 CPU devices, so ModernBERT takes its XLA einsum attention, with
the [B, S, S] segment and window biases of `modernbert_embed_packed` past
1024 tokens.  The port runs its kernels' plain versions.  Score logits:
cls and mean pooling, f32 and Q4_0 weights, S = 16 (K3/K4), 128 and 1100
(K5 with the window bias: no slice at S % 128 != 0).  Packed rows: S = 1032
(K6a and mode 3 over the whole row) and 2048 (K6a/K6b and mode 3 over K7's
slices), 2 layers (one global, one local), 2 heads, B <= 2.
Tolerances: f32 atol 2e-5 (rtol 1e-4 on logits); bf16 logits by Pearson
>= 0.999 against the JAX f32 path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embedding_cpp_tpu.cli.make_test_model import make_test_model
from embedding_cpp_tpu.models.bert import ComputeOptions as JOpts
from embedding_cpp_tpu.models.bert import bert_embed_packed as jax_embed_packed
from embedding_cpp_tpu.models.bert import bert_score_batch as jax_score_batch
from embedding_cpp_tpu.models.config import BertConfig as JConfig
from embedding_cpp_tpu.models.convert import FTYPE_NAMES as J_FTYPES
from embedding_cpp_tpu.models.params import random_params as jax_random_params
from embedding_cpp_tpu.models.params import random_state_dict as jax_random_state_dict
from embedding_cpp_tpu.models.schema import head_tensors as jax_head_tensors
from embedding_cpp_tpu.runtime.engine import Engine as JEngine
from embedding_cpp_tpu_torch import Engine
from embedding_cpp_tpu_torch.models import (
    BertConfig,
    ComputeOptions,
    bert_embed_packed,
    bert_score_batch,
    from_jax_params,
    random_params,
    random_state_dict,
)
from embedding_cpp_tpu_torch.models.schema import head_tensors
from embedding_cpp_tpu_torch.ops.attention import (
    MASK_BIAS,
    attention_packed_local_plain,
    flash_attention_packed_local,
    local_window_tiles,
)
from embedding_cpp_tpu_torch.runtime.batching import pack_segments

RERANKER = dict(n_vocab=300, n_ctx=2048, n_embd=64, n_layer=4, n_head=4, n_ff=128,
                n_token_types=0, arch="modernbert", layer_norm_eps=1e-5,
                rope_theta=160000.0, local_rope_theta=10000.0, global_attn_every=3,
                local_window=16, n_labels=1, head_activation="gelu", pooling="cls")
# the packed rows past 1024: one global layer, one local, 2 heads of 32
PACKED = dict(RERANKER, n_layer=2, n_head=2, global_attn_every=2, local_window=128,
              n_labels=0, pooling="mean")
ATOL, RTOL = 2e-5, 1e-4


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _pair_batch(b: int, s: int, seed: int):
    """Row 0 full, row 1 a third long, the rest random lengths."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, RERANKER["n_vocab"], (b, s)).astype(np.int32)
    lens = [s, max(1, s // 3)] + [int(n) for n in rng.integers(1, s + 1, b - 2)]
    mask = (np.arange(s)[None, :] < np.array(lens)[:, None]).astype(np.int32)
    ids[mask == 0] = 0
    return ids, mask


@pytest.fixture(scope="module", params=["f32", "q4_0"])
def rerankers(request):
    out = {}
    for pooling in ("cls", "mean"):
        config = dict(RERANKER, pooling=pooling)
        jp = jax_random_params(JConfig(**config), J_FTYPES[request.param], seed=2)
        out[pooling] = config, jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    return out


def test_head_schema_matches_jax():
    config = BertConfig(**RERANKER)
    ours = {k: (v[0], v[1](config)) for k, v in head_tensors(config).items()}
    theirs = {k: (v[0], v[1](config)) for k, v in jax_head_tensors(JConfig(**RERANKER)).items()}
    assert ours == theirs
    assert set(ours) == {"head.dense.weight", "head.norm.weight", "classifier.weight",
                         "classifier.bias"}


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_random_state_dict_with_the_head_is_byte_identical(pooling):
    config = dict(RERANKER, pooling=pooling)
    ours = random_state_dict(BertConfig(**config), seed=3)
    theirs = jax_random_state_dict(JConfig(**config), seed=3)
    assert list(ours) == list(theirs)
    for name in ours:
        assert ours[name].tobytes() == np.asarray(theirs[name]).tobytes(), name


def test_head_loads_dense_f32_in_matmul_orientation():
    params = random_params(BertConfig(**RERANKER), "q4_0", seed=2)
    head = params["head"]
    assert set(head) == {"dense_w", "norm_scale", "out_w", "out_b"}
    assert all(t.dtype == torch.float32 for t in head.values())
    assert head["dense_w"].shape == (64, 64) and head["out_w"].shape == (64, 1)


@pytest.mark.parametrize("pooling", ["cls", "mean"])
@pytest.mark.parametrize("s", [16, 128, 1100])
def test_score_batch_matches_jax(rerankers, pooling, s):
    config, jp, tp = rerankers[pooling]
    ids, mask = _pair_batch(3 if s <= 128 else 2, s, seed=s)
    ref = np.asarray(jax_score_batch(jp, jnp.asarray(ids), jnp.asarray(mask),
                                     JConfig(**config), JOpts(dtype="float32")))
    got = bert_score_batch(tp, *_t(ids, mask), BertConfig(**config)).numpy()
    assert got.shape == ref.shape == (ids.shape[0], 1)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
def test_score_head_gelu_is_exact_whatever_the_config_says(gelu):
    """The PredictionHead's GELU is erf even where the encoder's FFN takes
    the tanh form (the reference's approximate=False)."""
    config = dict(RERANKER, gelu=gelu, n_labels=2)
    jp = jax_random_params(JConfig(**config), J_FTYPES["f32"], seed=4)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    ids, mask = _pair_batch(3, 32, seed=4)
    ref = np.asarray(jax_score_batch(jp, jnp.asarray(ids), jnp.asarray(mask),
                                     JConfig(**config), JOpts(dtype="float32")))
    got = bert_score_batch(tp, *_t(ids, mask), BertConfig(**config)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_score_batch_bf16_tracks_jax():
    """The same Q4_0 weights: bf16 activations against the JAX f32 path."""
    config = dict(RERANKER, pooling="mean")
    trees = [jax_random_params(JConfig(**config), J_FTYPES["q4_0"], seed=2, dense_dtype=dt)
             for dt in (jnp.float32, jnp.bfloat16)]
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, trees[1]))
    ids, mask = _pair_batch(16, 128, seed=5)
    ref = np.asarray(jax_score_batch(trees[0], jnp.asarray(ids), jnp.asarray(mask),
                                     JConfig(**config), JOpts(dtype="float32")))[:, 0]
    got = bert_score_batch(tp, *_t(ids, mask), BertConfig(**config),
                           ComputeOptions(dtype="bfloat16")).numpy()[:, 0]
    assert np.corrcoef(got, ref)[0, 1] >= 0.999


def test_score_batch_without_a_head_raises():
    config = dict(RERANKER, n_labels=0)
    params = random_params(BertConfig(**config), seed=0)
    ids, mask = _pair_batch(2, 16, seed=0)
    with pytest.raises(ValueError, match="no classification head"):
        bert_score_batch(params, *_t(ids, mask), BertConfig(**config))


# --- tiny-modernbert-reranker: the GGUF, the pair framing and the Engine ---

PAIRS = [("what is the capital of france", "paris is the capital and largest city of france"),
         ("how do magnets work", "a magnet makes a magnetic field"),
         ("", "an empty query"), ("a long query " * 20, "short"),
         ("Hello, World!  Ünïcödé 中文", "the quick brown fox jumps over the lazy dog")]


@pytest.fixture(scope="module", params=["f32", "q4_0"])
def reranker_engines(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gguf") / f"mbr-{request.param}.gguf")
    make_test_model(path, "tiny-modernbert-reranker", request.param, seed=0)
    return Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)


def test_reranker_loads_with_its_head(reranker_engines):
    ours, theirs = reranker_engines
    assert ours.config.n_labels == theirs.config.n_labels == 1
    assert ours.config.pooling == theirs.config.pooling
    assert set(ours.params["head"]) == {"dense_w", "norm_scale", "out_w", "out_b"}


def test_reranker_pair_framing_and_plan_match_jax(reranker_engines):
    ours, theirs = reranker_engines
    ids, types = ours.tokenize_pairs(PAIRS)
    assert (ids, types) == tuple(theirs.tokenize_pairs(PAIRS))
    sp = ours.special_ids
    for row in ids:
        assert row[0] == sp.cls and row[-1] == sp.sep and row.count(sp.sep) == 2
    planned = sorted(i for b in ours.score_plan(ids) for i in b.positions)
    assert planned == list(range(len(PAIRS)))


def test_reranker_scores_and_rerank_match_jax(reranker_engines):
    ours, theirs = reranker_engines
    np.testing.assert_allclose(ours.score_pairs(PAIRS), theirs.score_pairs(PAIRS),
                               rtol=RTOL, atol=ATOL)
    docs = [b for _, b in PAIRS]
    got, want = ours.rerank("capital of france", docs), theirs.rerank("capital of france", docs)
    assert [r["index"] for r in got] == [r["index"] for r in want]
    np.testing.assert_allclose([r["relevance_score"] for r in got],
                               [r["relevance_score"] for r in want], rtol=0, atol=ATOL)


def test_reranker_encodes_like_jax(reranker_engines):
    ours, theirs = reranker_engines
    texts = [a for a, _ in PAIRS]
    np.testing.assert_allclose(ours.encode(texts), theirs.encode(texts), rtol=0, atol=ATOL)


# --- mode 3: the segment mask with the sliding window ------------------------

def _segments(b: int, s: int, window: int, seed: int) -> np.ndarray:
    """Row 0: segments shorter and longer than the window (1 .. 3 windows)
    and a padded tail; row 1 (when b > 1): one segment over most of the
    row; a last row of b > 2 all padding."""
    rng = np.random.default_rng(seed)
    seg = np.full((b, s), -1, np.int32)
    c = g = 0
    while c < s - 40:
        n = int(rng.choice([rng.integers(1, window // 2), rng.integers(window, 3 * window)]))
        seg[0, c:c + n] = g
        c, g = c + n, g + 1
    if b > 1:
        seg[1, : s - 17] = 0
    return seg


def _reference_local(q, k, v, seg, window):
    """The reference's XLA local layer on packed rows (modernbert.py:
    bias_local from the per-segment distances, scores * scale + bias,
    jax.nn.softmax, then p . v), per-segment positions built from seg."""
    b, s, h, d = q.shape
    pos = np.zeros_like(seg)
    for r in range(b):
        for c in range(s):
            pos[r, c] = 0 if c == 0 or seg[r, c] != seg[r, c - 1] else pos[r, c - 1] + 1
    seg, pos = jnp.asarray(seg), jnp.asarray(pos)
    allowed = seg[:, :, None] == seg[:, None, :]
    key_ok = (seg >= 0)[:, None, :]
    bias_global = jnp.where(allowed & key_ok, 0.0, MASK_BIAS).astype(jnp.float32)
    dist = jnp.abs(pos[:, None, :] - pos[:, :, None])
    bias_local = jnp.where(dist <= window // 2, bias_global, MASK_BIAS)
    scores = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), jnp.asarray(k),
                        preferred_element_type=jnp.float32)
    scores = scores * (1.0 / d**0.5) + bias_local[:, None, :, :]
    probs = jax.nn.softmax(scores, axis=-1)
    return np.asarray(jnp.einsum("bhqk,bkhd->bqhd", probs, jnp.asarray(v),
                                 preferred_element_type=jnp.float32))


@pytest.mark.parametrize("s,window", [(1032, 128), (1152, 128), (2048, 128), (2048, 16),
                                      (1100, 64)])
def test_packed_local_plain_matches_the_reference_on_real_rows(s, window):
    b, h, d = 2 if s >= 2048 else 3, 2, 32
    rng = np.random.default_rng(s + window)
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    seg = _segments(b, s, window, seed=s)
    ref = _reference_local(q, k, v, seg, window)
    got = flash_attention_packed_local(*_t(q, k, v), torch.from_numpy(seg), window).numpy()
    real = seg >= 0
    np.testing.assert_allclose(got[real], ref[real], rtol=0, atol=ATOL)


@pytest.mark.parametrize("s", [1032, 2048])
def test_packed_local_slices_agree_with_the_whole_row(s):
    """Where S has K7's slices (S % 128 == 0), the sliced plain version
    equals the whole-row form on real rows: every visible key of a real
    query lies in its tile's slice."""
    window = 128
    rng = np.random.default_rng(s)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, s, 2, 16)).astype(np.float32))
               for _ in range(3))
    seg = torch.from_numpy(_segments(2, s, window, seed=s + 1))
    got = attention_packed_local_plain(q, k, v, seg, window)
    tq, wmax = local_window_tiles(s, window)
    assert (wmax is None) == (s % 128 != 0)
    whole = attention_packed_local_plain(q, k, v, seg, 10 * s)  # a window past the row: K6
    real = seg >= 0
    assert torch.isfinite(got).all() and not torch.equal(got[real], whole[real])
    # the whole-row form of the same window: the query rows in chunks
    flat = torch.cat([attention_packed_local_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                                   seg[i:i + 1], window) for i in range(2)])
    torch.testing.assert_close(flat, got, rtol=0, atol=0)


def test_packed_local_pads_rows_to_a_multiple_of_8():
    """S % 8 != 0 runs padded to the next multiple of 8 with keys of segment
    -1: the real rows equal the unpadded plain version's."""
    s, window = 1100, 128
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, s, 2, 16)).astype(np.float32))
               for _ in range(3))
    seg = torch.from_numpy(_segments(1, s, window, seed=7))
    got = flash_attention_packed_local(q, k, v, seg, window)
    assert got.shape == q.shape
    ref = attention_packed_local_plain(q, k, v, seg, window)
    real = seg >= 0
    torch.testing.assert_close(got[real], ref[real], rtol=0, atol=1e-6)


# --- packed ModernBERT rows past 1024 ---------------------------------------

@pytest.fixture(scope="module", params=["f32", "q4_0"])
def packed_models(request):
    jp = jax_random_params(JConfig(**PACKED), J_FTYPES[request.param], seed=5)
    return jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp))


def _pack(s: int, seed: int):
    rng = np.random.default_rng(seed)
    toks = [list(rng.integers(5, PACKED["n_vocab"], size=int(n)))
            for n in rng.integers(20, s // 3, size=8)]
    pb = pack_segments(toks, list(range(len(toks))), 0, seq_len=s, n_seg=16)[0]
    return pb


@pytest.mark.parametrize("s", [1032, 2048])
@pytest.mark.parametrize("bounded", [False, True], ids=["every-key", "max_seg_len"])
def test_packed_forward_past_1024_matches_jax(packed_models, s, bounded):
    jp, tp = packed_models
    pb = _pack(s, seed=s)
    assert pb.ids.shape[0] <= 2 and pb.ids.shape[1] == s
    msl = 1 << max(5, (pb.max_len - 1).bit_length()) if bounded else None
    ref = np.asarray(jax_embed_packed(jp, *map(jnp.asarray, (pb.ids, pb.seg, pb.pos)),
                                      JConfig(**PACKED), JOpts(dtype="float32"),
                                      n_seg=pb.n_seg, max_seg_len=msl))
    got = bert_embed_packed(tp, *_t(pb.ids, pb.seg, pb.pos), BertConfig(**PACKED),
                            n_seg=pb.n_seg, max_seg_len=msl).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_packed_forward_past_1024_bf16_tracks_jax():
    """The same Q4_0 weights: bf16 activations against the JAX f32 path,
    every real segment's vector by cosine."""
    trees = [jax_random_params(JConfig(**PACKED), J_FTYPES["q4_0"], seed=5, dense_dtype=dt)
             for dt in (jnp.float32, jnp.bfloat16)]
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, trees[1]))
    pb = _pack(2048, seed=9)
    ref = np.asarray(jax_embed_packed(trees[0], *map(jnp.asarray, (pb.ids, pb.seg, pb.pos)),
                                      JConfig(**PACKED), JOpts(dtype="float32"),
                                      n_seg=pb.n_seg)).reshape(-1, 64)
    got = bert_embed_packed(tp, *_t(pb.ids, pb.seg, pb.pos), BertConfig(**PACKED),
                            ComputeOptions(dtype="bfloat16"), n_seg=pb.n_seg).numpy()
    got = got.reshape(-1, 64)
    real = np.linalg.norm(ref, axis=-1) > 0
    cos = np.sum(got[real] * ref[real], -1) / np.linalg.norm(got[real], axis=-1)
    assert real.sum() == 8 and cos.min() >= 0.999


def test_packed_rows_past_1024_take_the_segment_kernels(packed_models, monkeypatch):
    """Global layers call K6 (`flash_attention_packed`, with the bound),
    local layers mode 3 (`flash_attention_packed_local`), once per layer."""
    from embedding_cpp_tpu_torch.models import modernbert

    _, tp = packed_models
    calls = []
    for name in ("flash_attention_packed", "flash_attention_packed_local"):
        real = getattr(modernbert, name)
        monkeypatch.setattr(modernbert, name,
                            lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    pb = _pack(1032, seed=1)
    bert_embed_packed(tp, *_t(pb.ids, pb.seg, pb.pos), BertConfig(**PACKED), n_seg=pb.n_seg,
                      max_seg_len=512)
    assert calls == ["flash_attention_packed", "flash_attention_packed_local"]
