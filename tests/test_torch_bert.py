"""The port's BERT forward against the JAX package's, on a tiny config
(2 layers, n_embd 128, 4 heads of 32, n_ff 256) with f32 and q4_0 weights
from the same seed.

At S = 128 JAX runs its Pallas kernels in interpret mode (q4_impl and
attn_impl "pallas"); at the small buckets S = 16/32 it takes its XLA einsum
attention, which is what JAX serves there.  f32 tolerance 2e-5 absolute,
the JAX package's own bar for its kernel paths.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embedding_cpp_tpu.models.bert import ComputeOptions as JOpts
from embedding_cpp_tpu.models.bert import bert_embed_batch as jax_embed_batch
from embedding_cpp_tpu.models.bert import bert_embed_packed as jax_embed_packed
from embedding_cpp_tpu.models.bert import unpack_output_i8 as jax_unpack_i8
from embedding_cpp_tpu.models.config import BertConfig as JConfig
from embedding_cpp_tpu.models.convert import FTYPE_NAMES as J_FTYPES
from embedding_cpp_tpu.models.params import random_params as jax_random_params
from embedding_cpp_tpu_torch.models import (
    BertConfig,
    ComputeOptions,
    bert_embed_batch,
    bert_embed_packed,
    random_params,
)
from embedding_cpp_tpu_torch.models.bert import unpack_output_i8

ATOL = 2e-5
TINY = dict(n_vocab=300, n_ctx=128, n_embd=128, n_layer=2, n_head=4, n_ff=256)
PALLAS = JOpts(dtype="float32", q4_impl="pallas", attn_impl="pallas")


@pytest.fixture(scope="module", params=["f32", "q4_0"])
def models(request):
    ftype = request.param
    return (ftype, random_params(BertConfig(**TINY), ftype, seed=0),
            jax_random_params(JConfig(**TINY), J_FTYPES[ftype], seed=0))


def _batch(b: int, s: int, lens, seed: int = 0):
    ids = np.random.default_rng(seed).integers(5, TINY["n_vocab"], (b, s)).astype(np.int32)
    mask = np.zeros((b, s), np.int32)
    for i, n in enumerate(lens):
        mask[i, :n] = 1
    ids[mask == 0] = 0
    return ids, mask


def _packed(s: int = 128, seed: int = 0):
    """Two packed rows: assorted segments, a -1 tail, and an all-padding row."""
    seg = np.full((3, s), -1, np.int32)
    pos = np.zeros((3, s), np.int32)
    c = 0
    for g, n in enumerate([7, 30, 3, 19, 50]):
        seg[0, c:c + n], pos[0, c:c + n] = g, np.arange(n)
        c += n
    c = 0
    for g, n in enumerate([64, 64]):
        seg[1, c:c + n], pos[1, c:c + n] = g, np.arange(n)
        c += n
    ids = np.random.default_rng(seed).integers(5, TINY["n_vocab"], (3, s)).astype(np.int32)
    ids[seg < 0] = 0
    return ids, seg, pos


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_embed_batch_s128_matches_pallas_path(models):
    _, tp, jp = models
    ids, mask = _batch(3, 128, [128, 77, 1])
    ref = np.asarray(jax_embed_batch(jp, jnp.asarray(ids), jnp.asarray(mask),
                                     JConfig(**TINY), PALLAS))
    got = bert_embed_batch(tp, *_t(ids, mask), BertConfig(**TINY)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("s", [16, 32])
def test_embed_batch_small_buckets_match_xla_path(models, s):
    _, tp, jp = models
    ids, mask = _batch(4, s, [s, s - 3, 5, 2], seed=s)
    opts = JOpts(dtype="float32", q4_impl="pallas", attn_impl="xla")
    ref = np.asarray(jax_embed_batch(jp, jnp.asarray(ids), jnp.asarray(mask),
                                     JConfig(**TINY), opts))
    got = bert_embed_batch(tp, *_t(ids, mask), BertConfig(**TINY)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_embed_batch_gather_idx(models):
    _, tp, jp = models
    ids, mask = _batch(4, 32, [32, 10, 3, 0])
    gidx = np.array([2, 0], np.int64)
    opts = JOpts(dtype="float32", q4_impl="pallas", attn_impl="xla")
    ref = np.asarray(jax_embed_batch(jp, jnp.asarray(ids), jnp.asarray(mask),
                                     JConfig(**TINY), opts,
                                     gather_idx=jnp.asarray(gidx, jnp.int32)))
    got = bert_embed_batch(tp, *_t(ids, mask), BertConfig(**TINY),
                           gather_idx=torch.from_numpy(gidx)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_embed_packed_matches_pallas_path(models):
    _, tp, jp = models
    ids, seg, pos = _packed()
    n_seg = 8
    ref = np.asarray(jax_embed_packed(jp, *map(jnp.asarray, (ids, seg, pos)),
                                      JConfig(**TINY), PALLAS, n_seg=n_seg))
    got = bert_embed_packed(tp, *_t(ids, seg, pos), BertConfig(**TINY),
                            n_seg=n_seg).numpy()
    assert got.shape == (3, n_seg, TINY["n_embd"])
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert np.all(got[2] == 0.0)  # empty slots are zero vectors


def test_packed_segments_equal_unpacked_sentences(models):
    """A packed sentence embeds as it does alone in a plain batch."""
    _, tp, _ = models
    ids, seg, pos = _packed()
    config = BertConfig(**TINY)
    packed = bert_embed_packed(tp, *_t(ids, seg, pos), config, n_seg=8).numpy()
    lo, hi = 7, 37  # row 0, segment 1
    one = np.zeros((1, 32), np.int32)
    one[0, : hi - lo] = ids[0, lo:hi]
    mask = (np.arange(32) < hi - lo).astype(np.int32)[None]
    alone = bert_embed_batch(tp, *_t(one, mask), config).numpy()
    np.testing.assert_allclose(packed[0, 1], alone[0], rtol=0, atol=1e-5)


def test_packed_gather_matches_jax(models):
    _, tp, jp = models
    ids, seg, pos = _packed()
    slots = np.array([0, 1, 4, 8, 9], np.int64)  # row * n_seg + segment
    ref = np.asarray(jax_embed_packed(
        jp, *map(jnp.asarray, (ids, seg, pos)), JConfig(**TINY), PALLAS,
        n_seg=8, gather_idx=jnp.asarray(slots, jnp.int32)))
    got = bert_embed_packed(tp, *_t(ids, seg, pos), BertConfig(**TINY), n_seg=8,
                            gather_idx=torch.from_numpy(slots)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_int8_output_matches_jax(models):
    """Packed int8 output: identical codes and scales, or — where a
    rounding tie flips one code — cosine >= 0.9999 after decoding."""
    _, tp, jp = models
    ids, mask = _batch(3, 32, [32, 20, 4], seed=7)
    jo = JOpts(dtype="float32", q4_impl="pallas", attn_impl="xla", output_dtype="int8")
    ref = np.asarray(jax_embed_batch(jp, jnp.asarray(ids), jnp.asarray(mask),
                                     JConfig(**TINY), jo))
    got = bert_embed_batch(tp, *_t(ids, mask), BertConfig(**TINY),
                           ComputeOptions(output_dtype="int8")).numpy()
    assert got.dtype == np.uint8 and got.shape == ref.shape == (3, TINY["n_embd"] + 4)
    if not np.array_equal(got, ref):
        a, b = unpack_output_i8(got), jax_unpack_i8(ref)
        cos = np.sum(a * b, -1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)
        assert cos.min() >= 0.9999
    np.testing.assert_allclose(unpack_output_i8(got), jax_unpack_i8(ref), atol=1e-2)


def test_bf16_activations_track_f32(models):
    """bf16 activations stay close to the f32 forward (cosine >= 0.999)."""
    ftype, _, _ = models
    config = BertConfig(**TINY)
    tp16 = random_params(config, ftype, seed=0, dense_dtype=torch.bfloat16)
    tp32 = random_params(config, ftype, seed=0)
    ids, mask = _batch(2, 32, [32, 11])
    a = bert_embed_batch(tp16, *_t(ids, mask), config, ComputeOptions(dtype="bfloat16"))
    b = bert_embed_batch(tp32, *_t(ids, mask), config)
    assert torch.sum(a * b, -1).min() >= 0.999


@pytest.mark.parametrize("pooling", ["mean", "cls", "max"])
def test_pooling_matches_jax(pooling):
    from embedding_cpp_tpu.models.bert import pool_normalize as jax_pool
    from embedding_cpp_tpu.models.bert import pool_normalize_packed as jax_pool_packed
    from embedding_cpp_tpu_torch.models.bert import pool_normalize, pool_normalize_packed

    x = np.random.default_rng(3).normal(size=(3, 128, 16)).astype(np.float32)
    _, mask = _batch(3, 128, [128, 9, 0])
    ids, seg, pos = _packed()
    np.testing.assert_allclose(
        pool_normalize(torch.from_numpy(x), torch.from_numpy(mask), pooling).numpy(),
        np.asarray(jax_pool(jnp.asarray(x), jnp.asarray(mask), pooling)),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        pool_normalize_packed(*_t(x, seg, pos), 8, pooling).numpy(),
        np.asarray(jax_pool_packed(*map(jnp.asarray, (x, seg, pos)), 8, pooling)),
        rtol=0, atol=1e-6)
