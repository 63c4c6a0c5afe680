"""The port's nomic-bert path against the JAX package's, on a small config
(2 layers, 64 wide, 4 heads of 16, SwiGLU FFN 128, n_ctx 2048, NTK scaling
past 128 trained positions), with the JAX model's Pallas kernels in
interpret mode (`attn_impl="pallas"`, `q4_impl="pallas"`) and the port's
kernels' plain versions.

Covered: the config (from kv, from a tiny-nomic GGUF, the preset), the
state dict and parameters (with and without the attention and FFN biases,
fc11/fc12 told apart), the NTK inverse frequencies, the segment kernel K6
in both forms against `_flash_attention_packed` /
`_flash_attention_packed_window` on every row, the batch and packed
forwards on every attention route (K2, K3, K5, K6a, K6b), and the Engine's
`pack_seq` / `packing="always"` / segment bound, prompts and `dimensions`
against the JAX Engine.  Tolerances: f32 atol 2e-5, rtol 1e-4 (the JAX
package's own bar); bf16 min cosine 0.999; config and params bit-exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embedding_cpp_tpu.models.bert import ComputeOptions as JOpts
from embedding_cpp_tpu.models.bert import bert_embed_batch as jax_embed_batch
from embedding_cpp_tpu.models.bert import bert_embed_packed as jax_embed_packed
from embedding_cpp_tpu.models.config import NOMIC_EMBED as J_NOMIC_EMBED
from embedding_cpp_tpu.models.config import BertConfig as JConfig
from embedding_cpp_tpu.models.convert import FTYPE_NAMES as J_FTYPES
from embedding_cpp_tpu.models.params import build_params as jax_build_params
from embedding_cpp_tpu.models.params import random_state_dict as jax_random_state_dict
from embedding_cpp_tpu.models.params import source_from_arrays as jax_source
from embedding_cpp_tpu_torch.models import (
    NOMIC_EMBED,
    BertConfig,
    ComputeOptions,
    bert_embed_batch,
    bert_embed_packed,
    bert_score_batch,
    from_jax_params,
    random_state_dict,
)
from embedding_cpp_tpu_torch.models.params import FTYPE_NAMES, build_params, source_from_arrays
from embedding_cpp_tpu_torch.ops.attention import (
    attention_packed_plain,
    attention_packed_window_plain,
    flash_attention_packed,
    packed_bse_applies,
    packed_window_tiles,
)
from embedding_cpp_tpu_torch.ops.qtensor import QTensor

SMALL = dict(n_vocab=300, n_ctx=2048, n_embd=64, n_layer=2, n_head=4, n_ff=128,
             arch="nomic-bert", rope_theta=1000.0, rope_scaling_factor=2.0,
             rope_max_trained=128, attn_bias=False, ffn_bias=False)
BIASED = dict(SMALL, attn_bias=True, ffn_bias=True)
ATOL, RTOL = 2e-5, 1e-4
COSINE = 0.999
JAX_OPTS = dict(attn_impl="pallas", q4_impl="pallas")


def _state_dict(config: dict, seed: int = 1) -> dict:
    """random_state_dict with random biases (the generator leaves them 0)
    and fc11 (the gate) scaled apart from fc12 (the activated half)."""
    sd = jax_random_state_dict(JConfig(**config), seed=seed)
    rng = np.random.default_rng(seed + 100)
    for name in sd:
        if name.endswith(".bias") and (".attn." in name or ".mlp." in name):
            sd[name] = (rng.standard_normal(sd[name].shape) * 0.05).astype(np.float32)
        if "fc11.weight" in name:
            sd[name] = sd[name] * 3.0
    return sd


def _trees(config: dict, ftype: str, dtype=jnp.float32):
    """(JAX tree, the port's tree carried across) of `_state_dict`."""
    jp = jax_build_params(jax_source(_state_dict(config), J_FTYPES[ftype]), JConfig(**config),
                          dense_dtype=dtype)
    return jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp))


@pytest.fixture(scope="module", params=["f32", "q4_0"])
def models(request):
    return (request.param, *_trees(SMALL, request.param))


@pytest.fixture(scope="module")
def biased_models():
    return ("f32", *_trees(BIASED, "f32"))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, -1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def _batch(b: int, s: int, seed: int):
    """Row 0 full, row 1 a third long, the rest random lengths."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, SMALL["n_vocab"], (b, s)).astype(np.int32)
    lens = [s, max(1, s // 3)] + [int(n) for n in rng.integers(1, s + 1, b - 2)]
    mask = (np.arange(s)[None, :] < np.array(lens)[:, None]).astype(np.int32)
    ids[mask == 0] = 0
    return ids, mask


def _segments(b: int, s: int, max_len: int, seed: int, tile: int = 0):
    """seg/pos [b, s]: row 0 segments of 3..max_len tokens, with `tile` > 0
    two of them ending exactly on multiples of `tile`, then a padded tail;
    row 1 (when b > 1) all padding."""
    rng = np.random.default_rng(seed)
    seg = np.full((b, s), -1, np.int32)
    pos = np.zeros((b, s), np.int32)
    c = g = 0
    ends = {tile, 2 * tile} if tile else set()
    while c < s - max_len - 40:
        n = int(rng.integers(3, max_len + 1))
        nxt = min((e for e in ends if e > c), default=None)
        if nxt is not None and c + n > nxt:
            n = nxt - c  # end this segment on the tile boundary
        seg[0, c:c + n], pos[0, c:c + n] = g, np.arange(n)
        c, g = c + n, g + 1
    return seg, pos


# --- config, schema, parameters ----------------------------------------------

def test_nomic_preset_matches_jax():
    for f in dataclasses.fields(NOMIC_EMBED):
        assert getattr(NOMIC_EMBED, f.name) == getattr(J_NOMIC_EMBED, f.name), f.name
    assert not NOMIC_EMBED.abs_positions and NOMIC_EMBED.n_token_types == 2


def test_config_reads_nomic_kv():
    from embedding_cpp_tpu_torch.gguf import Keys

    kv = {Keys.ARCHITECTURE: "nomic-bert", Keys.TOKENIZER_LIST: ["a"] * 50,
          Keys.CONTEXT_LENGTH: 8192, Keys.EMBEDDING_LENGTH: 768, Keys.BLOCK_COUNT: 12,
          Keys.HEAD_COUNT: 12, Keys.FEED_FORWARD_LENGTH: 3072,
          Keys.ROPE_FREQ_BASE: 1000.0, Keys.ROPE_SCALING_FACTOR: 2.0,
          Keys.ROPE_MAX_TRAINED: 2048, Keys.FFN_ACT: "silu", Keys.FFN_GATED: True}
    ours = BertConfig.from_gguf_kv(kv)
    theirs = JConfig.from_gguf_kv(kv)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    # a nomic file without the bias keys is bias-free, as the JAX reader says
    assert (ours.attn_bias, ours.ffn_bias, ours.n_token_types) == (False, False, 2)


@pytest.mark.parametrize("act,gated", [("gelu", True), ("silu", False)])
def test_config_refuses_other_nomic_ffn(act, gated):
    """The nomic forward is SwiGLU: a file declaring another FFN is refused,
    not served as SwiGLU."""
    from embedding_cpp_tpu_torch.gguf import Keys

    kv = {Keys.ARCHITECTURE: "nomic-bert", Keys.TOKENIZER_LIST: ["a"] * 50,
          Keys.CONTEXT_LENGTH: 2048, Keys.EMBEDDING_LENGTH: 64, Keys.BLOCK_COUNT: 2,
          Keys.HEAD_COUNT: 4, Keys.FEED_FORWARD_LENGTH: 128,
          Keys.FFN_ACT: act, Keys.FFN_GATED: gated}
    with pytest.raises(NotImplementedError, match="nomic-bert FFN"):
        BertConfig.from_gguf_kv(kv)


def test_config_from_tiny_nomic_gguf(tmp_path):
    from embedding_cpp_tpu.cli.make_test_model import make_test_model
    from embedding_cpp_tpu.gguf.reader import GGUFReader as JReader
    from embedding_cpp_tpu_torch.gguf.reader import GGUFReader

    path = str(tmp_path / "tiny-nomic.gguf")
    make_test_model(path, "tiny-nomic", "f32", seed=0)
    with GGUFReader(path) as r:
        ours = BertConfig.from_gguf_kv(r.kv)
    with JReader(path) as r:
        theirs = JConfig.from_gguf_kv(r.kv)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert ours.arch == "nomic-bert" and ours.rope_max_trained == 128


@pytest.mark.parametrize("config", [SMALL, BIASED], ids=["bias-free", "biased"])
def test_random_state_dict_is_byte_identical(config):
    ours = random_state_dict(BertConfig(**config), seed=5)
    theirs = jax_random_state_dict(JConfig(**config), seed=5)
    assert list(ours) == list(theirs)
    assert ("encoder.layers.0.attn.Wqkv.bias" in ours) == config["attn_bias"]
    assert ("encoder.layers.1.mlp.fc2.bias" in ours) == config["ffn_bias"]
    for name in theirs:
        assert ours[name].tobytes() == theirs[name].tobytes(), name


@pytest.mark.parametrize("config,ftype", [(SMALL, "q4_0"), (SMALL, "q8_0"), (BIASED, "f32"),
                                          (BIASED, "q4_0")])
def test_params_match_jax_tree(config, ftype):
    """The Wqkv split, the Wqkv bias thirds and fc11 -> ffn_gate_w / fc12 ->
    ffn_up_w: every leaf built from the same state dict equals the JAX
    tree carried across."""
    sd = _state_dict(config)
    ours = build_params(source_from_arrays(sd, FTYPE_NAMES[ftype]), BertConfig(**config))
    theirs = from_jax_params(jax.tree_util.tree_map(np.asarray, jax_build_params(
        jax_source(sd, J_FTYPES[ftype]), JConfig(**config))))

    def walk(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for key in a:
                walk(a[key], b[key], f"{path}/{key}")
        elif isinstance(a, QTensor):
            assert a.shape == b.shape and a.qtype == b.qtype, path
            for f in ("qs", "scales"):
                assert torch.equal(getattr(a, f), getattr(b, f)), path
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    walk(ours, theirs, "")
    layers = ours["layers"]
    biases = {"q_b", "k_b", "v_b", "o_b", "ffn_up_b", "ffn_gate_b", "ffn_down_b"}
    assert biases <= set(layers) if config["attn_bias"] else not biases & set(layers)
    if ftype == "f32":  # fc12 carries the activation, fc11 is the gate
        fc11 = torch.from_numpy(sd["encoder.layers.0.mlp.fc11.weight"]).T
        assert torch.equal(layers["ffn_gate_w"][0], fc11)
        qkv_b = torch.from_numpy(sd["encoder.layers.1.attn.Wqkv.bias"])
        assert torch.equal(torch.cat([layers[k][1] for k in ("q_b", "k_b", "v_b")]), qkv_b)


@pytest.mark.parametrize("s", [64, 128, 129, 1024, 2048, 8192])
def test_inv_freq_matches_jax(s):
    """The NTK base in float64 below and past rope_max_trained (128 here,
    2048 for the preset)."""
    from embedding_cpp_tpu.models.nomic import _inv_freq as jax_inv_freq
    from embedding_cpp_tpu_torch.models.nomic import _inv_freq

    for ours, theirs in ((BertConfig(**SMALL), JConfig(**SMALL)),
                         (NOMIC_EMBED, J_NOMIC_EMBED)):
        got, ref = _inv_freq(ours, s), jax_inv_freq(theirs, s)
        assert got.dtype == np.float32 and got.tobytes() == ref.tobytes()
    scaled = _inv_freq(BertConfig(**SMALL), s)
    plain = _inv_freq(BertConfig(**SMALL), 128)
    assert np.array_equal(scaled, plain) == (s <= 128)


# --- K6: the segment kernel's plain versions against the Pallas kernels -------

@pytest.mark.parametrize("s,max_seg_len", [(1024, 128), (1152, 128), (2048, 512),
                                           (1024, None), (1152, None), (2048, None)])
def test_segment_attention_matches_pallas_every_row(s, max_seg_len):
    """flash_attention_packed against the TPU kernels (interpret mode) on
    every row, padding rows included: windowed with a bound, full without;
    segments end on the 256-row tiles and rows end in padding."""
    from embedding_cpp_tpu.ops.attention import (
        _flash_attention_packed,
        _flash_attention_packed_window,
    )

    b, h, d = 2, 2, 16
    rng = np.random.default_rng(s)
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))
    seg, _ = _segments(b, s, max_seg_len or 300, seed=s, tile=256)
    tq, wmax = packed_window_tiles(s, max_seg_len)
    assert (wmax is None) == (max_seg_len is None)
    jq, jk, jv = (jnp.asarray(t.transpose(0, 2, 1, 3)) for t in (q, k, v))
    if wmax is None:
        ref = _flash_attention_packed(jq, jk, jv, jnp.asarray(seg), tq=128, hb=1)
    else:
        ref = _flash_attention_packed_window(jq, jk, jv, jnp.asarray(seg), tq=tq, wmax=wmax,
                                             hb=1)
    ref = np.asarray(ref).transpose(0, 2, 1, 3)
    before = (flash_attention_packed.launches, flash_attention_packed.window_launches)
    got = flash_attention_packed(*_t(q, k, v, seg), max_seg_len=max_seg_len).numpy()
    assert (flash_attention_packed.launches, flash_attention_packed.window_launches) == before
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("s,max_seg_len", [(1024, 256), (2048, 512)])
def test_windowed_equals_full_on_real_rows(s, max_seg_len):
    """On a real query every visible key lies inside its tile's slice, and a
    masked key adds exp(-1e9 - m) = 0: the two forms agree on the real rows
    (exactly on the card's f32 path, tests/test_torch_cuda.py; here the
    CPU's matmuls sum keys in another blocking)."""
    rng = np.random.default_rng(s + 1)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, s, 4, 16)).astype(np.float32))
               for _ in range(3))
    seg, _ = _segments(1, s, max_seg_len, seed=s + 1, tile=256)
    seg = torch.from_numpy(seg)
    full = attention_packed_plain(q, k, v, seg)
    window = attention_packed_window_plain(q, k, v, seg, max_seg_len)
    real = seg[0] >= 0
    torch.testing.assert_close(window[0, real], full[0, real], rtol=0, atol=1e-6)


@pytest.mark.parametrize("s,d,max_seg_len", [(512, 16, 64), (1024, 16, 64), (1024, 16, 512),
                                             (1152, 32, 128), (2048, 64, 512),
                                             (2048, 64, 2048), (8192, 64, 512), (64, 16, None),
                                             (1000, 16, 32)])
def test_packed_routing_matches_jax(s, d, max_seg_len):
    """The tile, the slice width and the K2-or-K6 choice, as the reference
    routes them."""
    from embedding_cpp_tpu.ops.attention import packed_bse_applies as jax_applies

    assert packed_bse_applies(s, d, max_seg_len) == jax_applies(s, d, max_seg_len)
    tq, wmax = packed_window_tiles(s, max_seg_len)
    assert tq == (256 if s % 256 == 0 else 128)
    if max_seg_len is not None and s % 128 == 0 and s >= 1024:
        want = -(-(tq + 2 * max_seg_len + 24) // 128) * 128
        assert wmax == (want if want < s else None)
    else:
        assert wmax is None


def test_segment_kernel_refuses_unaligned_rows():
    """Named for the refusal it replaced: rows of S % 8 != 0 run padded to
    the next multiple of 8 with keys of segment -1, which every real query
    masks, so the real rows equal the plain version over the unpadded row
    (and the windowed form's, where the padded length has a slice)."""
    rng = np.random.default_rng(11)
    for s, bound in ((1100, None), (2044, 512)):
        q, k, v = (torch.from_numpy(rng.normal(size=(2, s, 2, 16)).astype(np.float32))
                   for _ in range(3))
        seg = torch.from_numpy(_segments(2, s, 300, seed=s)[0])
        got = flash_attention_packed(q, k, v, seg, bound)
        assert got.shape == q.shape
        real = seg >= 0
        ref = attention_packed_plain(q, k, v, seg)
        torch.testing.assert_close(got[real], ref[real], rtol=0, atol=1e-5)


# --- the model ---------------------------------------------------------------

def _jax_batch(jp, config, ids, mask, dtype="float32"):
    return np.asarray(jax_embed_batch(jp, jnp.asarray(ids), jnp.asarray(mask),
                                      JConfig(**config), JOpts(dtype=dtype, **JAX_OPTS)))


@pytest.mark.parametrize("s", [64, 256, 1152])
def test_embed_batch_matches_jax(models, s):
    """S = 64 and 256 on K3 (the reference takes XLA below 128), 1152 on K5
    with the NTK-scaled base."""
    _, jp, tp = models
    ids, mask = _batch(3 if s <= 256 else 2, s, seed=s)
    ref = _jax_batch(jp, SMALL, ids, mask)
    got = bert_embed_batch(tp, *_t(ids, mask), BertConfig(**SMALL)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("s", [64, 1152])
def test_biased_embed_batch_matches_jax(biased_models, s):
    """The attention and FFN biases (random, and the Wqkv bias split in
    thirds) on K3 and K5."""
    _, jp, tp = biased_models
    ids, mask = _batch(2, s, seed=s + 7)
    ref = _jax_batch(jp, BIASED, ids, mask)
    got = bert_embed_batch(tp, *_t(ids, mask), BertConfig(**BIASED)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _packed_case(s: int, max_len: int, seed: int):
    rng = np.random.default_rng(seed)
    seg, pos = _segments(2, s, max_len, seed=seed, tile=256 if s >= 1024 else 0)
    ids = rng.integers(5, SMALL["n_vocab"], (2, s)).astype(np.int32)
    ids[seg < 0] = 0
    n_seg = int(seg.max()) + 1
    slots = np.array([0, 1, n_seg - 1, n_seg + 0], np.int64)  # row 1's slot 0 is empty
    return ids, seg, pos, n_seg, slots


@pytest.mark.parametrize("s,max_len,bound,route", [
    (512, 40, None, "K2"), (1024, 100, 128, "K6b"), (2048, 300, 512, "K6b"),
    (2048, 300, None, "K6a")])
def test_embed_packed_matches_jax(models, s, max_len, bound, route):
    _, jp, tp = models
    ids, seg, pos, n_seg, slots = _packed_case(s, max_len, seed=s + max_len)
    assert packed_bse_applies(s, 16, bound) == (route == "K2")
    assert (packed_window_tiles(s, bound)[1] is not None) == (route == "K6b")
    ref = np.asarray(jax_embed_packed(jp, *map(jnp.asarray, (ids, seg, pos)),
                                      JConfig(**SMALL), JOpts(dtype="float32", **JAX_OPTS),
                                      n_seg=n_seg, gather_idx=jnp.asarray(slots, jnp.int32),
                                      max_seg_len=bound))
    got = bert_embed_packed(tp, *_t(ids, seg, pos), BertConfig(**SMALL), n_seg=n_seg,
                            gather_idx=torch.from_numpy(slots), max_seg_len=bound).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s,bound", [(1036, None), (2044, None), (2044, 512)])
def test_embed_packed_unaligned_rows_match_jax(models, s, bound):
    """Rows past 1024 with S % 8 != 0 (XLA in the reference) on K6 padded to
    a multiple of 8 after RoPE; the NTK base keys off the planned S."""
    _, jp, tp = models
    ids, seg, pos, n_seg, slots = _packed_case(s, 300, seed=s)
    ref = np.asarray(jax_embed_packed(jp, *map(jnp.asarray, (ids, seg, pos)),
                                      JConfig(**SMALL), JOpts(dtype="float32", **JAX_OPTS),
                                      n_seg=n_seg, gather_idx=jnp.asarray(slots, jnp.int32),
                                      max_seg_len=bound))
    got = bert_embed_packed(tp, *_t(ids, seg, pos), BertConfig(**SMALL), n_seg=n_seg,
                            gather_idx=torch.from_numpy(slots), max_seg_len=bound).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_biased_embed_packed_matches_jax(biased_models):
    _, jp, tp = biased_models
    ids, seg, pos, n_seg, _ = _packed_case(1024, 100, seed=3)
    ref = np.asarray(jax_embed_packed(jp, *map(jnp.asarray, (ids, seg, pos)),
                                      JConfig(**BIASED), JOpts(dtype="float32", **JAX_OPTS),
                                      n_seg=n_seg, max_seg_len=128))
    got = bert_embed_packed(tp, *_t(ids, seg, pos), BertConfig(**BIASED), n_seg=n_seg,
                            max_seg_len=128).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_packed_segments_equal_unpacked_sentences(models):
    """At S <= rope_max_trained both forwards rotate by the unscaled base,
    and per-segment positions rotate a packed sentence as it is rotated
    alone."""
    _, _, tp = models
    config = BertConfig(**SMALL)
    seg, pos = _segments(1, 128, 30, seed=4)
    ids = np.random.default_rng(4).integers(5, 300, (1, 128)).astype(np.int32)
    ids[seg < 0] = 0
    packed = bert_embed_packed(tp, *_t(ids, seg, pos), config, n_seg=16).numpy()
    for g in (0, 1, 2):
        rows = np.nonzero(seg[0] == g)[0]
        one = np.zeros((1, 64), np.int32)
        one[0, :len(rows)] = ids[0, rows]
        mask = (np.arange(64) < len(rows)).astype(np.int32)[None]
        alone = bert_embed_batch(tp, *_t(one, mask), config).numpy()
        np.testing.assert_allclose(packed[0, g], alone[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("packed", [False, True], ids=["plain-256", "packed-1024"])
def test_bf16_tracks_jax(packed):
    jp, tp = _trees(SMALL, "q4_0", jnp.bfloat16)
    opts = ComputeOptions(dtype="bfloat16")
    if packed:
        ids, seg, pos, n_seg, _ = _packed_case(1024, 100, seed=9)
        ref = np.asarray(jax_embed_packed(jp, *map(jnp.asarray, (ids, seg, pos)),
                                          JConfig(**SMALL), JOpts(dtype="bfloat16", **JAX_OPTS),
                                          n_seg=n_seg, max_seg_len=128))[0]
        got = bert_embed_packed(tp, *_t(ids, seg, pos), BertConfig(**SMALL), opts,
                                n_seg=n_seg, max_seg_len=128).numpy()[0]
    else:
        ids, mask = _batch(2, 256, seed=10)
        ref = _jax_batch(jp, SMALL, ids, mask, "bfloat16")
        got = bert_embed_batch(tp, *_t(ids, mask), BertConfig(**SMALL), opts).numpy()
    assert _cosines(got, ref).min() >= COSINE


def test_score_batch_refuses_nomic(models):
    _, _, tp = models
    ids, mask = _batch(2, 16, seed=0)
    with pytest.raises(ValueError, match="nomic-bert"):
        bert_score_batch(tp, *_t(ids, mask), BertConfig(**SMALL))


# --- the Engine --------------------------------------------------------------

PROMPTS = {"query": "search_query: ", "document": "search_document: "}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """`replace(tiny-nomic, n_ctx=2048, rope_max_trained=1024)` in a Q4_0
    GGUF with nomic's named prompts, through both engines."""
    from embedding_cpp_tpu.cli.make_test_model import PRESETS
    from embedding_cpp_tpu.models.convert import write_bert_gguf
    from embedding_cpp_tpu.runtime.engine import Engine as JEngine
    from embedding_cpp_tpu.tokenizer.testvocab import build_tokenizer_json
    from embedding_cpp_tpu_torch import Engine

    config = dataclasses.replace(PRESETS["tiny-nomic"], n_ctx=2048, rope_max_trained=1024)
    path = str(tmp_path_factory.mktemp("gguf") / "nomic-2048-q4_0.gguf")
    write_bert_gguf(path, config, jax_random_state_dict(config, seed=0),
                    build_tokenizer_json(config.n_vocab), J_FTYPES["q4_0"],
                    prompts=PROMPTS, default_prompt_name="document")

    def pair(**kw):
        # rows pad to fewer JAX row buckets: its CPU attention holds the
        # whole [B, H, S, S] score tensor (a padded row changes no result)
        return (Engine.from_gguf(path, device="cpu", **kw),
                JEngine.from_gguf(path, batch_buckets=(1, 2, 8, 64, 512, 2048), **kw))

    return pair


def _texts(n: int, lo: int, hi: int, seed: int) -> list[str]:
    from embedding_cpp_tpu_torch.tokenizer.testvocab import _COMMON_WORDS

    rng = np.random.default_rng(seed)
    words = np.array(_COMMON_WORDS)
    return [" ".join(rng.choice(words, size=int(rng.integers(lo, hi)))) for _ in range(n)]


@pytest.mark.parametrize("pack_seq,packing,lo,hi,n,bound", [
    (1024, "auto", 40, 200, 40, 256),      # rows of 1024, windowed (K6b)
    (2048, "auto", 60, 300, 34, 512),      # rows of 2048, windowed (K6b)
    (2048, "always", 600, 1400, 3, 2048),  # rows of 2048, every key (K6a)
    (512, "never", 1100, 1400, 2, None),   # plain rows of 2048 past 1024 trained (K5)
])
def test_engine_packing_matches_jax(engines, pack_seq, packing, lo, hi, n, bound):
    from embedding_cpp_tpu_torch.runtime.batching import pack_segments
    from embedding_cpp_tpu_torch.runtime.engine import segment_bound

    ours, theirs = engines(pack_seq=pack_seq, packing=packing)
    assert ours.pack_seq == theirs.pack_seq == pack_seq
    texts = _texts(n, lo, hi, seed=pack_seq + n)
    ids = ours.tokenize_batch(texts)
    assert ids == theirs.tokenize_batch(texts)
    plan = ours._pack_plan(ids)
    assert plan == theirs._pack_plan(ids) and (plan == list(range(n))) == (bound is not None)
    if plan:
        batches = pack_segments(ids, plan, ours.special_ids.pad, seq_len=ours.pack_seq,
                                n_seg=ours.pack_segs)
        assert [segment_bound(pb) for pb in batches] == [bound] * len(batches)
    got = ours.encode(texts, prompt_name="")
    ref = theirs.encode(texts, prompt_name="")
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_engine_prompts_and_dimensions_match_jax(engines):
    ours, theirs = engines()
    assert ours.prompts == PROMPTS and ours.default_prompt_name == "document"
    texts = _texts(5, 3, 20, seed=1)
    for kw in ({}, {"prompt_name": "query"}, {"prompt": "cluster: "}, {"prompt_name": ""},
               {"prompt_name": "query", "dimensions": 32}, {"dimensions": 64},
               {"dimensions": 1}):
        got, ref = ours.encode(texts, **kw), theirs.encode(texts, **kw)
        assert got.shape == ref.shape == (5, kw.get("dimensions", 64)), kw
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(ours.encode(texts), ours.encode(
        ["search_document: " + t for t in texts], prompt_name=""), rtol=0, atol=0)
    for bad in ({"prompt_name": "passage"}, {"dimensions": 0}, {"dimensions": 65},
                {"dimensions": 2.0}):
        with pytest.raises(ValueError):
            ours.encode(texts, **bad)
