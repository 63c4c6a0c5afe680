"""The port's ModernBERT path against the JAX package's, on a small config
(4 layers: global, local, local, global; 64 wide, 4 heads of 16, GeGLU FFN
128, window 16, n_ctx 2048), with f32 and Q4_0 weights carried across by
`from_jax_params`.

Under the tier-1 run JAX sees 8 CPU devices, so its ModernBERT model takes
its XLA einsum attention (modernbert.py only takes Pallas on one device);
the port's model runs its kernels' plain versions.  S = 16, 128 and 256
reach the port's projection-layout kernels (K2/K3/K4), S = 2048 the long-row
and sliding-window kernels (K5/K7), S = 1100 (no window slice) K5 with the
window bias.  Tolerances: f32 atol 2e-5, rtol 1e-4 (the JAX package's own
bar in tests/test_modernbert.py); bf16 min cosine 0.999.
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
from embedding_cpp_tpu.models.config import MODERNBERT_BASE as J_MODERNBERT_BASE
from embedding_cpp_tpu.models.config import BertConfig as JConfig
from embedding_cpp_tpu.models.convert import FTYPE_NAMES as J_FTYPES
from embedding_cpp_tpu.models.params import random_params as jax_random_params
from embedding_cpp_tpu.models.params import random_state_dict as jax_random_state_dict
from embedding_cpp_tpu_torch.models import (
    MODERNBERT_BASE,
    BertConfig,
    ComputeOptions,
    bert_embed_batch,
    bert_embed_packed,
    from_jax_params,
    random_params,
    random_state_dict,
)
from embedding_cpp_tpu_torch.models.modernbert import _Ctx, layer_kinds
from embedding_cpp_tpu_torch.ops.qtensor import QTensor

SMALL = dict(n_vocab=300, n_ctx=2048, n_embd=64, n_layer=4, n_head=4, n_ff=128,
             n_token_types=0, arch="modernbert", layer_norm_eps=1e-5,
             rope_theta=160000.0, local_rope_theta=10000.0, global_attn_every=3,
             local_window=16, pooling="mean")
ATOL, RTOL = 2e-5, 1e-4
COSINE = 0.999


def _jax_tree(config: dict, ftype: str, dtype=jnp.float32):
    return jax_random_params(JConfig(**config), J_FTYPES[ftype], seed=1, dense_dtype=dtype)


@pytest.fixture(scope="module", params=["f32", "q4_0"])
def models(request):
    jp = _jax_tree(SMALL, request.param)
    return request.param, jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp))


def _batch(b: int, s: int, seed: int):
    """Row 0 full, row 1 a third long, the rest of the rows random lengths."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, SMALL["n_vocab"], (b, s)).astype(np.int32)
    lens = [s, max(1, s // 3)] + [int(n) for n in rng.integers(1, s + 1, b - 2)]
    mask = (np.arange(s)[None, :] < np.array(lens)[:, None]).astype(np.int32)
    ids[mask == 0] = 0
    return ids, mask


def _packed(s: int, seed: int):
    """Two rows of assorted segments with a -1 tail, and one padding row."""
    rng = np.random.default_rng(seed)
    seg = np.full((3, s), -1, np.int32)
    pos = np.zeros((3, s), np.int32)
    for i in range(2):
        c = g = 0
        while c < s - 40:
            n = int(rng.integers(3, 40))
            seg[i, c:c + n], pos[i, c:c + n] = g, np.arange(n)
            c, g = c + n, g + 1
    ids = rng.integers(5, SMALL["n_vocab"], (3, s)).astype(np.int32)
    ids[seg < 0] = 0
    return ids, seg, pos


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, -1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


@pytest.mark.parametrize("s", [16, 128, 256, 1100, 2048])
def test_embed_batch_matches_jax(models, s):
    _, jp, tp = models
    ids, mask = _batch(3 if s <= 256 else 2, s, seed=s)
    ref = np.asarray(jax_embed_batch(jp, jnp.asarray(ids), jnp.asarray(mask),
                                     JConfig(**SMALL), JOpts(dtype="float32")))
    got = bert_embed_batch(tp, *_t(ids, mask), BertConfig(**SMALL)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("s", [128, 256])
def test_embed_packed_matches_jax(models, s):
    _, jp, tp = models
    ids, seg, pos = _packed(s, seed=s)
    n_seg = 16
    slots = np.array([0, 3, 5, n_seg, n_seg + 2], np.int64)
    ref = np.asarray(jax_embed_packed(jp, *map(jnp.asarray, (ids, seg, pos)),
                                      JConfig(**SMALL), JOpts(dtype="float32"),
                                      n_seg=n_seg, gather_idx=jnp.asarray(slots, jnp.int32)))
    got = bert_embed_packed(tp, *_t(ids, seg, pos), BertConfig(**SMALL), n_seg=n_seg,
                            gather_idx=torch.from_numpy(slots)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_packed_segments_equal_unpacked_sentences(models):
    """Per-segment positions rotate and window a packed sentence exactly as
    it is rotated and windowed alone."""
    _, _, tp = models
    config = BertConfig(**SMALL)
    ids, seg, pos = _packed(128, seed=3)
    packed = bert_embed_packed(tp, *_t(ids, seg, pos), config, n_seg=16).numpy()
    for g in (0, 1, 2):
        rows = np.nonzero(seg[0] == g)[0]
        one = np.zeros((1, 64), np.int32)
        one[0, :len(rows)] = ids[0, rows]
        mask = (np.arange(64) < len(rows)).astype(np.int32)[None]
        alone = bert_embed_batch(tp, *_t(one, mask), config).numpy()
        np.testing.assert_allclose(packed[0, g], alone[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s", [128, 2048])
def test_bf16_tracks_jax(s):
    config = dict(SMALL, pooling="cls")
    jp = _jax_tree(config, "q4_0", jnp.bfloat16)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    ids, mask = _batch(2, s, seed=s + 1)
    jo = JOpts(dtype="bfloat16")
    ref = np.asarray(jax_embed_batch(jp, jnp.asarray(ids), jnp.asarray(mask),
                                     JConfig(**config), jo))
    got = bert_embed_batch(tp, *_t(ids, mask), BertConfig(**config),
                           ComputeOptions(dtype="bfloat16")).numpy()
    assert _cosines(got, ref).min() >= COSINE
    if s <= 256:
        pids, seg, pos = _packed(s, seed=s)
        ref = np.asarray(jax_embed_packed(jp, *map(jnp.asarray, (pids, seg, pos)),
                                          JConfig(**config), jo, n_seg=16))[:2]
        got = bert_embed_packed(tp, *_t(pids, seg, pos), BertConfig(**config),
                                ComputeOptions(dtype="bfloat16"), n_seg=16).numpy()[:2]
        real = np.linalg.norm(ref, axis=-1) > 0
        assert _cosines(got[real], ref[real]).min() >= COSINE


@pytest.mark.parametrize("ftype", ["f32", "q4_0", "q8_0"])
def test_random_params_match_jax_tree(ftype):
    """The fused Wqkv/Wi split (exact under Q4/Q8: ggml blocks run along the
    contraction axis), layer 0's ones row and the final norm: every leaf of
    random_params equals the JAX tree carried across."""
    ours = random_params(BertConfig(**SMALL), ftype, seed=1)
    theirs = from_jax_params(jax.tree_util.tree_map(np.asarray, _jax_tree(SMALL, ftype)))

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
    assert set(ours["layers"]) == {"q_w", "k_w", "v_w", "o_w", "ffn_up_w", "ffn_gate_w",
                                   "ffn_down_w", "ln_att_scale", "ln_out_scale"}
    assert torch.equal(ours["layers"]["ln_att_scale"][0], torch.ones(64))


def test_random_state_dict_is_byte_identical():
    ours = random_state_dict(BertConfig(**SMALL), seed=5)
    theirs = jax_random_state_dict(JConfig(**SMALL), seed=5)
    assert list(ours) == list(theirs)
    assert "layers.0.attn_norm.weight" not in ours and "final_norm.weight" in ours
    for name in theirs:
        assert ours[name].dtype == theirs[name].dtype
        assert ours[name].tobytes() == theirs[name].tobytes(), name


def test_layer_kinds_and_rope_match_jax():
    from embedding_cpp_tpu.models.modernbert import _layer_aux, _rope_cos_sin
    from embedding_cpp_tpu_torch.models.modernbert import rope_cos_sin

    config = BertConfig(**SMALL)
    is_local, inv_freq = layer_kinds(config)
    aux = _layer_aux(JConfig(**SMALL))
    assert is_local == np.asarray(aux["is_local"]).tolist() == [False, True, True, False]
    np.testing.assert_array_equal(inv_freq, np.asarray(aux["inv_freq"]))
    pos = np.arange(2048, dtype=np.int32)
    for i in (0, 1):
        jc, js = _rope_cos_sin(jnp.asarray(pos), aux["inv_freq"][i], jnp.float32)
        tc, ts = rope_cos_sin(torch.from_numpy(pos), torch.from_numpy(inv_freq[i]),
                              torch.float32)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-6)


@pytest.mark.parametrize("s,long,sliced", [(512, False, False), (1024, False, False),
                                           (1100, True, False), (2048, True, True)])
def test_attention_dispatch_by_length(s, long, sliced):
    """S <= 1024: projection-layout kernels with the window bias; past it
    the long-row kernel, sliding-window slices wherever S has them."""
    ctx = _Ctx(BertConfig(**SMALL), torch.arange(s), torch.float32, s, "cpu",
               pad=torch.zeros(1, s))
    assert (ctx.long, ctx.sliced) == (long, sliced)
    assert (ctx.win is None) == sliced


def test_modernbert_base_preset_matches_jax():
    for f in dataclasses.fields(MODERNBERT_BASE):
        assert getattr(MODERNBERT_BASE, f.name) == getattr(J_MODERNBERT_BASE, f.name), f.name


def test_config_reads_modernbert_kv():
    from embedding_cpp_tpu_torch.gguf import Keys

    kv = {Keys.ARCHITECTURE: "modernbert", Keys.TOKENIZER_LIST: ["a"] * 50,
          Keys.CONTEXT_LENGTH: 8192, Keys.EMBEDDING_LENGTH: 768, Keys.BLOCK_COUNT: 22,
          Keys.HEAD_COUNT: 12, Keys.FEED_FORWARD_LENGTH: 1152,
          Keys.ROPE_FREQ_BASE: 160000.0, Keys.ROPE_FREQ_BASE_LOCAL: 10000.0,
          Keys.GLOBAL_ATTN_EVERY: 3, Keys.LOCAL_ATTN_WINDOW: 128}
    c = BertConfig.from_gguf_kv(kv)
    assert (c.arch, c.n_token_types, c.layer_norm_eps) == ("modernbert", 0, 1e-5)
    assert (c.rope_theta, c.local_rope_theta, c.global_attn_every, c.local_window) == (
        160000.0, 10000.0, 3, 128)
