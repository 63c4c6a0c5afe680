"""The port's DeBERTa-v3 path against the JAX package's, on a small config
(2 layers, 64 wide, 4 heads of 16, FFN 128, 32 position buckets out to
128), with f32 and Q4_0 weights carried across by `from_jax_params`.

- The bucket, delta and gather-index tables equal the reference's exactly
  at S = 16 ... 512, for spans above and below S (v3-base's 256 buckets
  exceed S <= 256; short spans exercise the clip at 2*span-1).
- The kernels' plain versions (K9 key bias, K10 segments) against the
  Pallas kernels in interpret mode, f32, atol 2e-6, on every row (K10's
  padding rows attend over the other padding keys, as the TPU kernel's).
- The bf16 kernel's skew arithmetic in plain torch (`_tiled_scores`: per
  64-row query tile and 64-key chunk, the [16, 80] c2p and p2c run
  products read along the kernel's diagonals) against
  `disentangled_scores_plain` and, through softmax and PV, the Pallas
  K9/K10 in interpret mode, at S = 16, 100, 512, with and without padding.
- The models against `bert_embed_batch` / `bert_embed_packed` /
  `bert_score_batch` with the reference's XLA and Pallas attention:
  f32 atol 2e-5, rtol 1e-4 (the reference's own bar); bf16 activations
  with Q4_0 weights by cosine >= 0.999.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embedding_cpp_tpu.cli.make_test_model import PRESETS as J_PRESETS
from embedding_cpp_tpu.models.bert import ComputeOptions as JOpts
from embedding_cpp_tpu.models.bert import bert_embed_batch as jax_embed_batch
from embedding_cpp_tpu.models.bert import bert_embed_packed as jax_embed_packed
from embedding_cpp_tpu.models.bert import bert_score_batch as jax_score_batch
from embedding_cpp_tpu.models.config import DEBERTA_V3_BASE as J_DEBERTA_V3_BASE
from embedding_cpp_tpu.models.config import BertConfig as JConfig
from embedding_cpp_tpu.models.convert import FTYPE_NAMES as J_FTYPES
from embedding_cpp_tpu.models.params import random_params as jax_random_params
from embedding_cpp_tpu.models.params import random_state_dict as jax_random_state_dict
from embedding_cpp_tpu_torch.models import (
    DEBERTA_V3_BASE,
    BertConfig,
    ComputeOptions,
    bert_embed_batch,
    bert_embed_packed,
    bert_score_batch,
    from_jax_params,
    random_params,
    random_state_dict,
)
from embedding_cpp_tpu_torch.ops import deberta_attention as tda
from embedding_cpp_tpu_torch.ops.qtensor import QTensor

SMALL = dict(n_vocab=300, n_ctx=512, n_embd=64, n_layer=2, n_head=4, n_ff=128,
             n_token_types=0, arch="deberta", layer_norm_eps=1e-7,
             rel_attn_buckets=32, rel_attn_max_dist=128)
RERANKER = dict(SMALL, n_labels=1, head_activation="gelu")
ATOL, RTOL = 2e-5, 1e-4
KERNEL_ATOL = 2e-6
COSINE = 0.999
SPANS = [(256, 512), (96, 192), (32, 128), (16, 64)]


def _jax_tree(config: dict, ftype: str, dtype=jnp.float32, seed: int = 1):
    return jax_random_params(JConfig(**config), J_FTYPES[ftype], seed=seed, dense_dtype=dtype)


def _bridge(tree) -> dict:
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module", params=["f32", "q4_0"])
def models(request):
    jp = _jax_tree(SMALL, request.param)
    return jp, _bridge(jp)


def _batch(b: int, s: int, seed: int):
    """Row 0 full, row 1 a third long, the rest random lengths."""
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


# --- index tables ----------------------------------------------------------------

@pytest.mark.parametrize("span,max_dist", SPANS)
@pytest.mark.parametrize("s", [16, 32, 64, 128, 256, 512])
def test_index_tables_equal_jax(s, span, max_dist):
    from embedding_cpp_tpu.models.deberta import _plain_indices
    from embedding_cpp_tpu.models.deberta import deberta_log_bucket as jax_bucket
    from embedding_cpp_tpu.ops.deberta_attention import delta_tables as jax_delta_tables

    rel = np.arange(s)[:, None] - np.arange(s)[None, :]
    np.testing.assert_array_equal(tda.deberta_log_bucket(rel, span, max_dist),
                                  jax_bucket(rel, span, max_dist, xp=np))
    c2p_idx, p2c_idx = tda.delta_tables(s, span, max_dist)
    for ours, theirs in zip((c2p_idx, p2c_idx), jax_delta_tables(s, span, max_dist)):
        np.testing.assert_array_equal(ours, theirs)
    # the delta tables read at query i, key k are the reference XLA path's
    # [S, S] gathers: c2p at [i, k] (bucket(i - k)), p2c at [k, i]
    i, k = np.arange(s)[:, None], np.arange(s)[None, :]
    config = JConfig(**dict(SMALL, rel_attn_buckets=span, rel_attn_max_dist=max_dist))
    c2p, p2c = _plain_indices(s, config)
    np.testing.assert_array_equal(c2p_idx[s - 1 - i + k], np.asarray(c2p))
    np.testing.assert_array_equal(p2c_idx[i - k + s], np.asarray(p2c).T)


def test_packed_rows_share_the_plain_tables():
    """Within a segment, bucket(pos_q - pos_k) == bucket(q - k): K10's
    absolute-offset tables score every unmasked pair of a packed row as
    the per-row tables of the reference's XLA path do."""
    _, seg, pos = _packed(128, seed=4)
    for row in range(2):
        same = seg[row][:, None] == seg[row][None, :]
        same &= seg[row][:, None] >= 0
        rel_pos = tda.deberta_log_bucket(pos[row][:, None] - pos[row][None, :], 32, 128)
        idx = np.arange(128)
        rel_abs = tda.deberta_log_bucket(idx[:, None] - idx[None, :], 32, 128)
        np.testing.assert_array_equal(rel_pos[same], rel_abs[same])


# --- kernels' plain versions -------------------------------------------------------

def _kernel_inputs(s: int, span: int, seed: int):
    rng = np.random.default_rng(seed)
    b, h, d = 3, 4, 16
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    pk, pq = (rng.standard_normal((2 * span, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v, pk, pq


@pytest.mark.parametrize("span,max_dist", [(96, 192), (16, 64)])
@pytest.mark.parametrize("s", [64, 128])
def test_k9_plain_matches_pallas(s, span, max_dist):
    from embedding_cpp_tpu.ops.deberta_attention import disentangled_attention as jax_k9

    q, k, v, pk, pq = _kernel_inputs(s, span, seed=s + span)
    mask = np.zeros((3, s), np.float32)
    mask[1, s // 3:] = -1e9
    mask[2, :] = -1e9  # every key padded
    ref = np.asarray(jax_k9(*map(jnp.asarray, (q, k, v, mask, pk, pq)), span, max_dist))
    before = tda.disentangled_attention.launches
    got = tda.disentangled_attention(*_t(q, k, v, mask, pk, pq), span, max_dist).numpy()
    assert tda.disentangled_attention.launches == before  # CPU: no kernel launch
    np.testing.assert_allclose(got, ref, rtol=0, atol=KERNEL_ATOL)


@pytest.mark.parametrize("span,max_dist", [(96, 192), (16, 64)])
@pytest.mark.parametrize("s", [64, 128])
def test_k10_plain_matches_pallas_on_every_row(s, span, max_dist):
    from embedding_cpp_tpu.ops.deberta_attention import (
        disentangled_attention_packed as jax_k10,
    )

    q, k, v, pk, pq = _kernel_inputs(s, span, seed=s * 3 + span)
    _, seg, _ = _packed(s, seed=s)
    ref = np.asarray(jax_k10(*map(jnp.asarray, (q, k, v, seg, pk, pq)), span, max_dist))
    got = tda.disentangled_attention_packed(*_t(q, k, v, seg, pk, pq), span,
                                            max_dist).numpy()
    assert (seg < 0).any()  # padding rows are compared too
    np.testing.assert_allclose(got, ref, rtol=0, atol=KERNEL_ATOL)


# --- the bf16 kernel's skewed relative products, in plain torch -------------------

TILE, GROUP, WINDOW = 64, 16, 80  # query tile = key chunk, warp group, run window


def _run_rows(table, idx, start: int, n: int, s: int) -> torch.Tensor:
    """Rows start .. start+n-1 of a relative run, [H, n, d]: row w is
    table[idx[w]], zero where w falls outside 0..2S-1 or idx[w] outside
    the table (the kernel's zero-filled copies)."""
    w = torch.arange(start, start + n)
    ok = (w >= 0) & (w < 2 * s)
    row = torch.where(ok, idx[w.clamp(0, 2 * s - 1)], -1)
    ok &= (row >= 0) & (row < table.shape[0])
    return (table[row.clamp(min=0)] * ok[:, None, None]).permute(1, 0, 2)


def _tiled_scores(q, k, pos_k, pos_q, c2p_idx, p2c_idx) -> torch.Tensor:
    """Raw f32 scores [B, H, S, S] as the bf16 kernel of
    csrc/deberta_attention.cu forms them: per (64-row query tile, 64-key
    chunk), q.k; then per 16-row group the product C = Q_group .
    PKrun[u0 .. u0+80)^T read at key j = u - (63 - r); then per 16-key
    group D^T = K_group . PQrun[v0 .. v0+80)^T read at query r = u' + j - 63;
    summed (q.k + c2p) + p2c."""
    b, s, h, d = q.shape
    n = -(-s // TILE) * TILE
    qh = torch.zeros(b, h, n, d)
    kh = torch.zeros(b, h, n, d)
    qh[:, :, :s] = q.permute(0, 2, 1, 3)
    kh[:, :, :s] = k.permute(0, 2, 1, 3)
    out = torch.zeros(b, h, n, n)
    x = torch.arange(GROUP)
    for q0 in range(0, n, TILE):
        for c0 in range(0, n, TILE):
            qt, kc = qh[:, :, q0:q0 + TILE], kh[:, :, c0:c0 + TILE]
            pk = _run_rows(pos_k, c2p_idx, s - q0 - TILE + c0, 2 * TILE, s)
            pq = _run_rows(pos_q, p2c_idx, q0 - c0 - TILE + 1 + s, 2 * TILE, s)
            tile = qt @ kc.transpose(-1, -2)
            for grp in range(TILE // GROUP):
                rows = slice(GROUP * grp, GROUP * (grp + 1))
                u0 = TILE - GROUP * (grp + 1)
                cmat = qt[:, :, rows] @ pk[:, u0:u0 + WINDOW].transpose(-1, -2)
                r, j = GROUP * grp + x[:, None], torch.arange(TILE)[None, :]
                col = (TILE - 1 - r + j) - u0
                assert 0 <= int(col.min()) and int(col.max()) < WINDOW
                tile[:, :, rows] += cmat[:, :, x[:, None], col]
            for grp in range(TILE // GROUP):
                keys = slice(GROUP * grp, GROUP * (grp + 1))
                v0 = TILE - GROUP * (grp + 1)
                dmat = kc[:, :, keys] @ pq[:, v0:v0 + WINDOW].transpose(-1, -2)
                r, j = torch.arange(TILE)[:, None], GROUP * grp + x[None, :]
                col = (r - j + TILE - 1) - v0
                assert 0 <= int(col.min()) and int(col.max()) < WINDOW
                tile[:, :, :, keys] += dmat[:, :, x[None, :], col]
            out[:, :, q0:q0 + TILE, c0:c0 + TILE] = tile
    return out[:, :, :s, :s]


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("span,max_dist", [(256, 512), (16, 64)])
@pytest.mark.parametrize("s", [16, 100, 512])
def test_tiled_skew_scores_match_plain_and_pallas(s, span, max_dist, padded):
    """The bf16 kernel's tile, group and diagonal index arithmetic, run in
    plain torch: its scores against `disentangled_scores_plain` (f32,
    atol 1e-5: the same products in other blocks), and its K9 / K10
    outputs against the Pallas kernels in interpret mode (KERNEL_ATOL),
    with and without padding, spans below and above S."""
    from embedding_cpp_tpu.ops.deberta_attention import disentangled_attention as jax_k9
    from embedding_cpp_tpu.ops.deberta_attention import (
        disentangled_attention_packed as jax_k10,
    )

    rng = np.random.default_rng(s + span + padded)
    b, h, d = 2, 2, 16
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    pk, pq = (rng.standard_normal((2 * span, h, d)).astype(np.float32) for _ in range(2))
    c2p_idx, p2c_idx = (torch.from_numpy(t) for t in tda.delta_tables(s, span, max_dist))
    tq, tk, tpk, tpq = _t(q, k, pk, pq)
    tiled = _tiled_scores(tq, tk, tpk, tpq, c2p_idx, p2c_idx)
    plain = tda.disentangled_scores_plain(tq, tk, tpk, tpq, c2p_idx, p2c_idx)
    np.testing.assert_allclose(tiled.numpy(), plain.numpy(), rtol=0, atol=1e-5)

    bias = np.zeros((b, s), np.float32)
    seg = np.repeat((np.arange(s) // 37)[None], b, 0).astype(np.int32)
    if padded:
        bias[1, max(1, s // 3):] = -1e9
        seg[1, max(1, s // 3):] = -1
    scale = 1.0 / np.sqrt(3 * d)
    vh = torch.from_numpy(v).permute(0, 2, 1, 3)
    got9 = tda._softmax_pv(tiled * scale + torch.from_numpy(bias)[:, None, None, :], vh,
                           torch.float32).permute(0, 2, 1, 3).numpy()
    ref9 = np.asarray(jax_k9(*map(jnp.asarray, (q, k, v, bias, pk, pq)), span, max_dist))
    np.testing.assert_allclose(got9, ref9, rtol=0, atol=KERNEL_ATOL)
    ts = torch.from_numpy(seg)
    allowed = (ts[:, :, None] == ts[:, None, :])[:, None]
    got10 = tda._softmax_pv(torch.where(allowed, tiled * scale, torch.tensor(-1e9)), vh,
                            torch.float32).permute(0, 2, 1, 3).numpy()
    ref10 = np.asarray(jax_k10(*map(jnp.asarray, (q, k, v, seg, pk, pq)), span, max_dist))
    np.testing.assert_allclose(got10, ref10, rtol=0, atol=KERNEL_ATOL)


def test_cpu_wrapper_rejects_other_devices():
    q = torch.zeros(1, 16, 2, 16, device="meta")
    with pytest.raises(ValueError):
        tda.disentangled_attention(q, q, q, torch.zeros(1, 16, device="meta"),
                                   torch.zeros(64, 2, 16, device="meta"),
                                   torch.zeros(64, 2, 16, device="meta"), 32, 128)


# --- models ----------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("s", [16, 64, 128])
def test_embed_batch_matches_jax(models, s, impl):
    jp, tp = models
    ids, mask = _batch(3, s, seed=s)
    ref = np.asarray(jax_embed_batch(jp, jnp.asarray(ids), jnp.asarray(mask),
                                     JConfig(**SMALL), JOpts(dtype="float32", attn_impl=impl)))
    got = bert_embed_batch(tp, *_t(ids, mask), BertConfig(**SMALL)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("s", [64, 128])
def test_embed_packed_matches_jax(models, s, impl):
    jp, tp = models
    ids, seg, pos = _packed(s, seed=s + 1)
    n_seg = 16
    slots = np.array([0, 1, 2, n_seg, n_seg + 1], np.int64)
    ref = np.asarray(jax_embed_packed(jp, *map(jnp.asarray, (ids, seg, pos)),
                                      JConfig(**SMALL), JOpts(dtype="float32", attn_impl=impl),
                                      n_seg=n_seg, gather_idx=jnp.asarray(slots, jnp.int32)))
    got = bert_embed_packed(tp, *_t(ids, seg, pos), BertConfig(**SMALL), n_seg=n_seg,
                            gather_idx=torch.from_numpy(slots)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_packed_segments_equal_unpacked_sentences(models):
    """A packed sentence embeds as it does alone (relative positions are
    per segment, other segments are masked)."""
    _, tp = models
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


@pytest.mark.parametrize("packed", [False, True])
def test_bf16_q4_tracks_jax(packed):
    jp = _jax_tree(SMALL, "q4_0", jnp.bfloat16)
    tp = _bridge(jp)
    jo, to = JOpts(dtype="bfloat16", attn_impl="pallas"), ComputeOptions(dtype="bfloat16")
    if packed:
        ids, seg, pos = _packed(128, seed=9)
        ref = np.asarray(jax_embed_packed(jp, *map(jnp.asarray, (ids, seg, pos)),
                                          JConfig(**SMALL), jo, n_seg=16))[:2]
        got = bert_embed_packed(tp, *_t(ids, seg, pos), BertConfig(**SMALL), to,
                                n_seg=16).numpy()[:2]
        real = np.linalg.norm(ref, axis=-1) > 0
        got, ref = got[real], ref[real]
    else:
        ids, mask = _batch(3, 128, seed=8)
        ref = np.asarray(jax_embed_batch(jp, jnp.asarray(ids), jnp.asarray(mask),
                                         JConfig(**SMALL), jo))
        got = bert_embed_batch(tp, *_t(ids, mask), BertConfig(**SMALL), to).numpy()
    assert _cosines(got, ref).min() >= COSINE


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("ftype", ["f32", "q4_0"])
def test_score_batch_matches_jax(ftype, impl):
    """The tiny-deberta-reranker geometry: the ContextPooler (dense + gelu
    on the CLS state) and the one-logit classifier."""
    preset = J_PRESETS["tiny-deberta-reranker"]
    config = {f.name: getattr(preset, f.name) for f in dataclasses.fields(BertConfig)}
    jp = _jax_tree(config, ftype, seed=2)
    ids, mask = _batch(4, 64, seed=5)
    ref = np.asarray(jax_score_batch(jp, jnp.asarray(ids), jnp.asarray(mask),
                                     JConfig(**config), JOpts(dtype="float32", attn_impl=impl)))
    got = bert_score_batch(_bridge(jp), *_t(ids, mask), BertConfig(**config)).numpy()
    assert got.shape == ref.shape == (4, 1)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("activation", ["tanh", "relu", "gelu"])
def test_bert_score_batch_matches_jax(activation):
    """The BERT family's generic cross-encoder path: segment type ids pick
    the token-type rows, and the pooler activation."""
    config = dict(n_vocab=300, n_ctx=128, n_embd=64, n_layer=2, n_head=4, n_ff=128,
                  n_labels=2, head_activation=activation)
    jp = _jax_tree(config, "q4_0", seed=3)
    ids, mask = _batch(3, 32, seed=6)
    types = (np.arange(32)[None, :] >= 10).astype(np.int32) * mask
    ref = np.asarray(jax_score_batch(jp, jnp.asarray(ids), jnp.asarray(mask), JConfig(**config),
                                     JOpts(dtype="float32"), type_ids=jnp.asarray(types)))
    got = bert_score_batch(_bridge(jp), *_t(ids, mask), BertConfig(**config),
                           type_ids=torch.from_numpy(types)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_embedding_model_has_no_score_head(models):
    _, tp = models
    ids, mask = _batch(2, 16, seed=1)
    with pytest.raises(ValueError):
        bert_score_batch(tp, *_t(ids, mask), BertConfig(**SMALL))


# --- parameters and configuration --------------------------------------------------

@pytest.mark.parametrize("config", [SMALL, RERANKER], ids=["embedder", "reranker"])
def test_random_state_dict_is_byte_identical(config):
    ours = random_state_dict(BertConfig(**config), seed=5)
    theirs = jax_random_state_dict(JConfig(**config), seed=5)
    assert list(ours) == list(theirs)
    assert "encoder.rel_embeddings.weight" in ours
    assert ("classifier.weight" in ours) == bool(config.get("n_labels"))
    for name in theirs:
        assert ours[name].dtype == theirs[name].dtype
        assert ours[name].tobytes() == theirs[name].tobytes(), name


@pytest.mark.parametrize("ftype", ["f32", "q4_0", "q8_0"])
def test_random_params_match_jax_tree(ftype):
    ours = random_params(BertConfig(**RERANKER), ftype, seed=1)
    theirs = _bridge(_jax_tree(RERANKER, ftype))

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
    assert ours["rel_emb"].shape == (64, 64) and ours["rel_emb"].dtype == torch.float32
    assert set(ours["head"]) == {"dense_w", "dense_b", "out_w", "out_b"}
    assert ours["head"]["out_w"].shape == (64, 1)


def test_deberta_v3_base_preset_matches_jax():
    for f in dataclasses.fields(DEBERTA_V3_BASE):
        assert getattr(DEBERTA_V3_BASE, f.name) == getattr(J_DEBERTA_V3_BASE, f.name), f.name


def test_config_reads_deberta_kv():
    from embedding_cpp_tpu_torch.gguf import Keys

    kv = {Keys.ARCHITECTURE: "deberta", Keys.TOKENIZER_LIST: ["a"] * 50,
          Keys.CONTEXT_LENGTH: 512, Keys.EMBEDDING_LENGTH: 768, Keys.BLOCK_COUNT: 12,
          Keys.HEAD_COUNT: 12, Keys.FEED_FORWARD_LENGTH: 3072,
          Keys.REL_ATTN_MAX_DIST: 512, Keys.N_LABELS: 1}
    c = BertConfig.from_gguf_kv(kv)
    assert (c.arch, c.n_token_types, c.layer_norm_eps) == ("deberta", 0, 1e-7)
    assert (c.rel_attn_buckets, c.rel_attn_max_dist) == (256, 512)
    assert (c.n_labels, c.head_activation) == (1, "gelu")
    with pytest.raises(ValueError):
        BertConfig(**dict(RERANKER, head_activation="swish"))
