"""The bf16 body of the projection-layout attention K2/K3/K4
(`tc::attn_bse_tc_kernel`, csrc/attention_bse.cu) walked in plain torch on
the CPU, against the port's plain version and the JAX package's TPU kernel.

The CUDA kernel cannot run here, so this file repeats its walk: blocks of
TILE_Q query rows (16 per warp) over TILE_K-key tiles, both read from the
source; at S <= SHORT_S one block takes several batch rows (`group_rows`,
also read from the source).  Pass 1 folds each kept tile's scaled,
masked scores into the row max, skipping (segments) the key tiles whose id
span misses the query tile's and, within a kept tile, each warp's 8-key
runs whose span misses its 16 rows' (`bse_skips`), and then takes m =
max(m, -1e9) for what it skipped.  Pass 2 skips the same only when every
query row of the block has m > -1e9 + 128; otherwise it scores every key.
It computes e = exp(s - m) in f32, the f32 row sum before e is cast, e
rounded to v's dtype for the PV product with f32 accumulation, and the
divide last.  Keys past S enter neither the max nor the sum.

Checked: the walk against `attention_bse_plain` (f32 1e-5 absolute: the
same products summed in another order; bf16 relative 1e-2, one rounding)
and against the JAX entries in Pallas interpret mode (f32 2e-5, the bar of
tests/test_torch_attention.py), at h = 2, d in {16, 32, 64}, S in {16, 32,
100, 512}: segments contiguous with a -1 tail and a row all padding,
shuffled non-contiguous ids, a position bias with a row of -1e9 (PH = 1
and H); key bias with padded tails and a row all padded, with and without
a position bias (PH = 1 and H).  The skips: they engage on the serving
profile of packed rows, and no skipped tile or run ever holds a visible
(query, key) pair, on shuffled ids too.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embedding_cpp_tpu.ops.attention import flash_attention_bias_bse as jax_bias_bse
from embedding_cpp_tpu.ops.attention import flash_attention_bias_packed_bse as jax_bias_packed
from embedding_cpp_tpu.ops.attention import flash_attention_bse as jax_bse
from embedding_cpp_tpu.ops.attention import flash_attention_packed_bse as jax_packed_bse
from embedding_cpp_tpu_torch.benchmarks.profiles import serving_segments
from embedding_cpp_tpu_torch.ops.attention import (
    BSE_RUN,
    BSE_TILE_K,
    BSE_TILE_Q,
    BSE_WARP_ROWS,
    MASK_BIAS,
    attention_bse_plain,
    bse_skips,
)

F32_ATOL = 1e-5
JAX_F32_ATOL = 2e-5
BF16_REL = 1e-2
_SRC = Path(__file__).resolve().parents[1] / "embedding_cpp_tpu_torch" / "csrc" / "attention_bse.cu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The walk is thousands of small tensor ops: one intra-op thread runs
    it as fast as many on an idle host, and keeps it from stalling on a
    busy one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC.read_text())[1])


TILE_Q, TILE_K, SHORT_S = _constant("TILE_Q"), _constant("TILE_K"), _constant("SHORT_S")
NW = _constant("NW")  # warps a block: one per WARP_ROWS query rows
WARP_ROWS = TILE_Q // NW
RUN = BSE_RUN  # keys a warp skips at once: the n of its m16n8k16 products


def group_rows(s: int) -> int:
    """The source's `group_rows`, R: at S <= SHORT_S a block takes TILE_Q /
    R batch rows of R rows (16 at S <= 16, else 32); 0 above."""
    body = re.search(r"constexpr int group_rows\(int S\) \{\s*return (.*?);", _SRC.read_text(),
                     re.S)[1]
    assert body.split() == "S <= 16 ? 16 : S <= SHORT_S ? 32 : 0".split(), body
    return 16 if s <= 16 else 32 if s <= SHORT_S else 0


def _scores(qr, kr, scale, mask, pb, seg_mask, qpos, kpos):
    """The kernel's masked scores [rows, keys]: s*scale, then the key bias
    and the position bias (each add rounded), or seg[q] == seg[k] ? s*scale
    (+ pos bias) : -1e9."""
    s = (qr @ kr.T) * scale
    bias = None if pb is None else pb[qpos][:, kpos]
    if seg_mask:
        sc = s if bias is None else s + bias
        return torch.where(mask[qpos][:, None] == mask[kpos][None, :], sc,
                           torch.tensor(MASK_BIAS, dtype=torch.float32))
    x = s + mask[kpos][None, :]
    return x if bias is None else x + bias


def _block(q, k, v, mask, pb, seg_mask, scale, qpos, tiles, runs, skipped_tile, stats):
    """One block of TILE_Q query rows at positions qpos (-1: no row) over
    key tiles `tiles` (lists of key positions, -1: past S); runs(ti, sharp)
    gives the [TILE_Q, TILE_K] keys each row's warp scores in tile ti.
    Returns (rows, out) for the rows below S."""
    valid = qpos >= 0
    rows = qpos[valid]
    qr = q[rows].float()
    n = len(rows)
    m = torch.full((n,), float("-inf"))
    skipped = torch.zeros(n, dtype=torch.bool)
    for ti, kp in enumerate(tiles):  # pass 1: the row max
        act = runs(ti, True)[valid] & (kp >= 0)[None, :]
        skipped |= (~act & (kp >= 0)[None, :]).any(1)
        keys = kp.clamp(min=0)
        x = _scores(qr, k[keys].float(), scale, mask, pb, seg_mask, rows, keys)
        m = torch.maximum(m, torch.where(act, x, float("-inf")).amax(1))
    m = torch.where(skipped | skipped_tile, torch.maximum(m, torch.tensor(MASK_BIAS)), m)
    sharp = bool((m > MASK_BIAS + 128.0).all())
    stats["not_sharp"] += not sharp
    se = torch.zeros(n)
    acc = torch.zeros(n, v.shape[-1])
    for ti, kp in enumerate(tiles if sharp else stats["all_tiles"]):  # pass 2
        act = (runs(ti, sharp) if sharp else torch.ones(TILE_Q, TILE_K, dtype=torch.bool))[valid]
        act &= (kp >= 0)[None, :]
        keys = kp.clamp(min=0)
        x = _scores(qr, k[keys].float(), scale, mask, pb, seg_mask, rows, keys)
        e = torch.where(act, torch.exp(x - m[:, None]), 0.0)
        se += e.sum(1)
        acc += e.to(v.dtype).float() @ torch.where((kp >= 0)[:, None], v[keys].float(), 0.0)
        stats["scored"] += int(act.sum())
    return rows, acc / se[:, None]


def kernel_walk(q, k, v, mask, h, seg_mask, pos_bias=None, stats=None):
    """The bf16 body's walk over q/k/v [B, S, H*d] -> [B, S, H*d]."""
    b, s, e = q.shape
    d = e // h
    scale = 1.0 / (d**0.5)
    stats = {} if stats is None else stats
    stats.update(not_sharp=0, scored=0, tiles=0, kept_tiles=0)
    r = group_rows(s)
    out = torch.zeros(b, s, e, dtype=q.dtype)
    fine = seg_mask and not r
    if fine:
        kept, scored = bse_skips(mask)
    n_tiles = 1 if r else -(-s // TILE_K)
    pos = torch.arange(n_tiles * TILE_K)
    all_tiles = [torch.where(p < s, p, -1) for p in pos.reshape(n_tiles, TILE_K)]
    stats["all_tiles"] = all_tiles
    for hh in range(h):
        cols = slice(hh * d, (hh + 1) * d)
        pb = None if pos_bias is None else pos_bias[hh % pos_bias.shape[0]].float()
        for bi in range(b):
            qh, kh, vh = (t[bi, :, cols] for t in (q, k, v))
            row_mask = mask[bi] if seg_mask else mask[bi].float()
            if r:  # short rows: this batch row's warps score its S keys of one tile
                qpos = torch.arange(TILE_Q)
                qpos = torch.where(qpos < s, qpos, -1)
                kp = torch.where(torch.arange(TILE_K) < s, torch.arange(TILE_K), -1)
                rows, o = _block(qh, kh, vh, row_mask, pb, seg_mask,
                                 scale, qpos, [kp],
                                 lambda ti, sharp: torch.ones(TILE_Q, TILE_K, dtype=torch.bool),
                                 torch.tensor(False), stats)
                out[bi, rows, cols] = o.to(q.dtype)
                continue
            for qt in range(n_tiles):
                qpos = qt * TILE_Q + torch.arange(TILE_Q)
                qpos = torch.where(qpos < s, qpos, -1)
                if fine:
                    tis = [int(t) for t in torch.nonzero(kept[bi, qt]).flatten()]
                else:
                    tis = list(range(n_tiles))
                stats["tiles"] += n_tiles
                stats["kept_tiles"] += len(tis)

                def runs(i, skip, tis=tis, qt=qt, bi=bi):
                    if not (fine and skip):
                        return torch.ones(TILE_Q, TILE_K, dtype=torch.bool)
                    w = scored[bi, qt * NW:(qt + 1) * NW, tis[i] * 8:(tis[i] + 1) * 8]
                    return w.repeat_interleave(WARP_ROWS, 0).repeat_interleave(RUN, 1)
                rows, o = _block(qh, kh, vh, row_mask, pb, seg_mask, scale, qpos,
                                 [all_tiles[t] for t in tis], runs,
                                 torch.tensor(len(tis) < n_tiles), stats)
                out[bi, rows, cols] = o.to(q.dtype)
    return out


# --- inputs ----------------------------------------------------------------------

H = 2
B = 3


def _qkv(s: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, s, H * d)).astype(np.float32) for _ in range(3)]


def _contiguous(s: int, seed: int) -> np.ndarray:
    """Row 0: segments of 1-40 tokens with a -1 tail; row 1: segments of
    the serving profile filling the row; row 2: all padding."""
    rng = np.random.default_rng(seed)
    seg = np.full((B, s), -1, np.int32)
    for row, hi in ((0, 40), (1, 25)):
        c = g = 0
        while c < s - (3 if row == 0 else 0):
            n = int(rng.integers(1, hi))
            seg[row, c:min(s, c + n)] = g
            c, g = c + n, g + 1
    return seg


def _shuffled(s: int, seed: int) -> np.ndarray:
    """Ids in -1..5 in no order (non-contiguous segments, padding among
    them); row 2 all padding."""
    seg = np.random.default_rng(seed).integers(-1, 6, size=(B, s)).astype(np.int32)
    seg[2] = -1
    return seg


def _key_bias(s: int) -> np.ndarray:
    mask = np.zeros((B, s), np.float32)
    mask[1, max(1, s // 3):] = MASK_BIAS
    mask[2, :] = MASK_BIAS  # every key padded
    return mask


def _pos_bias(ph: int, s: int, seed: int, minus_row: bool) -> np.ndarray:
    pb = np.random.default_rng(seed).standard_normal((ph, s, s)).astype(np.float32)
    if minus_row:
        pb[:, s // 2, :] = MASK_BIAS  # every pair of one query row at -1e9
    return pb


def _check(q, k, v, mask, seg_mask, pb, jax_fn):
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    tpb = None if pb is None else torch.from_numpy(pb)
    stats = {}
    walk = kernel_walk(tq, tk, tv, tm, H, seg_mask, tpb, stats)
    plain = attention_bse_plain(tq, tk, tv, tm, H, seg_mask, tpb)
    assert torch.isfinite(walk).all()
    np.testing.assert_allclose(walk.numpy(), plain.numpy(), rtol=0, atol=F32_ATOL)
    args = (q, k, v, mask) if pb is None else (q, k, v, mask, pb)
    ref = np.asarray(jax_fn(*map(jnp.asarray, args), H))
    np.testing.assert_allclose(walk.numpy(), ref, rtol=0, atol=JAX_F32_ATOL)
    bq, bk, bv = (t.to(torch.bfloat16) for t in (tq, tk, tv))
    got = kernel_walk(bq, bk, bv, tm, H, seg_mask, tpb).float()
    ref = attention_bse_plain(bq, bk, bv, tm, H, seg_mask, tpb).float()
    assert (got - ref).abs().max() <= BF16_REL * ref.abs().max()
    return stats


# --- the walk against the plain version and the TPU kernel ------------------------

@pytest.mark.parametrize("kind", ["contiguous", "shuffled", "pbias_1", "pbias_h"])
@pytest.mark.parametrize("s", [16, 32, 100, 512])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_segment_walk_matches_plain_and_pallas(d, s, kind):
    seed = d * 1000 + s
    q, k, v = _qkv(s, d, seed)
    seg = _shuffled(s, seed) if kind == "shuffled" else _contiguous(s, seed)
    pb = None
    if kind.startswith("pbias"):
        pb = _pos_bias(1 if kind == "pbias_1" else H, s, seed + 1, minus_row=True)
    stats = _check(q, k, v, seg, True, pb, jax_packed_bse if pb is None else jax_bias_packed)
    if pb is not None and s > SHORT_S:
        # the -1e9 row leaves its block no exact skip: pass 2 scores every key
        assert stats["not_sharp"] >= H


@pytest.mark.parametrize("ph", [None, 1, H])
@pytest.mark.parametrize("s", [16, 32, 100, 512])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_key_bias_walk_matches_plain_and_pallas(d, s, ph):
    seed = d * 1000 + s + 7
    q, k, v = _qkv(s, d, seed)
    pb = None if ph is None else _pos_bias(ph, s, seed + 1, minus_row=False)
    stats = _check(q, k, v, _key_bias(s), False, pb, jax_bse if pb is None else jax_bias_bse)
    assert stats["kept_tiles"] == stats["tiles"]  # the key-bias forms skip no tile


# --- the tiling and the skips -----------------------------------------------------

def test_tile_constants_match_the_source():
    assert (BSE_TILE_Q, BSE_TILE_K, BSE_WARP_ROWS) == (TILE_Q, TILE_K, WARP_ROWS)
    assert TILE_Q == TILE_K and WARP_ROWS == 16 and TILE_K % RUN == 0


@pytest.mark.parametrize("s", [1, 8, 16, 17, 24, 31, 32, 33, 64, 100, 512, 1024])
def test_short_rows_rule(s):
    """Every warp of a short-S block serves rows of one batch row, and a
    block holds whole batch rows."""
    r = group_rows(s)
    if r:
        assert s <= r and r % WARP_ROWS == 0 and TILE_Q % r == 0
    else:
        assert s > SHORT_S


def _visible_blocks(seg: np.ndarray) -> np.ndarray:
    """[B, nq * 4, nk * 8]: a warp's 16 rows and 8 keys hold a visible pair."""
    b, s = seg.shape
    n = -(-s // TILE_K) * TILE_K
    ids = np.full((b, n), np.iinfo(np.int32).min, np.int64)
    ids[:, :s] = seg
    vis = ids[:, :, None] == ids[:, None, :]
    vis[:, s:, :] = vis[:, :, s:] = False
    return vis.reshape(b, n // WARP_ROWS, WARP_ROWS, n // RUN, RUN).any(axis=(2, 4))


def test_skips_engage_on_the_serving_profile():
    seg = serving_segments(np.random.default_rng(0), 32, 512)[0]
    kept, scored = bse_skips(torch.from_numpy(seg))
    assert (~kept).sum() > 0.5 * kept.numel()  # most key tiles are never loaded
    assert scored.sum() < 0.2 * scored.numel()
    assert not (_visible_blocks(seg) & ~scored.numpy()).any()


@pytest.mark.parametrize("s", [64, 100, 512, 1024])
@pytest.mark.parametrize("kind", ["shuffled", "contiguous", "few_ids", "negative_ids"])
def test_skips_never_drop_a_visible_pair(kind, s):
    rng = np.random.default_rng(s)
    if kind == "shuffled":
        seg = rng.integers(-1, 40, size=(4, s)).astype(np.int32)
    elif kind == "contiguous":
        seg = serving_segments(rng, 4, s)[0]
    elif kind == "few_ids":  # two ids alternating in long runs, padding among them
        seg = (np.arange(s)[None] // 37 % 2 * np.ones((4, 1))).astype(np.int32)
        seg[:, rng.integers(0, s, size=s // 10)] = -1
    else:  # ids below -1 are ids like any other, not padding
        seg = rng.integers(-5, 3, size=(4, s)).astype(np.int32)
    kept, scored = bse_skips(torch.from_numpy(seg))
    vis = _visible_blocks(seg)
    assert not (vis & ~scored.numpy()).any()
    per = TILE_Q // WARP_ROWS, TILE_K // RUN
    tiles = vis.reshape(vis.shape[0], -1, per[0], vis.shape[2] // per[1], per[1]).any(axis=(2, 4))
    assert not (tiles & ~kept.numpy()).any()


def test_walk_skips_on_packed_rows():
    """At [2, 512] with the serving profile the walk loads under half the
    key tiles and scores the same output as the plain version."""
    rng = np.random.default_rng(5)
    seg = serving_segments(rng, 2, 512)[0]
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 512, 2 * 32)).astype(np.float32))
               for _ in range(3))
    stats = {}
    got = kernel_walk(q, k, v, torch.from_numpy(seg), 2, True, stats=stats)
    assert stats["kept_tiles"] < 0.5 * stats["tiles"] and stats["not_sharp"] == 0
    np.testing.assert_allclose(got.numpy(),
                               attention_bse_plain(q, k, v, torch.from_numpy(seg), 2,
                                                   True).numpy(), rtol=0, atol=F32_ATOL)
