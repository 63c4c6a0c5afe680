"""The bf16 body of the long-row attention K5/K6/K7 and its segment +
sliding-window mode 3 (`tc::attn_long_tc_kernel`, csrc/attention_long.cu)
walked in plain torch on the CPU, against the port's plain versions and the
JAX package's TPU kernels.

The CUDA kernel cannot run here, so this file repeats its walk: blocks of TQ
query rows (16 per warp; every TQ the body is built for, and the source's
`tile_q` rule) over TILE_K-key tiles of the block's key range, the whole row
(K5, K6 with wmax = S) or its TPU tile's slice (K7, K6b), both read from the
source.  K6 and K7 load only the key tiles that may hold a visible pair for
a row of the block (K6: the 8-key runs' id spans meet the block's rows'; K7:
a key within window/2; mode 3: both), and each warp scores only such 8-key
runs for its 16 rows.  Pass 1 folds the scored keys' scaled, masked scores into the row max;
pass 2 skips the same keys only when every row of the block (one head) has
m > kSharp, else the block scores every key of its range in both passes.
Pass 2 computes e = exp(s - m) in f32, the f32 row sum before e is cast, e
rounded to v's dtype for the PV product with f32 accumulation, and the
divide last.  Keys past the range enter neither the max nor the sum.

Checked: the walk against `attention_long_plain` / `attention_local_plain` /
`attention_packed_plain` / `attention_packed_window_plain` (f32 1e-5
absolute: the same products summed in another order; bf16 relative 1e-2,
one rounding) at h = 2, d in {32, 64}: K5 at S in {100, 1025, 2048} with a
padded tail and a row all padded, with no position bias and with one of PH
= 1 and H; K6 full and windowed at S = 1024 / 1152 / 2048 on contiguous
segments with a -1 tail and a row of all -1, and on shuffled non-contiguous
ids; K7 at S = 1024 / 2048 with window 16 and 128 and a row all padded;
mode 3 against `attention_packed_local_plain` at S = 1032 (no slice: every
key), 1152 and 2048 with windows 16-128, on contiguous and shuffled ids,
and its mask and skip tests as the source writes them.  At
a few small points also against the JAX entries in Pallas interpret mode
(f32 2e-5, the bar of tests/test_torch_attention.py).  And that no skipped
tile or run holds a visible (query, key) pair.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embedding_cpp_tpu.ops.attention import _flash_attention_packed as jax_seg
from embedding_cpp_tpu.ops.attention import _flash_attention_packed_window as jax_seg_window
from embedding_cpp_tpu.ops.attention import flash_attention as jax_long
from embedding_cpp_tpu.ops.attention import flash_attention_local as jax_local
from embedding_cpp_tpu_torch.ops.attention import (
    LONG_TILES,
    MASK_BIAS,
    attention_local_plain,
    attention_packed_local_plain,
    attention_long_plain,
    attention_packed_plain,
    attention_packed_window_plain,
    local_window_tiles,
    packed_window_tiles,
)

F32_ATOL = 1e-5
JAX_F32_ATOL = 2e-5
BF16_REL = 1e-2
_SRC = Path(__file__).resolve().parents[1] / "embedding_cpp_tpu_torch" / "csrc" / "attention_long.cu"
_TEXT = _SRC.read_text()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The walk is many small tensor ops: one intra-op thread runs it as
    fast as many on an idle host, and keeps it from stalling on a busy one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _TEXT)[1])


TILE_K, WARP_ROWS, RUN = _constant("TILE_K"), _constant("WARP_ROWS"), _constant("RUN")
K_SHARP = float(re.search(r"constexpr float kSharp = ([-+.e\d]+)f;", _TEXT)[1])
RULE = "pos_bias ? 64 : 128"  # the source's `tile_q` body, mirrored by tile_q() below


def tile_q(pos_bias: bool) -> int:
    """The source's `tile_q(pos_bias)`: the query rows a block."""
    return 64 if pos_bias else 128


def _slice_start(q0: int, s: int, tq: int, width: int) -> int:
    """The source's `slice_start`: the first key of the block's range."""
    if width >= s:
        return 0
    kbeg = ((q0 // tq) * tq + (tq - width) // 2) // 8 * 8
    return min(max(kbeg, 0), s - width)


# --- the skips -------------------------------------------------------------------

_BIG = np.iinfo(np.int64).max


def _run_spans(seg: np.ndarray, first: int, n: int, lim: int):
    """(lo, hi, pad) [n] of the runs of RUN positions from `first` of one
    row's ids (S % 8 == 0): [min, max] of the ids other than -1 (lo > hi
    when none) and whether -1 is there; runs at or past `lim` are empty."""
    pos = first + np.arange(n * RUN)
    ids = np.where(pos < lim, seg[np.minimum(pos, len(seg) - 1)], -2).astype(np.int64)
    ids = ids.reshape(n, RUN)
    real, pad = (ids != -1) & (ids != -2), ids == -1
    return (np.where(real, ids, _BIG).min(1), np.where(real, ids, -_BIG).max(1), pad.any(1))


def _join(sp, groups: int):
    """The spans of `groups` equal consecutive groups of the runs."""
    lo, hi, pad = (x.reshape(groups, -1) for x in sp)
    return lo.min(1), hi.max(1), pad.any(1)


def _meet(a, b) -> np.ndarray:
    """Spans that may hold a pair of equal ids (broadcasting)."""
    return ((a[0] <= b[1]) & (b[0] <= a[1])) | (a[2] & b[2])


def block_skips(form: str, s: int, tq: int, width: int, tile: int, q0: int,
                window: int = 0, seg: np.ndarray | None = None):
    """(kbeg, kend, kept [n_all], runs [tile / 16, n_all * 8]) of the block
    at q0: the key tiles it loads and, per warp, the 8-key runs it scores
    when it skips (K5 skips nothing)."""
    kbeg = _slice_start(q0, s, tq, width)
    kend = kbeg + width
    n_all = -(-width // TILE_K)
    nw = tile // WARP_ROWS
    kept = np.ones(n_all, bool)
    runs = np.ones((nw, n_all * TILE_K // RUN), bool)
    if form in ("seg", "seg_local"):
        key = _run_spans(seg, kbeg, n_all * TILE_K // RUN, kend)
        rows = _run_spans(seg, q0, tile // RUN, s)
        kept = _meet(_join(key, n_all), _join(rows, 1))
        warp = _join(rows, nw)
        runs = _meet(tuple(x[:, None] for x in warp), tuple(x[None, :] for x in key))
    if form in ("local", "seg_local"):
        w2 = window // 2
        c0 = kbeg + TILE_K * np.arange(n_all)
        c1 = np.minimum(c0 + TILE_K, kend) - 1
        kept = kept & (c0 <= q0 + tile - 1 + w2) & (c1 >= q0 - w2)
        wq0 = q0 + WARP_ROWS * np.arange(nw)[:, None]
        k0 = kbeg + RUN * np.arange(runs.shape[1])[None, :]
        runs = runs & (k0 <= wq0 + WARP_ROWS - 1 + w2) & (k0 + RUN - 1 >= wq0 - w2)
    return kbeg, kend, kept, runs


# --- the walk --------------------------------------------------------------------

def _masked(form, s_raw, scale, mask_row, pb, rows, keys, window):
    """The kernel's masked scores [H, rows, keys] from the raw f32 scores:
    K5 (s*scale + keybias) + pbias, each add rounded; K7 s*scale + (in
    window ? keybias : -1e9); K6 seg[q] == seg[k] ? s*scale : -1e9; mode 3
    seg[q] == seg[k] and |q - k| <= window/2 ? s*scale : -1e9."""
    x = s_raw * scale
    if form in ("seg", "seg_local"):
        same = mask_row[rows][:, None] == mask_row[keys][None, :]
        if form == "seg_local":
            same = same & ((rows[:, None] - keys[None, :]).abs() <= window // 2)
        return torch.where(same[None], x, torch.tensor(MASK_BIAS, dtype=torch.float32))
    if form == "local":
        inwin = (rows[:, None] - keys[None, :]).abs() <= window // 2
        add = torch.where(inwin, mask_row[keys][None, :], torch.tensor(MASK_BIAS))
        return x + add[None]
    x = x + mask_row[keys][None, None, :]
    if pb is not None:
        x = x + pb[:, rows][:, :, keys]
    return x


def kernel_walk(q, k, v, mask, form, tile, pos_bias=None, window=0, max_seg_len=None,
                stats=None):
    """The bf16 body's walk over q/k/v [B, S, H, d] -> [B, S, H, d]; form
    'full' (K5), 'local' (K7), 'seg' (K6) or 'seg_local' (mode 3)."""
    b, s, h, d = q.shape
    scale = 1.0 / (d**0.5)
    if form == "full":
        tq, width = 0, s
    elif form == "local":
        tq, width = local_window_tiles(s, window)
    elif form == "seg_local":
        tq, width = local_window_tiles(s, window)
        width = width or s
    else:
        tq, width = packed_window_tiles(s, max_seg_len)
        width = width or s
    stats = {} if stats is None else stats
    stats.update(not_sharp=0, tiles=0, kept_tiles=0, scored=0)
    pb = None
    if pos_bias is not None:
        pb = pos_bias.float()[[hh % pos_bias.shape[0] for hh in range(h)]]
    out = torch.zeros_like(q)
    for bi in range(b):
        ids = form in ("seg", "seg_local")
        mrow = mask[bi] if ids else mask[bi].float()
        seg_np = mask[bi].numpy() if ids else None
        qh, kh, vh = (t[bi].permute(1, 0, 2) for t in (q, k, v))  # [H, S, d]
        for q0 in range(0, s, tile):
            kbeg, kend, kept, runs = block_skips(form, s, tq, width, tile, q0, window, seg_np)
            n_all = len(kept)
            rows = q0 + torch.arange(tile)
            valid = rows < s
            rows = rows.clamp(max=s - 1)  # rows past S are computed, never stored
            keys = kbeg + torch.arange(n_all * TILE_K)
            inr = keys < kend
            keys = keys.clamp(max=s - 1)
            x = _masked(form, qh[:, rows].float() @ kh[:, keys].float().transpose(1, 2),
                        scale, mrow, pb, rows, keys, window)  # [H, tile, keys]
            skip = form != "full"
            act = torch.from_numpy(np.repeat(kept, TILE_K)[None, :]
                                   & np.repeat(np.repeat(runs, WARP_ROWS, 0), RUN, 1))
            act = (act if skip else torch.ones_like(act)) & inr[None, :]
            every = inr[None, :].expand(tile, -1)
            stats["tiles"] += n_all * h
            stats["kept_tiles"] += int(kept.sum()) * h
            ninf = torch.tensor(float("-inf"))
            m = torch.where(act[None], x, ninf).amax(-1)  # pass 1 over the kept tiles
            sharp = (m[:, valid] > K_SHARP).all(-1) | (not skip)  # one block per head
            stats["not_sharp"] += int((~sharp).sum())
            # a block that may not skip scores every key of its range, both passes
            m = torch.where(sharp[:, None], m, torch.where(every[None], x, ninf).amax(-1))
            act2 = torch.where(sharp[:, None, None], act[None], every[None])
            e = torch.where(act2, torch.exp(x - m[..., None]), 0.0)
            se = e.sum(-1)
            vk = torch.where(inr[:, None], vh[:, keys].float(), 0.0)
            acc = e.to(v.dtype).float() @ vk
            stats["scored"] += int(act2[:, valid].sum())
            o = (acc / se[..., None]).to(q.dtype)  # [H, tile, d]
            out[bi, rows[valid]] = o[:, valid].permute(1, 0, 2)
    return out


# --- inputs ----------------------------------------------------------------------

H = 2
B = 3


def _qkv(s: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, s, H, d)).astype(np.float32))
            for _ in range(3)]


def _key_bias(s: int) -> torch.Tensor:
    mask = np.zeros((B, s), np.float32)
    mask[1, max(1, s // 3):] = MASK_BIAS  # a padded tail
    mask[2, :] = MASK_BIAS  # every key padded
    return torch.from_numpy(mask)


def _contiguous(s: int, hi: int, seed: int) -> torch.Tensor:
    """Rows 0 and 1: segments of 1..hi tokens with a -1 tail; row 2 all -1."""
    rng = np.random.default_rng(seed)
    seg = np.full((B, s), -1, np.int32)
    for row in (0, 1):
        c = g = 0
        while True:
            n = int(rng.integers(1, hi + 1))
            if c + n > s - 8 * (row + 1):
                break
            seg[row, c:c + n] = g
            c, g = c + n, g + 1
    return torch.from_numpy(seg)


def _shuffled(s: int, seed: int) -> torch.Tensor:
    """Ids in -1..5 in no order (non-contiguous segments, padding among
    them); row 2 all -1."""
    seg = np.random.default_rng(seed).integers(-1, 6, size=(B, s)).astype(np.int32)
    seg[2] = -1
    return torch.from_numpy(seg)


def _check(walk_args, plain, tile, **kw):
    """The walk at `tile` against the plain version in f32 and bf16; the
    f32 walk's output and stats."""
    q, k, v, mask = walk_args[:4]
    extra = walk_args[4:]
    stats = {}
    got = kernel_walk(q, k, v, mask, tile=tile, stats=stats, **kw)
    ref = plain(q, k, v, mask, *extra)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=F32_ATOL)
    bq, bk, bv = (t.to(torch.bfloat16) for t in (q, k, v))
    got16 = kernel_walk(bq, bk, bv, mask, tile=tile, **kw).float()
    ref16 = plain(bq, bk, bv, mask, *extra).float()
    assert (got16 - ref16).abs().max() <= BF16_REL * ref16.abs().max()
    return got, stats


# --- the walk against the plain versions -----------------------------------------

@pytest.mark.parametrize("tile", LONG_TILES)
@pytest.mark.parametrize("ph", [None, 1, H])
@pytest.mark.parametrize("s,d", [(100, 32), (1025, 64), (2048, 32)])
def test_long_walk_matches_plain(s, d, ph, tile):
    q, k, v = _qkv(s, d, seed=s + d)
    pb = None
    if ph is not None:
        pb = torch.from_numpy(np.random.default_rng(s).standard_normal((ph, s, s))
                              .astype(np.float32))
    args = (q, k, v, _key_bias(s)) + (() if pb is None else (pb,))
    _, stats = _check(args, attention_long_plain, tile, form="full", pos_bias=pb)
    assert stats["kept_tiles"] == stats["tiles"] and stats["not_sharp"] == 0  # K5 skips nothing


@pytest.mark.parametrize("tile", LONG_TILES)
@pytest.mark.parametrize("kind", ["contiguous", "shuffled"])
@pytest.mark.parametrize("s,d,max_seg_len", [(1024, 32, 128), (1152, 64, 128), (2048, 32, 512),
                                             (1024, 64, None), (1152, 32, None),
                                             (2048, 64, None)])
def test_segment_walk_matches_plain(s, d, max_seg_len, kind, tile):
    q, k, v = _qkv(s, d, seed=s + d + 1)
    seg = _shuffled(s, s) if kind == "shuffled" else _contiguous(s, max_seg_len or 400, s)
    windowed = max_seg_len is not None
    assert (packed_window_tiles(s, max_seg_len)[1] is not None) == windowed
    args = (q, k, v, seg) + ((max_seg_len,) if windowed else ())
    _, stats = _check(args, attention_packed_window_plain if windowed else attention_packed_plain,
                      tile, form="seg", max_seg_len=max_seg_len)
    assert stats["not_sharp"] == 0  # every row sees its own key: pass 2 always skips
    if kind == "contiguous":
        assert stats["kept_tiles"] < stats["tiles"]


@pytest.mark.parametrize("tile", LONG_TILES)
@pytest.mark.parametrize("window", [16, 128])
@pytest.mark.parametrize("s,d", [(1024, 64), (2048, 32)])
def test_local_walk_matches_plain(s, d, window, tile):
    q, k, v = _qkv(s, d, seed=s + window)
    _, stats = _check((q, k, v, _key_bias(s), window), attention_local_plain, tile,
                      form="local", window=window)
    assert stats["kept_tiles"] < stats["tiles"]
    # the padded rows' blocks (whole windows masked) score the whole slice
    assert stats["not_sharp"] >= H * s // tile


@pytest.mark.parametrize("tile", LONG_TILES)
@pytest.mark.parametrize("kind", ["contiguous", "shuffled"])
@pytest.mark.parametrize("s,d,window", [(1032, 32, 128), (1152, 32, 64), (2048, 32, 16)])
def test_segment_local_walk_matches_plain(s, d, window, kind, tile):
    """Mode 3: segments of 1..400 tokens (shorter and longer than the
    window) with a -1 tail and a row all -1, or shuffled ids."""
    q, k, v = _qkv(s, d, seed=s + window)
    seg = _shuffled(s, s + 1) if kind == "shuffled" else _contiguous(s, 400, s + 2)
    assert (local_window_tiles(s, window)[1] is None) == (s % 128 != 0)
    _, stats = _check((q, k, v, seg, window), attention_packed_local_plain, tile,
                      form="seg_local", window=window)
    assert stats["not_sharp"] == 0  # every row sees its own key: pass 2 always skips
    if kind == "contiguous":
        assert stats["kept_tiles"] < stats["tiles"]


def test_segment_local_mask_and_skips_in_the_source():
    """Mode 3 in the source as the walk models it: the score of a key is
    s*scale only where both the segment test and the window test pass, and
    a key tile or an 8-key run is kept only where both the span test and
    the window test keep it."""
    masked = re.search(r"MODE == kSegLocal\) \{\s*const int ids\[2\](.*?)\} else \{", _TEXT,
                       re.S)[1]
    # the f32 body's score
    assert "return sg[key] == segq && dist <= window / 2 ? s : kMaskBias;" in _TEXT
    vis = re.search(r"const bool vis = (.*?);", masked)[1]
    assert vis.replace(" ", "") == "ids[e]==segq[hr]&&abs(qpos[hr]-(c0+c+e))<=w2", vis
    assert "vis ? __fmul_rn(acc[2 * hr + e], scale) : kMaskBias" in masked
    keep = re.search(r"keep = true;(.*?)const unsigned bal", _TEXT, re.S)[1]
    assert "if constexpr (has_seg(MODE))" in keep and "keep = span_meet(ksp, qsp);" in keep
    assert "keep = keep && c0 <= q0 + TQ - 1 + w2 && c1 >= q0 - w2;" in keep
    assert "if constexpr (has_seg(MODE)) meet = span_meet(wspan, spans[tt * RUNS + nb]);" in _TEXT
    assert "meet = meet && k0 <= wq0 + WARP_ROWS - 1 + w2 && k0 + RUN - 1 >= wq0 - w2;" in _TEXT
    modes = dict(re.findall(r"(k\w+) = (\d)", re.search(r"enum Mode \{(.*?)\};", _TEXT)[1]))
    assert modes == {"kFull": "0", "kLocal": "1", "kSeg": "2", "kSegLocal": "3"}
    assert "return mode == kSeg || mode == kSegLocal;" in _TEXT
    assert "return mode == kLocal || mode == kSegLocal;" in _TEXT


# --- the walk against the TPU kernels (interpret mode) ---------------------------

def _np(*ts):
    return [jnp.asarray(t.numpy()) for t in ts]


def test_long_walk_matches_pallas():
    s, d = 1024, 32
    q, k, v = _qkv(s, d, seed=3)
    mask = _key_bias(s)
    pb = torch.from_numpy(np.random.default_rng(4).standard_normal((1, s, s)).astype(np.float32))
    got = kernel_walk(q, k, v, mask, "full", tile_q(True), pos_bias=pb)
    ref = np.asarray(jax_long(*_np(q, k, v, mask), pos_bias=jnp.asarray(pb.numpy())))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=JAX_F32_ATOL)


def test_local_walk_matches_pallas():
    s, d, window = 1024, 32, 16
    q, k, v = _qkv(s, d, seed=5)
    mask = _key_bias(s)
    got = kernel_walk(q, k, v, mask, "local", tile_q(False), window=window)
    ref = np.asarray(jax_local(*_np(q, k, v, mask), window))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=JAX_F32_ATOL)


@pytest.mark.parametrize("max_seg_len", [128, None])
def test_segment_walk_matches_pallas(max_seg_len):
    s, d = 1024, 32
    q, k, v = _qkv(s, d, seed=6)
    seg = _contiguous(s, max_seg_len or 300, 7)
    got = kernel_walk(q, k, v, seg, "seg", tile_q(False), max_seg_len=max_seg_len)
    jq, jk, jv = (jnp.asarray(t.numpy().transpose(0, 2, 1, 3)) for t in (q, k, v))
    tq, wmax = packed_window_tiles(s, max_seg_len)
    if wmax is None:
        ref = jax_seg(jq, jk, jv, jnp.asarray(seg.numpy()), tq=128, hb=1)
    else:
        ref = jax_seg_window(jq, jk, jv, jnp.asarray(seg.numpy()), tq=tq, wmax=wmax, hb=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).transpose(0, 2, 1, 3), rtol=0,
                               atol=JAX_F32_ATOL)


# --- the tiling and the skips ----------------------------------------------------

def test_tile_constants_match_the_source():
    body = re.search(r"constexpr int tile_q\(bool pos_bias\) \{\s*return (.*?);", _TEXT, re.S)[1]
    assert body.split() == RULE.split(), body
    for tile in LONG_TILES:
        assert f"std::integral_constant<int, {tile}>" in _TEXT
        assert tile % WARP_ROWS == 0 and 128 % tile == 0  # it divides the TPU tile (128, 256)
    assert {tile_q(False), tile_q(True)} <= set(LONG_TILES)
    assert TILE_K % RUN == 0 and WARP_ROWS == 16 and K_SHARP == 0.5 * MASK_BIAS


def _visible(form, s, seg, window, rows, keys):
    """[rows, keys]: the pairs whose score is not masked by the skip's rule
    (K6: equal ids; K7: within window/2; mode 3: both)."""
    inwin = np.abs(rows[:, None] - keys[None, :]) <= window // 2
    if form == "local":
        return inwin
    same = seg[rows][:, None] == seg[keys][None, :]
    return same & inwin if form == "seg_local" else same


@pytest.mark.parametrize("tile", LONG_TILES)
@pytest.mark.parametrize("case", ["seg_window", "seg_full", "seg_shuffled", "seg_few_ids",
                                  "local_16", "local_128", "seglocal_16", "seglocal_128"])
@pytest.mark.parametrize("s", [1024, 2048])
def test_skips_never_drop_a_visible_pair(s, case, tile):
    rng = np.random.default_rng(s + len(case))
    form = {"seg": "seg", "local": "local", "seglocal": "seg_local"}[case.split("_")[0]]
    window = int(case.split("_")[1]) if form != "seg" else 0
    seg = None
    if case == "seg_shuffled":
        seg = rng.integers(-1, 40, size=s).astype(np.int32)
    elif case == "seg_few_ids":  # two ids alternating in long runs, padding among them
        seg = (np.arange(s) // 37 % 2).astype(np.int32)
        seg[rng.integers(0, s, size=s // 10)] = -1
    elif form != "local":
        seg = _contiguous(s, 300, s)[0].numpy()
    if form == "seg":
        tq, width = packed_window_tiles(s, 512 if case == "seg_window" else None)
        width = width or s
    else:
        tq, width = local_window_tiles(s, window)
        width = width or s
    skipped = 0
    for q0 in range(0, s, tile):
        kbeg, kend, kept, runs = block_skips(form, s, tq, width, tile, q0, window, seg)
        keys = np.arange(kbeg, kend)
        act = (np.repeat(kept, TILE_K)[None, :]
               & np.repeat(np.repeat(runs, WARP_ROWS, 0), RUN, 1))[:, :len(keys)]
        rows = q0 + np.arange(tile)
        vis = _visible(form, s, seg, window, np.minimum(rows, s - 1), keys) & (rows < s)[:, None]
        assert not (vis & ~act).any(), (q0, case)
        skipped += int((~act).sum())
    if case in ("seg_window", "seg_full", "local_16", "local_128", "seglocal_16",
                "seglocal_128"):
        assert skipped > 0  # the rule engages (on shuffled ids a span covers every id)
