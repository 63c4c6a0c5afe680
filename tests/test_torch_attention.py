"""The port's attention (its plain versions, on the CPU) against the JAX
package's kernels in Pallas interpret mode on the CPU: the projection-layout
`flash_attention_bse` / `flash_attention_packed_bse` and their position-bias
forms `flash_attention_bias_bse` / `flash_attention_bias_packed_bse`
(`_attn_bse_kernel`), the long-row `flash_attention` (`_attn_kernel`) and
the sliding-window `flash_attention_local` (`_attn_local_kernel`).

Tolerance 2e-5 absolute in f32: the same order of operations, with sums
taken in a different order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embedding_cpp_tpu.ops.attention import flash_attention_bse as jax_bse
from embedding_cpp_tpu.ops.attention import flash_attention_packed_bse as jax_packed_bse
from embedding_cpp_tpu_torch.ops.attention import (
    MASK_BIAS,
    attention_bse_plain,
    attention_local_plain,
    attention_long_plain,
    flash_attention,
    flash_attention_bias_bse,
    flash_attention_bias_packed_bse,
    flash_attention_bse,
    flash_attention_local,
    flash_attention_packed_bse,
    local_window_tiles,
)

ATOL = 2e-5
B, S, H, D = 2, 128, 4, 16


def _qkv(seed: int, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H * D)).astype(dtype) for _ in range(3)]


def _segments() -> np.ndarray:
    """Row 0: segments of assorted lengths with a -1 padding tail; row 1:
    all padding."""
    seg = np.full((B, S), -1, np.int32)
    c = 0
    for g, n in enumerate([5, 17, 1, 40, 23, 9]):
        seg[0, c:c + n] = g
        c += n
    return seg


def test_key_bias_variant_matches_pallas():
    q, k, v = _qkv(0)
    lens = [S - 37, 0]  # row 1 has every key padded
    mask = np.zeros((B, S), np.float32)
    for i, n in enumerate(lens):
        mask[i, n:] = MASK_BIAS
    ref = np.asarray(jax_bse(*map(jnp.asarray, (q, k, v, mask)), H))
    got = flash_attention_bse(*map(torch.from_numpy, (q, k, v, mask)), H).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_segment_variant_matches_pallas():
    q, k, v = _qkv(1)
    seg = _segments()
    ref = np.asarray(jax_packed_bse(*map(jnp.asarray, (q, k, v, seg)), H))
    got = flash_attention_packed_bse(*map(torch.from_numpy, (q, k, v, seg)), H).numpy()
    assert np.isfinite(got).all()  # padding (seg -1) rows stay finite
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_segments_are_independent_sentences():
    """A packed segment attends only to itself: its output equals the
    key-bias variant run on that sentence alone."""
    q, k, v = _qkv(2)
    seg = _segments()
    packed = attention_bse_plain(*map(torch.from_numpy, (q, k, v, seg)), H, True)
    lo, hi = 5, 22  # segment 1
    alone = attention_bse_plain(
        *(torch.from_numpy(t[:1, lo:hi]) for t in (q, k, v)),
        torch.zeros(1, hi - lo), H, False)
    np.testing.assert_allclose(packed[0, lo:hi].numpy(), alone[0].numpy(),
                               rtol=0, atol=ATOL)


def test_bf16_casts_e_before_the_pv_product():
    """bf16 inputs give a bf16 output whose PV product consumed e rounded
    to bf16 — the kernel's order — within one bf16 rounding of the f32
    result."""
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in _qkv(3))
    mask = torch.zeros(B, S)
    out = attention_bse_plain(q, k, v, mask, H, False)
    assert out.dtype == torch.bfloat16
    ref = attention_bse_plain(q.float(), k.float(), v.float(), mask, H, False)
    err = (out.float() - ref).abs().max() / ref.abs().max()
    assert err <= 1e-2


def test_cpu_tensors_never_launch():
    q, k, v = (torch.from_numpy(t) for t in _qkv(4))
    before = (flash_attention_bse.launches, flash_attention_packed_bse.launches)
    flash_attention_bse(q, k, v, torch.zeros(B, S), H)
    flash_attention_packed_bse(q, k, v, torch.from_numpy(_segments()), H)
    assert (flash_attention_bse.launches, flash_attention_packed_bse.launches) == before


# --- K4: the projection-layout kernel with a [PH, S, S] position bias ---------

@pytest.mark.parametrize("ph", [1, H])
def test_bias_variants_match_pallas(ph):
    from embedding_cpp_tpu.ops.attention import flash_attention_bias_bse as jax_bias_bse
    from embedding_cpp_tpu.ops.attention import (
        flash_attention_bias_packed_bse as jax_bias_packed_bse,
    )

    q, k, v = _qkv(5)
    pb = np.random.default_rng(6).normal(size=(ph, S, S)).astype(np.float32)
    pb[:, :, 100:] = MASK_BIAS  # a window-style -1e9 band too
    mask = np.zeros((B, S), np.float32)
    mask[0, S - 37:] = MASK_BIAS
    mask[1, :] = MASK_BIAS
    ref = np.asarray(jax_bias_bse(*map(jnp.asarray, (q, k, v, mask, pb)), H))
    got = flash_attention_bias_bse(*map(torch.from_numpy, (q, k, v, mask, pb)), H).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    seg = _segments()
    ref = np.asarray(jax_bias_packed_bse(*map(jnp.asarray, (q, k, v, seg, pb)), H))
    got = flash_attention_bias_packed_bse(*map(torch.from_numpy, (q, k, v, seg, pb)),
                                          H).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_zero_bias_equals_the_bias_free_kernel():
    """Adding a zero [1, S, S] bias is exact: ModernBERT's global layers
    may take K2/K3 where the reference runs K4 with zeros."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(7))
    zero = torch.zeros(1, S, S)
    mask = torch.zeros(B, S)
    seg = torch.from_numpy(_segments())
    assert torch.equal(flash_attention_bias_bse(q, k, v, mask, zero, H),
                       flash_attention_bse(q, k, v, mask, H))
    assert torch.equal(flash_attention_bias_packed_bse(q, k, v, seg, zero, H),
                       flash_attention_packed_bse(q, k, v, seg, H))


# --- K5 / K7: long rows and the sliding window, [B, S, H, d] ------------------

LB, LS, LH, LD = 2, 2048, 2, 16


def _long_inputs(seed: int):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(LB, LS, LH, LD)).astype(np.float32) for _ in range(3))
    mask = np.zeros((LB, LS), np.float32)
    mask[0, 1500:] = MASK_BIAS  # a padded tail
    mask[1, :] = MASK_BIAS  # a fully padded row
    return q, k, v, mask


@pytest.mark.parametrize("ph", [None, 1, LH])
def test_long_rows_match_pallas(ph):
    """flash_attention at S = 2048 against the TPU `_attn_kernel` (interpret
    mode), every row, padding rows included."""
    from embedding_cpp_tpu.ops.attention import flash_attention as jax_flash

    q, k, v, mask = _long_inputs(8)
    pb = None
    if ph is not None:
        pb = np.random.default_rng(9).normal(size=(ph, LS, LS)).astype(np.float32)
    ref = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v, mask)),
                               pos_bias=None if pb is None else jnp.asarray(pb)))
    got = flash_attention(*map(torch.from_numpy, (q, k, v, mask)),
                          pos_bias=None if pb is None else torch.from_numpy(pb)).numpy()
    assert got.shape == (LB, LS, LH, LD) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("window", [16, 128])
def test_sliding_window_matches_pallas_row_for_row(window):
    """flash_attention_local against the TPU `_attn_local_kernel`: the same
    key slice per query tile, so padding rows (whose slice is all padding)
    agree too."""
    from embedding_cpp_tpu.ops.attention import flash_attention_local as jax_local

    q, k, v, mask = _long_inputs(10)
    ref = np.asarray(jax_local(*map(jnp.asarray, (q, k, v, mask)), window))
    got = flash_attention_local(*map(torch.from_numpy, (q, k, v, mask)), window).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_sliding_window_equals_full_masking_on_valid_rows():
    """For a valid query the slice holds every key of its window: the
    result equals the long-row kernel with the [S, S] window bias."""
    q, k, v, mask = (torch.from_numpy(t) for t in _long_inputs(11))
    win = np.abs(np.arange(LS)[None, :] - np.arange(LS)[:, None]) <= 8
    bias = torch.from_numpy(np.where(win, 0.0, MASK_BIAS).astype(np.float32))[None]
    local = attention_local_plain(q, k, v, mask, 16)
    full = attention_long_plain(q, k, v, mask, bias)
    np.testing.assert_allclose(local[0, :1500].numpy(), full[0, :1500].numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("s,window", [(2048, 128), (8192, 128), (1024, 128), (512, 16),
                                      (1100, 16), (256, 128)])
def test_local_window_tiles_match_jax(s, window):
    from embedding_cpp_tpu.ops.attention import local_window_tiles as jax_tiles

    assert local_window_tiles(s, window) == jax_tiles(s, window)


def test_new_wrappers_never_launch_on_cpu():
    q, k, v, mask = (torch.from_numpy(t) for t in _long_inputs(12))
    counts = ((flash_attention, "launches"), (flash_attention_local, "launches"),
              (flash_attention_bse, "bias_launches"),
              (flash_attention_packed_bse, "bias_launches"))

    def read():
        return [getattr(f, attr) for f, attr in counts]

    before = read()
    flash_attention(q, k, v, mask)
    flash_attention_local(q, k, v, mask, 16)
    q2, k2, v2 = (torch.from_numpy(t) for t in _qkv(13))
    flash_attention_bias_bse(q2, k2, v2, torch.zeros(B, S), torch.zeros(1, S, S), H)
    flash_attention_bias_packed_bse(q2, k2, v2, torch.from_numpy(_segments()),
                                    torch.zeros(H, S, S), H)
    assert read() == before
