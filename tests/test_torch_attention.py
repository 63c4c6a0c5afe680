"""The port's projection-layout attention (its plain version, on the CPU)
against the JAX package's `flash_attention_bse` / `flash_attention_packed_bse`,
whose `_attn_bse_kernel` runs in Pallas interpret mode on the CPU.

Tolerance 2e-5 absolute in f32: the same order of operations, with sums
taken in a different order.
"""
import jax.numpy as jnp
import numpy as np
import torch

from embedding_cpp_tpu.ops.attention import flash_attention_bse as jax_bse
from embedding_cpp_tpu.ops.attention import flash_attention_packed_bse as jax_packed_bse
from embedding_cpp_tpu_torch.ops.attention import (
    MASK_BIAS,
    attention_bse_plain,
    flash_attention_bse,
    flash_attention_packed_bse,
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
