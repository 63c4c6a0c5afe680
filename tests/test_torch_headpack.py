"""B1, the head-packed attention of the JAX kernel suite, on the CPU: the
port's plain version `attention_headpack_plain` against the Pallas B1
itself (`benchmarks/kernels.py:bench_attention_headpack`, interpret mode),
against a numpy reference in B1's order (divide before the PV product) for
hb in {1, 2, 4} and with a -1e9 padding tail, and against the port's K5
plain version (divide after PV) at the bf16 bar.

Tolerances: against the Pallas B1 and K5, bf16 outputs by max|err| <=
1e-2 * max|ref| (one bf16 rounding of p or of the output may flip where
sums run in another order); against the f32 numpy reference 2e-5 on f32
inputs (the same products, summed in another order).
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embedding_cpp_tpu_torch.ops.attention import (
    MASK_BIAS,
    attention_headpack,
    attention_headpack_plain,
    attention_long_plain,
)

ROOT = Path(__file__).resolve().parents[1]
BF16_REL = 1e-2
F32_ATOL = 2e-5


def _reference(q, k, v, bias):
    """B1 in numpy f64 then f32: softmax(q k^T * scale + bias) normalized,
    p rounded to v's dtype (f32 here), times v."""
    d = q.shape[-1]
    sc = np.einsum("bhqd,bhkd->bhqk", q, k) * (1.0 / d**0.5) + bias[:, None, None, :]
    e = np.exp(sc - sc.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v).astype(np.float32)


def _inputs(b, h, s, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, h, s, d)).astype(np.float32)).to(dtype)
            for _ in range(3)]


def _tail_bias(b, s, seed):
    lens = np.random.default_rng(seed).integers(1, s + 1, size=b)
    lens[0] = s  # one full row
    bias = np.where(np.arange(s)[None, :] < lens[:, None], 0.0, MASK_BIAS)
    return torch.from_numpy(bias.astype(np.float32))


def test_plain_matches_pallas_b1(monkeypatch):
    """The bench holds its Pallas B1 against `_flash_attention`; with that
    replaced by the port's output as a constant, its max_err_vs_per_head
    is max|Pallas B1 - port B1|."""
    sys.path.insert(0, str(ROOT))
    import benchmarks.kernels as jbench
    import embedding_cpp_tpu.ops.attention as jattn

    b, s, h, d, hb = 1, 128, 4, 32, 4
    rng = np.random.default_rng(0)  # drawn as the bench draws them
    want = [np.asarray(jnp.asarray(rng.normal(size=(b, h, s, d)), dtype=jnp.bfloat16))
            for _ in range(3)]
    held = {}

    def port_b1(q, k, v, bias, *, tq, hb):
        if "out" not in held:  # the bench's first, untraced call
            got = [np.asarray(t) for t in (q, k, v)]
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            qt, kt, vt = (torch.from_numpy(t.astype(np.float32)).to(torch.bfloat16)
                          for t in got)
            out = attention_headpack_plain(qt, kt, vt, torch.from_numpy(np.array(bias)), 4)
            held["out"] = out.float().numpy()
        return jnp.asarray(held["out"], dtype=jnp.bfloat16)

    monkeypatch.setattr(jattn, "_flash_attention", port_b1)
    r = jbench.bench_attention_headpack(b=b, s=s, h=h, d=d, hb=hb, iters=1)
    err = r["max_err_vs_per_head"]
    peak = float(np.abs(held["out"]).max())
    assert err <= BF16_REL * (peak - err), (err, peak)
    print(f"max|Pallas B1 - port B1| = {err}, max|port| = {peak}")


@pytest.mark.parametrize("hb", [1, 2, 4])
@pytest.mark.parametrize("tail", [False, True], ids=["no-padding", "padding-tail"])
def test_plain_matches_divide_before_pv_reference(hb, tail):
    b, h, s, d = 3, 4, 40, 32
    q, k, v = _inputs(b, h, s, d, seed=hb)
    bias = _tail_bias(b, s, seed=hb) if tail else torch.zeros(b, s)
    got = attention_headpack_plain(q, k, v, bias, hb)
    ref = _reference(*(t.double().numpy() for t in (q, k, v)), bias.double().numpy())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_ATOL)


def test_plain_ignores_masked_keys_and_the_grouping():
    """A -1e9 key gets no weight (its k and v can be anything), and the
    grouping hb changes nothing: the block-diagonal zeros are exact."""
    b, h, s, d = 2, 4, 48, 32
    q, k, v = _inputs(b, h, s, d, seed=5, dtype=torch.bfloat16)
    bias = torch.zeros(b, s)
    bias[:, 40:] = MASK_BIAS
    base = attention_headpack_plain(q, k, v, bias, 4)
    k2, v2 = k.clone(), v.clone()
    k2[..., 40:, :] = 100.0
    v2[..., 40:, :] = -100.0
    assert torch.equal(attention_headpack_plain(q, k2, v2, bias, 4), base)
    for hb in (1, 2):
        assert torch.equal(attention_headpack_plain(q, k, v, bias, hb), base)
    with pytest.raises(ValueError):
        attention_headpack_plain(q, k, v, bias, 3)  # 4 heads in groups of 3


@pytest.mark.parametrize("tail", [False, True], ids=["no-padding", "padding-tail"])
@pytest.mark.parametrize("d", [32, 64])
def test_plain_agrees_with_k5_plain_at_the_bf16_bar(d, tail):
    """B1 divides before PV, K5 after: in bf16 the two differ by roundings
    only."""
    b, h, s = 2, 4, 96
    q, k, v = _inputs(b, h, s, d, seed=d, dtype=torch.bfloat16)
    bias = _tail_bias(b, s, seed=d) if tail else torch.zeros(b, s)
    got = attention_headpack_plain(q, k, v, bias, 2).float()
    rows = [t.transpose(1, 2) for t in (q, k, v)]  # K5 takes [B, S, H, d]
    ref = attention_long_plain(*rows, bias).transpose(1, 2).float()
    err = (got - ref).abs().max().item()
    assert err <= BF16_REL * ref.abs().max().item(), err


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch():
    """As every wrapper in ops/attention.py: CPU tensors run the plain
    version, and only a kernel launch counts."""
    q, k, v = _inputs(1, 4, 16, 32, seed=0, dtype=torch.bfloat16)
    bias = torch.zeros(1, 16)
    before = attention_headpack.launches
    got = attention_headpack(q, k, v, bias, 4)
    assert torch.equal(got, attention_headpack_plain(q, k, v, bias, 4))
    assert attention_headpack.launches == before  # no kernel ran
    with pytest.raises(ValueError, match="unsupported device"):
        attention_headpack(q.to("meta"), k.to("meta"), v.to("meta"), bias.to("meta"), 4)
