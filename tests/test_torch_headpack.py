"""B1, the head-packed attention of the JAX kernel suite, on the CPU: the
port's plain version `attention_headpack_plain` against the Pallas B1
itself (`benchmarks/kernels.py:bench_attention_headpack`, interpret mode),
against a numpy reference in B1's order (divide before the PV product) for
hb in {1, 2, 4} and with a -1e9 padding tail, and against the port's K5
plain version (divide after PV) at the bf16 bar; and the CUDA kernel's
tiling (`b1_walk`, below) against the plain version at every (d, hb) it is
built for.

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
    HEADPACK_SHAPES,
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


# --- the card's tiling of B1, walked on the CPU ----------------------------------
#
# csrc/attention_headpack.cu's schedule in plain torch: blocks over (query
# tile of TQ rows, group of hb heads, batch row); per head two passes over
# key tiles of TILE_K keys.  Pass 1: lane t of a quad holds columns 8nb +
# 2t and 8nb + 2t + 1 of each tile (nb < TILE_K / 8) and keeps their
# running max and f32 sum of exp(s - max), rescaled when the max grows;
# the quad merges its four lanes (xor 1, then xor 2).  Pass 2: p = exp(s -
# m) / sum rounded to bf16, p . v in f32, one cast.  Keys past S are out of
# every max and sum.  Held against `attention_headpack_plain` at the bf16
# bar above (the sum differs from the plain version's by f32 rounding, so
# a bf16 p may flip one rounding).

_SRC = ROOT / "embedding_cpp_tpu_torch" / "csrc" / "attention_headpack.cu"


def _constant(name: str) -> int:
    import re

    return int(re.search(rf"constexpr int {name} = (\d+);", _SRC.read_text())[1])


TQ, TILE_K = _constant("TQ"), _constant("TILE_K")


def _merge(m1, l1, m2, l2):
    """Two lanes' (max, sum) as one, as the kernel's quad merge."""
    mm = torch.maximum(m1, m2)
    a = torch.where(l1 == 0, 0.0, l1 * torch.exp(m1 - mm))
    c = torch.where(l2 == 0, 0.0, l2 * torch.exp(m2 - mm))
    return mm, a + c


def b1_walk(q, k, v, bias, hb: int) -> torch.Tensor:
    b, h, s, d = q.shape
    scale = torch.tensor(1.0 / d**0.5, dtype=torch.float32)  # the launch's f32 scale
    ninf = float("-inf")
    out = torch.zeros_like(q)

    def scores(qt, bb, hd, c0):
        kt = k[bb, hd, c0:c0 + TILE_K].to(torch.float32)
        hi = kt.shape[0]
        sc = torch.full((qt.shape[0], TILE_K), ninf)
        sc[:, :hi] = (qt @ kt.T) * scale + bias[bb, c0:c0 + hi]
        return sc, hi

    for bb in range(b):
        for h0 in range(0, h, hb):  # one block per head group and query tile
            for q0 in range(0, s, TQ):
                for hd in range(h0, h0 + hb):
                    qt = q[bb, hd, q0:q0 + TQ].to(torch.float32)
                    rows = qt.shape[0]
                    m = torch.full((rows, 4), ninf)
                    l = torch.zeros((rows, 4))
                    for c0 in range(0, s, TILE_K):  # pass 1
                        sc, _ = scores(qt, bb, hd, c0)
                        lane = sc.view(rows, TILE_K // 8, 4, 2).permute(0, 2, 1, 3)
                        lane = lane.reshape(rows, 4, -1)  # [rows, t, the lane's columns]
                        tm = lane.amax(-1)
                        has = tm > ninf
                        mn = torch.where(has, torch.maximum(m, tm), m)
                        part = torch.exp(lane - mn[..., None]).sum(-1)
                        l = torch.where(has, l * torch.exp(m - mn) + part, l)
                        m = mn
                    m01, l01 = _merge(m[:, 0], l[:, 0], m[:, 1], l[:, 1])
                    m23, l23 = _merge(m[:, 2], l[:, 2], m[:, 3], l[:, 3])
                    mr, lr = _merge(m01, l01, m23, l23)
                    acc = torch.zeros((rows, d))
                    for c0 in range(0, s, TILE_K):  # pass 2
                        sc, hi = scores(qt, bb, hd, c0)
                        p = (torch.exp(sc[:, :hi] - mr[:, None]) / lr[:, None]).to(v.dtype)
                        acc += p.to(torch.float32) @ v[bb, hd, c0:c0 + hi].to(torch.float32)
                    out[bb, hd, q0:q0 + TQ] = acc.to(q.dtype)
    return out


@pytest.fixture
def one_thread():
    """The walk is many small tensor ops: one intra-op thread runs it as
    fast as many on an idle host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("d,hb", HEADPACK_SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("s,tail", [(130, False), (77, True)],
                         ids=["S130-no-padding", "S77-padding-tail-and-a-row-all-padding"])
def test_tile_walk_matches_plain(d, hb, s, tail):
    """Every (d, hb) the kernel is built for, at a ragged S over 2-3 query
    tiles and 2-3 key tiles: with no padding, and with padding tails and one
    row all padding (-1e9 on every key)."""
    b, h = 3, 4
    q, k, v = _inputs(b, h, s, d, seed=d + hb, dtype=torch.bfloat16)
    bias = _tail_bias(b, s, seed=hb) if tail else torch.zeros(b, s)
    if tail:
        bias[-1] = MASK_BIAS
    got = b1_walk(q, k, v, bias, hb)
    ref = attention_headpack_plain(q, k, v, bias, hb).to(torch.float32)
    err = (got.to(torch.float32) - ref).abs().max().item()
    assert err <= BF16_REL * ref.abs().max().item(), err
