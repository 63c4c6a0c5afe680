"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a GPU every test here skips.  On a machine with an
H100 and nvcc:  python -m pytest tests/test_torch_cuda.py -q
Edge shapes live here (ragged M, sequence lengths that are not multiples of
the 16-row tiles, fully padded rows); chip_smoke.py checks the main-path
shapes.

Tolerances: f32 1e-4 absolute (the same f32 products summed in another
order); bf16 by relative error max|err| / max|ref| <= 1e-2 (an order
difference can flip one bf16 rounding, 2^-8 relative).
"""
import numpy as np
import pytest
import torch

from embedding_cpp_tpu_torch.gguf import GGMLType
from embedding_cpp_tpu_torch.gguf.quant import quantize
from embedding_cpp_tpu_torch.ops import qtensor as tqt
from embedding_cpp_tpu_torch.ops.attention import (
    MASK_BIAS,
    attention_bse_plain,
    flash_attention_bse,
    flash_attention_packed_bse,
)
from embedding_cpp_tpu_torch.ops.q4_matmul import q4_matmul, q4_matmul_plain

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got: torch.Tensor, ref: torch.Tensor, dtype) -> None:
    got, ref = got.float().cpu(), ref.float().cpu()
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4, err
    else:
        assert err / max(ref.abs().max().item(), 1e-30) <= 1e-2, err


def _weight(qtype: str, k: int, n: int, dev, seed: int = 0) -> tqt.QTensor:
    w = np.random.default_rng(seed).normal(scale=0.02, size=(n, k)).astype(np.float32)
    raw = quantize(w, GGMLType[qtype])
    t = (tqt.pack_q8_matmul(raw, (n, k)) if qtype == "Q8_0"
         else tqt.pack_q4_matmul(raw, (n, k), GGMLType[qtype]))
    return t.map(lambda x: x.to(dev))


@pytest.mark.parametrize("qtype", ["Q4_0", "Q4_1", "Q8_0"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,act", [
    (64, 128, 128, None), (40, 384, 128, "gelu_erf"), (1, 32, 64, "gelu_tanh"),
    (200, 384, 1536, "silu"), (130, 1536, 384, None), (77, 64, 100, "gelu_erf"),
])
def test_q4_matmul_kernel_matches_plain(dev, qtype, dtype, m, k, n, act):
    w = _weight(qtype, k, n, dev)
    gen = torch.Generator(device="cpu").manual_seed(m * 7 + k)
    x = torch.randn(m, k, generator=gen).to(dev, dtype)
    bias = torch.randn(n, generator=gen).to(dev) * 0.1
    before = q4_matmul.launches
    got = q4_matmul(x, w, bias=bias, activation=act)
    assert q4_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    _close(got, q4_matmul_plain(x, w, bias, act), dtype)


def test_q4_matmul_out_f32(dev):
    w = _weight("Q4_0", 384, 384, dev)
    x = torch.randn(96, 384, device=dev).to(torch.bfloat16)
    got = q4_matmul(x, w, out_f32=True)
    assert got.dtype == torch.float32
    ref = q4_matmul_plain(x, w, out_f32=True)
    assert (got - ref).abs().max().item() <= 1e-3


def _qkv(b, s, h, d, dtype, dev, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(b, s, h * d, generator=gen).to(dev, dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,d", [(8, 2, 16), (24, 4, 16), (40, 12, 32), (128, 4, 64),
                                   (512, 12, 32), (1024, 2, 128)])
def test_key_bias_kernel_matches_plain(dev, dtype, s, h, d):
    b = 3
    q, k, v = _qkv(b, s, h, d, dtype, dev)
    mask = torch.zeros(b, s, device=dev)
    mask[1, max(1, s // 3):] = MASK_BIAS
    mask[2, :] = MASK_BIAS  # every key padded
    got = flash_attention_bse(q, k, v, mask, h)
    _close(got, attention_bse_plain(q, k, v, mask, h, False), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,d", [(24, 4, 16), (128, 4, 32), (512, 12, 32), (1000, 2, 64)])
def test_segment_kernel_matches_plain(dev, dtype, s, h, d):
    b = 2
    q, k, v = _qkv(b, s, h, d, dtype, dev, seed=1)
    rng = np.random.default_rng(s)
    seg = np.full((b, s), -1, np.int32)
    c, g = 0, 0
    while True:
        n = int(rng.integers(1, 40))
        if c + n > s - 3:
            break
        seg[0, c:c + n] = g
        c, g = c + n, g + 1
    seg_t = torch.from_numpy(seg).to(dev)  # row 1: all padding
    got = flash_attention_packed_bse(q, k, v, seg_t, h)
    _close(got, attention_bse_plain(q, k, v, seg_t, h, True), dtype)


def test_attention_rejects_what_it_does_not_serve(dev):
    q, k, v = _qkv(1, 16, 2, 24, torch.bfloat16, dev)
    with pytest.raises(ValueError):
        flash_attention_bse(q, k, v, torch.zeros(1, 16, device=dev), 2)  # d = 24
    q, k, v = _qkv(1, 1032, 1, 32, torch.bfloat16, dev)
    with pytest.raises(ValueError):
        flash_attention_bse(q, k, v, torch.zeros(1, 1032, device=dev), 1)  # S > 1024
