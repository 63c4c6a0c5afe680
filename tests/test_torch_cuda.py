"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a GPU every test here skips.  On a machine with an
H100 and nvcc:  python -m pytest tests/test_torch_cuda.py -q
Edge shapes live here (ragged M, sequence lengths that are not multiples of
the 16- and 64-row tiles, S = 1025, fully padded rows, head dims 32 and
64, f32 and bf16) for K1 (with and without its prologue multiply, each bf16
tile instance forced at a model shape and at ragged M / N with out_f32,
and its residual + LayerNorm epilogue up to and past the cap on N), the N-tiled
K8 (ragged M, K = 32, K % 64 == 32, N below and not a multiple of the
128-column tile or of 16, every activation and qtype, the prologue,
out_f32, the corpus's packed M = 65536, bf16 at K = 8192, every f32 slice
width and an f32 slice past the shared memory), the projection-layout kernel with and without a position bias
(K2-K4: S = 8 ... 1024, the short buckets a block takes several batch rows
of, shuffled segment ids, rows all padding, a position-bias row of -1e9,
S = 1024 at d = 128, bge-large's 16 heads of 64), the
long-row kernel (K5), the sliding-window kernel (K7, also at S = 8192 with a
padded row), the packed-segment kernel (K6, full and windowed: S = 200 ...
8192, segments ending on tile boundaries, shuffled non-contiguous ids,
padded tails, a row all padding), its segment + sliding-window mode (mode
3: S = 1032 and 1100 without a slice, 1024 ... 8192 over K7's slices,
segments shorter and longer than the window, a padded tail, a row all
padding, shuffled ids), each of the long body's bf16 query tiles
forced in every form and the disentangled-attention
kernel (K9 key bias, K10 segments; S = 16 ... 512 with spans below and
above S, S off the bf16 kernel's 64-row tiles, segments crossing them, a
row all padding) and the kernel suite's head-packed attention (B1: every (d, hb)
it is built for, S = 1 ... 512, padded tails, a row all padding); the
BERT-graph families (XLM-R, DistilBERT, ELECTRA base and small, MPNet,
ALBERT) and T5 (relu and gated) at their published widths, two layers
deep, with every K1 / K2 / K3 / K4 call of the forward and of the score
path held against its plain version, ELECTRA-small's factorized
embedding, and K4 with MPNet's / T5's bucketed per-head bias at the
shapes their forwards give it;
chip_smoke.py checks the main-path shapes.

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
    _FULL,
    _LOCAL,
    _SEG,
    _SEG_LOCAL,
    LONG_TILES,
    MASK_BIAS,
    _launch_long,
    attention_headpack,
    attention_headpack_plain,
    attention_bse_plain,
    attention_local_plain,
    attention_long_plain,
    attention_packed_local_plain,
    attention_packed_plain,
    attention_packed_window_plain,
    flash_attention,
    flash_attention_bias_bse,
    flash_attention_bias_packed_bse,
    flash_attention_bse,
    flash_attention_local,
    flash_attention_packed,
    flash_attention_packed_bse,
    flash_attention_packed_local,
    local_window_tiles,
    packed_window_tiles,
)
from embedding_cpp_tpu_torch.ops.deberta_attention import (
    delta_tables,
    disentangled_attention,
    disentangled_attention_packed,
    disentangled_attention_plain,
)
from embedding_cpp_tpu_torch.ops.dispatch import kernel_impls
from embedding_cpp_tpu_torch.ops.q4_matmul import (
    TC_TILES,
    _q4_matmul_1d,
    _q4_matmul_2d,
    q4_matmul,
    q4_matmul_plain,
    route,
    tile,
)

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


@pytest.mark.parametrize("bm,bn", sorted(TC_TILES))
@pytest.mark.parametrize("qtype", ["Q4_0", "Q4_1", "Q8_0"])
@pytest.mark.parametrize("m,k,n,act,gated,out_f32", [
    (16384, 384, 384, None, False, False),      # MiniLM's q/k/v/o
    (512, 768, 768, "gelu_erf", False, False),  # DeBERTa's relative-table projection
    (300, 1120, 200, "gelu_tanh", True, False),  # ragged M, K % 64 == 32, N % 16 != 0
    (77, 64, 100, "silu", True, True),          # N below every tile, out_f32
    (1, 32, 1152, None, False, False),          # one row, K = 32
])
def test_k1_tile_instances_match_plain(dev, bm, bn, qtype, m, k, n, act, gated, out_f32):
    """K1's bf16 body forced through each tile instance of the source at a
    model shape and at ragged M / N, with the prologue and out_f32."""
    w = _weight(qtype, k, n, dev, seed=11)
    gen = torch.Generator(device="cpu").manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen).to(dev, torch.bfloat16)
    g = torch.randn(m, k, generator=gen).to(dev, torch.bfloat16) if gated else None
    bias = torch.randn(n, generator=gen).to(dev) * 0.1
    before = (q4_matmul.launches, q4_matmul.prologue_launches, q4_matmul.n_tiled_launches)
    got = _q4_matmul_1d(x, w, bias, prologue_mul=g, activation=act, out_f32=out_f32,
                        tile=(bm, bn))
    assert (q4_matmul.launches, q4_matmul.prologue_launches, q4_matmul.n_tiled_launches) == (
        before[0] + 1, before[1] + gated, before[2])
    assert got.dtype == (torch.float32 if out_f32 else torch.bfloat16) and got.shape == (m, n)
    ref = q4_matmul_plain(x, w, bias, act, out_f32=out_f32, prologue_mul=g)
    _close(got, ref, torch.bfloat16)


def test_k1_tile_layouts_and_an_unnamed_tile(dev):
    """Each instance runs at the blocks per SM it is built for, with and
    without the prologue; a tile the source does not name is refused at
    launch and the wrapper raises."""
    for (bm, bn), blocks in TC_TILES.items():
        for prologue in (False, True):
            t = tile(prologue, bm, bn)
            assert (t["bm"], t["bn"], t["bk"], t["stages"]) == (bm, bn, 64, 3)
            assert t["blocks_per_sm"] == blocks, (bm, bn, prologue, t)
    w = _weight("Q4_0", 128, 128, dev)
    x = torch.zeros(64, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="q4_matmul_launch"):
        _q4_matmul_1d(x, w, tile=(32, 32))
    with pytest.raises(RuntimeError, match="q4_matmul_tile"):
        tile(False, 32, 32)
    _close(_q4_matmul_1d(x, w), q4_matmul_plain(x, w), torch.bfloat16)


def _qkv(b, s, h, d, dtype, dev, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(b, s, h * d, generator=gen).to(dev, dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,d", [(8, 2, 16), (16, 12, 32), (24, 4, 16), (32, 12, 32),
                                   (40, 12, 32), (128, 4, 64), (512, 12, 32), (512, 16, 64),
                                   (1024, 2, 128), (16, 4, 96), (40, 4, 96), (512, 4, 96),
                                   (1024, 2, 96)])
def test_key_bias_kernel_matches_plain(dev, dtype, s, h, d):
    b = 3
    q, k, v = _qkv(b, s, h, d, dtype, dev)
    mask = torch.zeros(b, s, device=dev)
    mask[1, max(1, s // 3):] = MASK_BIAS
    mask[2, :] = MASK_BIAS  # every key padded
    got = flash_attention_bse(q, k, v, mask, h)
    _close(got, attention_bse_plain(q, k, v, mask, h, False), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,d", [(16, 4, 32), (24, 4, 16), (128, 4, 32), (512, 12, 32),
                                   (512, 16, 64), (1000, 2, 64), (1024, 2, 128), (32, 4, 96),
                                   (512, 4, 96), (1000, 2, 96)])
@pytest.mark.parametrize("ids", ["contiguous", "shuffled"])
def test_segment_kernel_matches_plain(dev, dtype, s, h, d, ids):
    """Contiguous segments with a -1 tail, or ids in no order with padding
    among them (the tensor-core body's tile and run skips must hold for
    both); row 1 all padding."""
    b = 2
    q, k, v = _qkv(b, s, h, d, dtype, dev, seed=1)
    rng = np.random.default_rng(s)
    seg = np.full((b, s), -1, np.int32)
    c, g = 0, 0
    while ids == "contiguous":
        n = int(rng.integers(1, 40))
        if c + n > s - 3:
            break
        seg[0, c:c + n] = g
        c, g = c + n, g + 1
    if ids == "shuffled":
        seg[0] = rng.integers(-1, 6, size=s)
    seg_t = torch.from_numpy(seg).to(dev)  # row 1: all padding
    got = flash_attention_packed_bse(q, k, v, seg_t, h)
    _close(got, attention_bse_plain(q, k, v, seg_t, h, True), dtype)


def test_attention_rejects_what_it_does_not_serve(dev):
    """d = 24 has no instance: "auto" takes the plain version, counted in
    `plain_routes` with no launch; "kernel" raises."""
    q, k, v = _qkv(1, 16, 2, 24, torch.bfloat16, dev)
    mask = torch.zeros(1, 16, device=dev)
    before = (flash_attention_bse.launches, flash_attention_bse.plain_routes)
    got = flash_attention_bse(q, k, v, mask, 2)
    assert (flash_attention_bse.launches, flash_attention_bse.plain_routes) == \
        (before[0], before[1] + 1)
    _close(got, attention_bse_plain(q, k, v, mask, 2, False), torch.bfloat16)
    with kernel_impls(attn="kernel"), pytest.raises(ValueError):
        flash_attention_bse(q, k, v, mask, 2)  # d = 24
    q, k, v = _qkv(1, 1032, 1, 32, torch.bfloat16, dev)
    with pytest.raises(ValueError):
        flash_attention_bse(q, k, v, torch.zeros(1, 1032, device=dev), 1)  # S > 1024


@pytest.mark.parametrize("qtype", ["Q4_0", "Q4_1", "Q8_0"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(64, 128, 128), (77, 1152, 768), (1, 32, 64),
                                   (200, 384, 100)])
def test_q4_matmul_prologue_matches_plain(dev, qtype, dtype, m, k, n):
    w = _weight(qtype, k, n, dev, seed=3)
    gen = torch.Generator(device="cpu").manual_seed(m + k)
    x, g = (torch.randn(m, k, generator=gen).to(dev, dtype) for _ in range(2))
    before = q4_matmul.launches
    got = q4_matmul(x, w, prologue_mul=g)
    assert q4_matmul.launches == before + 1
    _close(got, q4_matmul_plain(x, w, prologue_mul=g), dtype)


@pytest.mark.parametrize("qtype", ["Q4_0", "Q4_1", "Q8_0"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,act", [
    (1, 32, 64, "gelu_tanh"),              # one row, K = 32
    (37, 1024, 4096, "gelu_erf"),          # bge-large's up projection
    (16384 - 37, 4096, 1024, None),        # its down projection, ragged M
    (200, 256, 200, "silu"),               # N not a multiple of the slice
    (130, 2048, 1000, "gelu_erf"),
    (300, 96, 72, None),                   # K narrower than one x chunk
    (50, 1184, 256, "silu"),               # a last x chunk of 32 columns
    (65536, 4096, 1024, None),             # the corpus's packed plan at down
    (96, 8192, 256, "gelu_erf"),           # K = 8192: bf16 streams it
    (133, 1120, 200, "gelu_tanh"),         # K % 64 == 32 with N % 16 != 0
])
def test_n_tiled_kernel_matches_plain(dev, qtype, dtype, m, k, n, act):
    """K8 in bf16 at every edge of its 256 x 128 x 64 tile (K % 64 == 32,
    N % 16 != 0, N < 128, ragged M); in f32 at every slice width: K = 1024
    takes 32 columns, K = 2048 16, K = 4096 8.  K = 8192 is past every f32
    slice and is refused there."""
    w = _weight(qtype, k, n, dev, seed=4)
    gen = torch.Generator(device="cpu").manual_seed(m + k + n)
    x = torch.randn(m, k, generator=gen).to(dev, dtype)
    bias = torch.randn(n, generator=gen).to(dev) * 0.1
    if dtype == torch.float32 and k == 8192:
        with pytest.raises(RuntimeError, match="q4_matmul_2d_launch"):
            _q4_matmul_2d(x, w, bias, activation=act)
        return
    before = (q4_matmul.launches, q4_matmul.n_tiled_launches)
    got = _q4_matmul_2d(x, w, bias, activation=act)
    assert (q4_matmul.launches, q4_matmul.n_tiled_launches) == (before[0], before[1] + 1)
    assert got.dtype == dtype and got.shape == (m, n)
    _close(got, q4_matmul_plain(x, w, bias, act), dtype)


@pytest.mark.parametrize("qtype", ["Q4_0", "Q4_1", "Q8_0"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_n_tiled_prologue_and_out_f32(dev, qtype, dtype):
    w = _weight(qtype, 1024, 640, dev, seed=5)
    gen = torch.Generator(device="cpu").manual_seed(6)
    x, g = (torch.randn(100, 1024, generator=gen).to(dev, dtype) for _ in range(2))
    got = _q4_matmul_2d(x, w, None, g, activation="gelu_erf", out_f32=True)
    assert got.dtype == torch.float32
    ref = q4_matmul_plain(x, w, None, "gelu_erf", out_f32=True, prologue_mul=g)
    assert (got - ref).abs().max().item() <= (1e-4 if dtype == torch.float32 else 1e-3)


@pytest.mark.parametrize("prologue", [False, True])
def test_n_tiled_bf16_tile(dev, prologue):
    """K8's bf16 tile as the card runs it, with and without the prologue:
    256 x 128 outputs, 64-deep steps, three ring slots, at least one block
    per SM after the shared-memory opt-in."""
    t = tile(prologue)
    assert (t["bm"], t["bn"], t["bk"], t["stages"]) == (256, 128, 64, 3)
    assert t["blocks_per_sm"] >= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [512, 77])
def test_splade_decoder_shape_both_kernels_match_plain(dev, dtype, m):
    """SPLADE's decoder, the tied word table at N = 30522 (not a multiple
    of 128 or 16): `route` sends it to K1 (the JAX package's XLA shape);
    K8 forced at the same shape computes the same function."""
    k, n = 768, 30522
    w = _weight("Q4_0", k, n, dev, seed=m)
    gen = torch.Generator(device="cpu").manual_seed(m)
    x = torch.randn(m, k, generator=gen).to(dev, dtype)
    bias = torch.randn(n, generator=gen).to(dev) * 0.1
    assert route(m, k, n, GGMLType.Q4_0, dtype).kernel == "xla"
    ref = q4_matmul_plain(x, w, bias)
    before = (q4_matmul.launches, q4_matmul.n_tiled_launches)
    _close(q4_matmul(x, w, bias), ref, dtype)
    assert (q4_matmul.launches, q4_matmul.n_tiled_launches) == (before[0] + 1, before[1])
    _close(_q4_matmul_2d(x, w, bias), ref, dtype)


def test_q4_matmul_routes_bge_large_ffn_to_the_n_tiled_kernel(dev):
    """bf16 Q8_0 at 1024 -> 4096 takes K8; with the residual and the
    LayerNorm tail at 4096 -> 1024 K8 runs into f32 and the tail follows."""
    gen = torch.Generator(device="cpu").manual_seed(7)
    up, down = _weight("Q8_0", 1024, 4096, dev, seed=8), _weight("Q8_0", 4096, 1024, dev, seed=9)
    x = torch.randn(256, 1024, generator=gen).to(dev, torch.bfloat16)
    h = torch.randn(256, 4096, generator=gen).to(dev, torch.bfloat16)
    ln = (torch.ones(1024, device=dev), torch.zeros(1024, device=dev), 1e-12)
    before = (q4_matmul.launches, q4_matmul.n_tiled_launches)
    _close(q4_matmul(x, up, activation="gelu_erf"),
           q4_matmul_plain(x, up, activation="gelu_erf"), torch.bfloat16)
    _close(q4_matmul(h, down, residual=x, ln=ln),
           q4_matmul_plain(h, down, residual=x, ln=ln), torch.bfloat16)
    assert (q4_matmul.launches, q4_matmul.n_tiled_launches) == (before[0], before[1] + 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_n_tiled_slice_past_shared_memory_raises(dev, dtype):
    """f32: a slice the opt-in shared memory cannot hold is refused at
    launch and the wrapper raises; the refusal does not surface at the next
    launch.  bf16 streams K, so the same K = 8192 is served and matches the
    plain version."""
    w = _weight("Q8_0", 8192, 128, dev)
    x = torch.randn(64, 8192, device=dev).to(dtype)
    if dtype == torch.bfloat16:
        _close(_q4_matmul_2d(x, w), q4_matmul_plain(x, w), dtype)
    else:
        with pytest.raises(RuntimeError, match="q4_matmul_2d_launch"):
            _q4_matmul_2d(x, w)
    small = _weight("Q4_0", 128, 128, dev)
    x = torch.randn(64, 128, device=dev).to(dtype)
    _close(_q4_matmul_2d(x, small), q4_matmul_plain(x, small), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,qtype", [
    (16384 - 37, 1024, 1024, "Q8_0"), (77, 384, 384, "Q4_0"), (333, 768, 768, "Q4_1"),
    (16, 1024, 1000, "Q8_0"), (1, 64, 96, "Q4_0")])
@pytest.mark.parametrize("parts", ["residual+ln", "residual", "ln"])
def test_fused_epilogue_kernel_matches_plain(dev, dtype, m, k, n, qtype, parts):
    """K1's residual + LayerNorm epilogue: ragged M, N = 384 / 768 / 1024
    and N not a multiple of the 64-column sub-tile, bf16 and f32 residual."""
    w = _weight(qtype, k, n, dev, seed=10)
    gen = torch.Generator(device="cpu").manual_seed(m + n)
    x = torch.randn(m, k, generator=gen).to(dev, dtype)
    bias = torch.randn(n, generator=gen).to(dev) * 0.1
    kw = {}
    if "residual" in parts:
        kw["residual"] = torch.randn(m, n, generator=gen).to(dev, dtype)
    if "ln" in parts:
        kw["ln"] = (1 + 0.1 * torch.randn(n, generator=gen).to(dev),
                    0.1 * torch.randn(n, generator=gen).to(dev), 1e-12)
    before = (q4_matmul.launches, q4_matmul.ln_launches)
    got = _q4_matmul_1d(x, w, bias, activation="gelu_erf", **kw)
    assert (q4_matmul.launches, q4_matmul.ln_launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == (m, n)
    _close(got, q4_matmul_plain(x, w, bias, "gelu_erf", **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_epilogue_past_its_cap_raises(dev, dtype):
    """The row buffer caps N (about 3500 columns): N = 4096 is refused."""
    w = _weight("Q8_0", 256, 4096, dev)
    ln = (torch.ones(4096, device=dev), torch.zeros(4096, device=dev), 1e-5)
    with pytest.raises(RuntimeError, match="q4_matmul_ln_launch"):
        _q4_matmul_1d(torch.zeros(64, 256, device=dev, dtype=dtype), w, ln=ln)
    small = _weight("Q8_0", 128, 384, dev)
    x = torch.randn(32, 128, device=dev).to(dtype)
    ln = (torch.ones(384, device=dev), torch.zeros(384, device=dev), 1e-5)
    _close(_q4_matmul_1d(x, small, ln=ln), q4_matmul_plain(x, small, ln=ln), dtype)


def _pos_bias(ph, s, dev, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    pb = torch.randn(ph, s, s, generator=gen)
    pb[:, :, s // 2:] += MASK_BIAS * (torch.rand(ph, s, s - s // 2, generator=gen) < 0.3)
    return pb.to(dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,d", [(16, 4, 32), (24, 4, 32), (100, 2, 64), (512, 12, 64),
                                   (512, 16, 64), (1024, 2, 32), (1024, 2, 128)])
@pytest.mark.parametrize("per_head", [False, True])
def test_bias_kernels_match_plain(dev, dtype, s, h, d, per_head):
    """K4 plain and packed; the bias's middle row is -1e9 at every pair, so
    no skip of the packed form's is exact for that row's block."""
    b = 3
    q, k, v = _qkv(b, s, h, d, dtype, dev, seed=2)
    pb = _pos_bias(h if per_head else 1, s, dev)
    pb[:, s // 2, :] = MASK_BIAS
    mask = torch.zeros(b, s, device=dev)
    mask[1, max(1, s // 3):] = MASK_BIAS
    mask[2, :] = MASK_BIAS  # every key padded
    before = (flash_attention_bse.launches, flash_attention_bse.bias_launches)
    got = flash_attention_bias_bse(q, k, v, mask, pb, h)
    assert (flash_attention_bse.launches, flash_attention_bse.bias_launches) == (
        before[0], before[1] + 1)
    _close(got, attention_bse_plain(q, k, v, mask, h, False, pb), dtype)
    seg = torch.full((b, s), -1, dtype=torch.int32)
    seg[0, : s // 2], seg[0, s // 2 : s - 3] = 0, 1
    seg[1, :] = 0
    seg = seg.to(dev)  # row 2: all padding
    before = flash_attention_packed_bse.bias_launches
    got = flash_attention_bias_packed_bse(q, k, v, seg, pb, h)
    assert flash_attention_packed_bse.bias_launches == before + 1
    _close(got, attention_bse_plain(q, k, v, seg, h, True, pb), dtype)


def _long_qkv(b, s, h, d, dtype, dev, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=gen).to(dev, dtype) for _ in range(3)]


def _long_mask(b, s, dev):
    mask = torch.zeros(b, s, device=dev)
    mask[1, max(1, s // 3):] = MASK_BIAS
    mask[2, :] = MASK_BIAS  # every key padded
    return mask


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,d", [(100, 2, 32), (1025, 2, 64), (2048, 4, 64), (777, 3, 32)])
@pytest.mark.parametrize("bias", [None, 1, "h"])
def test_long_kernel_matches_plain(dev, dtype, s, h, d, bias):
    b = 3
    q, k, v = _long_qkv(b, s, h, d, dtype, dev, seed=s)
    mask = _long_mask(b, s, dev)
    pb = None if bias is None else _pos_bias(h if bias == "h" else 1, s, dev, seed=1)
    before = flash_attention.launches
    got = flash_attention(q, k, v, mask, pb)
    assert flash_attention.launches == before + 1
    _close(got, attention_long_plain(q, k, v, mask, pb), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,d,window", [(1024, 2, 32, 128), (1024, 2, 64, 16),
                                          (2048, 4, 64, 128), (4096, 2, 32, 128)])
def test_local_kernel_matches_plain_row_for_row(dev, dtype, s, h, d, window):
    b = 3
    q, k, v = _long_qkv(b, s, h, d, dtype, dev, seed=s + window)
    mask = _long_mask(b, s, dev)
    before = flash_attention_local.launches
    got = flash_attention_local(q, k, v, mask, window)
    assert flash_attention_local.launches == before + 1
    _close(got, attention_local_plain(q, k, v, mask, window), dtype)


def test_long_kernels_reject_what_they_do_not_serve(dev):
    q, k, v = _long_qkv(1, 1100, 2, 32, torch.bfloat16, dev)
    with pytest.raises(ValueError):  # S % 128 != 0: no window slice
        flash_attention_local(q, k, v, torch.zeros(1, 1100, device=dev), 128)
    q, k, v = _long_qkv(1, 64, 2, 24, torch.bfloat16, dev)
    before = flash_attention.plain_routes
    got = flash_attention(q, k, v, torch.zeros(1, 64, device=dev))  # d = 24: plain
    assert flash_attention.plain_routes == before + 1
    _close(got, attention_long_plain(q, k, v, torch.zeros(1, 64, device=dev)), torch.bfloat16)
    with kernel_impls(attn="kernel"), pytest.raises(ValueError):  # d = 24
        flash_attention(q, k, v, torch.zeros(1, 64, device=dev))
    q, k, v = _qkv(1, 128, 2, 32, torch.bfloat16, dev)
    with pytest.raises(ValueError):  # a [3, S, S] bias for 2 heads
        flash_attention_bias_bse(q, k, v, torch.zeros(1, 128, device=dev),
                                 torch.zeros(3, 128, 128, device=dev), 2)


def _packed_seg(b, s, max_len, dev, seed=0):
    """Row 0: segments of 1..max_len tokens, two ending on the 256-row
    tiles, then a padded tail; row 1 one segment over the whole row; the
    rest all padding."""
    rng = np.random.default_rng(seed)
    seg = np.full((b, s), -1, np.int32)
    c = g = 0
    while c < s - max_len - 24:
        n = int(rng.integers(1, max_len + 1))
        for edge in (256, 512):
            if c < edge < c + n:
                n = edge - c
        seg[0, c:c + n] = g
        c, g = c + n, g + 1
    seg[1, :min(s, max_len)] = 0
    return torch.from_numpy(seg).to(dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,d,max_seg_len", [
    (1024, 2, 64, 256), (1024, 2, 32, 64), (1152, 2, 32, 128), (2048, 4, 64, 512),
    (2048, 4, 64, None), (8192, 2, 64, 512), (8192, 1, 64, None), (200, 2, 16, None),
    (1024, 2, 128, None), (2048, 2, 16, 256)])
def test_packed_segment_kernel_matches_plain_row_for_row(dev, dtype, s, h, d, max_seg_len):
    b = 3
    q, k, v = _long_qkv(b, s, h, d, dtype, dev, seed=s + d)
    seg = _packed_seg(b, s, max_seg_len or 300, dev, seed=s)
    windowed = packed_window_tiles(s, max_seg_len)[1] is not None
    assert windowed == (max_seg_len is not None)
    before = (flash_attention_packed.launches, flash_attention_packed.window_launches)
    got = flash_attention_packed(q, k, v, seg, max_seg_len)
    assert (flash_attention_packed.launches, flash_attention_packed.window_launches) == (
        before[0] + (not windowed), before[1] + windowed)
    ref = (attention_packed_window_plain(q, k, v, seg, max_seg_len) if windowed
           else attention_packed_plain(q, k, v, seg))
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,max_seg_len", [(1024, 256), (2048, 512), (4096, 128)])
def test_packed_segment_forms_agree_on_real_rows(dev, dtype, s, max_seg_len):
    """A masked key adds exp(-1e9 - m) = 0, and the f32 path sums the keys
    in the same order in both forms: on real rows the windowed kernel
    equals the full one exactly in f32 (bf16 products group keys into
    other 16-key chunks: within tolerance)."""
    q, k, v = _long_qkv(2, s, 2, 64, dtype, dev, seed=s)
    seg = _packed_seg(2, s, max_seg_len, dev, seed=s + 1)
    full = flash_attention_packed(q, k, v, seg)
    window = flash_attention_packed(q, k, v, seg, max_seg_len)
    real = seg >= 0
    if dtype == torch.float32:
        assert torch.equal(window[real], full[real])
    else:
        _close(window[real], full[real], dtype)


def _shuffled_seg(b, s, dev, seed=0):
    """Ids in -1..5 in no order (non-contiguous segments, padding among
    them); the last row all padding."""
    seg = np.random.default_rng(seed).integers(-1, 6, size=(b, s)).astype(np.int32)
    seg[-1] = -1
    return torch.from_numpy(seg).to(dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,d,max_seg_len", [(1024, 64, 128), (2048, 32, 512), (2048, 64, None),
                                             (1152, 16, None)])
def test_packed_segment_kernel_on_shuffled_ids(dev, dtype, s, d, max_seg_len):
    """K6 on non-contiguous ids: a tile's id span covers ids its keys do not
    hold, so the skips must rest on spans, never on contiguity."""
    q, k, v = _long_qkv(3, s, 2, d, dtype, dev, seed=s + 3)
    seg = _shuffled_seg(3, s, dev, seed=s)
    got = flash_attention_packed(q, k, v, seg, max_seg_len)
    ref = (attention_packed_window_plain(q, k, v, seg, max_seg_len) if max_seg_len
           else attention_packed_plain(q, k, v, seg))
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("window", [16, 128])
def test_local_kernel_long_row_with_a_padded_row(dev, dtype, window):
    """K7 at S = 8192: a padded tail and a row all padding, whose blocks
    score the whole slice in both passes."""
    b, s = 3, 8192
    q, k, v = _long_qkv(b, s, 2, 64, dtype, dev, seed=window)
    mask = _long_mask(b, s, dev)
    _close(flash_attention_local(q, k, v, mask, window),
           attention_local_plain(q, k, v, mask, window), dtype)


def _seg_local(b, s, window, dev, seed=0):
    """Row 0: segments shorter and longer than the window (1 .. 3 windows)
    with a padded tail; row 1 one segment over the row but its last 17
    keys; the rest all padding."""
    rng = np.random.default_rng(seed)
    seg = np.full((b, s), -1, np.int32)
    c = g = 0
    while c < s - 40:
        n = int(rng.choice([rng.integers(1, window // 2), rng.integers(window, 3 * window)]))
        seg[0, c:c + n] = g
        c, g = c + n, g + 1
    seg[1, : s - 17] = 0
    return torch.from_numpy(seg).to(dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,d,window", [
    (1032, 2, 64, 128), (1100, 2, 64, 128), (1024, 2, 32, 16), (2048, 4, 64, 128),
    (8192, 2, 64, 128), (2048, 2, 128, 128), (1152, 2, 16, 64)])
def test_packed_local_kernel_matches_plain_row_for_row(dev, dtype, s, h, d, window):
    """Mode 3 against its plain version on every row (rows of S % 8 != 0
    run padded to a multiple of 8 in both)."""
    b = 3
    q, k, v = _long_qkv(b, s, h, d, dtype, dev, seed=s + d)
    seg = _seg_local(b, s, window, dev, seed=s)
    before = flash_attention_packed_local.launches
    got = flash_attention_packed_local(q, k, v, seg, window)
    assert flash_attention_packed_local.launches == before + 1
    _close(got, attention_packed_local_plain(q, k, v, seg, window) if s % 8 == 0
           else flash_attention_packed_local(q.cpu(), k.cpu(), v.cpu(), seg.cpu(), window),
           dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,window", [(2048, 128), (1032, 128)])
def test_packed_local_kernel_on_shuffled_ids(dev, dtype, s, window):
    """Mode 3 on non-contiguous ids: the span and window skips together."""
    q, k, v = _long_qkv(3, s, 2, 64, dtype, dev, seed=s + 5)
    seg = _shuffled_seg(3, s, dev, seed=s + 1)
    _close(flash_attention_packed_local(q, k, v, seg, window),
           attention_packed_local_plain(q, k, v, seg, window), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_packed_local_kernel_equals_the_window_where_one_segment_fills_the_row(dev, dtype):
    """One segment over every key: mode 3 is K7 with no padding, row for
    row (the same slices, the same masked keys)."""
    s, window = 2048, 128
    q, k, v = _long_qkv(2, s, 2, 64, dtype, dev, seed=11)
    seg = torch.zeros(2, s, dtype=torch.int32, device=dev)
    got = flash_attention_packed_local(q, k, v, seg, window)
    want = flash_attention_local(q, k, v, torch.zeros(2, s, device=dev), window)
    _close(got, want, dtype)


@pytest.mark.parametrize("tile", LONG_TILES)
@pytest.mark.parametrize("form", ["long", "long_bias", "local", "seg", "seg_window",
                                  "seg_local"])
@pytest.mark.parametrize("s,d", [(1024, 64), (2048, 32), (1152, 128)])
def test_long_kernel_query_tiles_match_plain(dev, tile, form, s, d):
    """Each query tile the bf16 body is built for, forced (`tile_q`), in
    every form: key bias, + a [1, S, S] bias, window 128, segments over
    every key and over the tile's slice."""
    b, h = 3, 2
    q, k, v = _long_qkv(b, s, h, d, torch.bfloat16, dev, seed=s + tile)
    mask = _long_mask(b, s, dev)
    seg = _packed_seg(b, s, 128, dev, seed=s)
    if form in ("long", "long_bias"):
        pb = _pos_bias(1, s, dev, seed=2) if form == "long_bias" else None
        got = _launch_long(q, k, v, mask, _FULL, pb, tile_q=tile)
        ref = attention_long_plain(q, k, v, mask, pb)
    elif form == "local":
        got = _launch_long(q, k, v, mask, _LOCAL, window=128, tile_q=tile)
        ref = attention_local_plain(q, k, v, mask, 128)
    elif form == "seg":
        got = _launch_long(q, k, v, seg, _SEG, tile_q=tile)
        ref = attention_packed_plain(q, k, v, seg)
    elif form == "seg_local":
        got = _launch_long(q, k, v, seg, _SEG_LOCAL, window=128, tile_q=tile)
        ref = attention_packed_local_plain(q, k, v, seg, 128)
    else:
        got = _launch_long(q, k, v, seg, _SEG, max_seg_len=128, tile_q=tile)
        ref = attention_packed_window_plain(q, k, v, seg, 128)
    _close(got, ref, torch.bfloat16)


def test_packed_segment_kernel_rejects_what_it_does_not_serve(dev):
    q, k, v = _long_qkv(2, 1100, 2, 32, torch.bfloat16, dev)
    seg = _packed_seg(2, 1100, 128, dev)
    # S % 8 != 0 is served padded to a multiple of 8: the same real rows
    got = flash_attention_packed(q, k, v, seg)
    real = seg >= 0
    _close(got[real], attention_packed_plain(q, k, v, seg)[real], torch.bfloat16)
    with pytest.raises(ValueError):  # window 0
        flash_attention_packed_local(q, k, v, seg, 0)
    q, k, v = _long_qkv(1, 1024, 2, 24, torch.bfloat16, dev)
    zeros = torch.zeros(1, 1024, dtype=torch.int32, device=dev)
    before = flash_attention_packed.plain_routes
    got = flash_attention_packed(q, k, v, zeros)  # d = 24: the plain version
    assert flash_attention_packed.plain_routes == before + 1
    _close(got, attention_packed_plain(q, k, v, zeros), torch.bfloat16)
    with kernel_impls(attn="kernel"), pytest.raises(ValueError):  # d = 24
        flash_attention_packed(q, k, v, zeros, 128)


def _deberta_inputs(b, s, h, d, span, dtype, dev, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, d, generator=gen).to(dev, dtype) for _ in range(3))
    pk, pq = (torch.randn(2 * span, h, d, generator=gen).to(dev, dtype) for _ in range(2))
    return q, k, v, pk, pq


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,d,span,max_dist", [(16, 2, 16, 32, 128), (48, 4, 32, 16, 64),
                                                 (128, 4, 64, 96, 192), (512, 12, 64, 256, 512),
                                                 (512, 2, 128, 32, 128),
                                                 # deberta-v3-base's heads at the short
                                                 # buckets, where the span exceeds S
                                                 (16, 12, 64, 256, 512), (32, 12, 64, 256, 512),
                                                 (64, 12, 64, 256, 512),
                                                 (128, 12, 64, 256, 512),
                                                 # S not a multiple of the bf16
                                                 # kernel's 64-row tile or 64-key chunk
                                                 (100, 12, 64, 256, 512),
                                                 (300, 12, 64, 256, 512),
                                                 (500, 12, 64, 256, 512),
                                                 (300, 4, 32, 96, 192), (100, 2, 16, 32, 128),
                                                 (200, 2, 128, 32, 128)])
def test_deberta_kernels_match_plain(dev, dtype, s, h, d, span, max_dist):
    b = 4
    q, k, v, pk, pq = _deberta_inputs(b, s, h, d, span, dtype, dev, seed=s + d)
    c2p, p2c = (torch.from_numpy(t.astype(np.int32)).to(dev)
                for t in delta_tables(s, span, max_dist))
    mask = _long_mask(b, s, dev)  # row 1 padded past S/3, row 2 all padding
    before = disentangled_attention.launches
    got = disentangled_attention(q, k, v, mask, pk, pq, span, max_dist)
    assert disentangled_attention.launches == before + 1
    _close(got, disentangled_attention_plain(q, k, v, mask, pk, pq, c2p, p2c, False), dtype)
    seg = torch.full((b, s), -1, dtype=torch.int32)
    seg[0, : s // 2], seg[0, s // 2 : s - 3] = 0, 1
    seg[1, :] = 0
    seg[3, :] = torch.arange(s) // 37  # segments crossing the 64-row tile boundaries
    seg = seg.to(dev)  # row 2: all padding
    before = disentangled_attention_packed.launches
    got = disentangled_attention_packed(q, k, v, seg, pk, pq, span, max_dist)
    assert disentangled_attention_packed.launches == before + 1
    _close(got, disentangled_attention_plain(q, k, v, seg, pk, pq, c2p, p2c, True), dtype)


def test_deberta_kernel_rejects_what_it_does_not_serve(dev):
    q, k, v, pk, pq = _deberta_inputs(1, 520, 2, 32, 32, torch.bfloat16, dev)
    with pytest.raises(ValueError):  # S > 512
        disentangled_attention(q, k, v, torch.zeros(1, 520, device=dev), pk, pq, 32, 128)
    q, k, v, pk, pq = _deberta_inputs(1, 64, 2, 24, 32, torch.bfloat16, dev)
    keyb = torch.zeros(1, 64, device=dev)
    before = (disentangled_attention.launches, disentangled_attention.plain_routes)
    got = disentangled_attention(q, k, v, keyb, pk, pq, 32, 128)  # d = 24: the plain version
    assert (disentangled_attention.launches, disentangled_attention.plain_routes) == \
        (before[0], before[1] + 1)
    c2p, p2c = (torch.from_numpy(t).to(dev) for t in delta_tables(64, 32, 128))
    _close(got, disentangled_attention_plain(q, k, v, keyb, pk, pq, c2p, p2c, False),
           torch.bfloat16)
    with kernel_impls(attn="kernel"), pytest.raises(ValueError):  # d = 24
        disentangled_attention(q, k, v, keyb, pk, pq, 32, 128)
    q, k, v, pk, pq = _deberta_inputs(1, 64, 2, 32, 32, torch.bfloat16, dev)
    with pytest.raises(ValueError):  # f32 tables beside bf16 q/k/v
        disentangled_attention(q, k, v, torch.zeros(1, 64, device=dev), pk.float(),
                               pq.float(), 32, 128)


# --- B1, the head-packed attention of the kernel suite -------------------------

@pytest.mark.parametrize("s,h,d,hb", [(512, 12, 32, 4), (512, 12, 64, 2), (100, 4, 32, 4),
                                      (77, 2, 32, 1), (130, 4, 64, 1), (65, 4, 32, 2),
                                      (1, 2, 64, 2), (300, 6, 64, 2)])
def test_headpack_kernel_matches_plain(dev, s, h, d, hb):
    b = 3
    gen = torch.Generator(device="cpu").manual_seed(s + h + d)
    q, k, v = (torch.randn(b, h, s, d, generator=gen).to(dev, torch.bfloat16)
               for _ in range(3))
    mask = _long_mask(b, s, dev)  # padding tails, one row all padding
    before = attention_headpack.launches
    got = attention_headpack(q, k, v, mask, hb)
    assert attention_headpack.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    _close(got, attention_headpack_plain(q, k, v, mask, hb), torch.bfloat16)


def test_headpack_kernel_rejects_what_it_does_not_serve(dev):
    q = torch.zeros(1, 4, 64, 32, device=dev, dtype=torch.bfloat16)
    bias = torch.zeros(1, 64, device=dev)
    for bad in (dict(hb=3), dict(hb=8)):  # hb not dividing H; packed width past 128
        with pytest.raises(ValueError):
            attention_headpack(q, q, q, bias, **bad)
    with pytest.raises(ValueError):  # f32
        attention_headpack(q.float(), q.float(), q.float(), bias, 4)
    q16 = torch.zeros(1, 4, 64, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # d = 16
        attention_headpack(q16, q16, q16, bias, 4)


def _min_cosine(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.min(np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                             * np.linalg.norm(b, axis=-1))))


@pytest.mark.parametrize("packing", ["always", "never"])
def test_engine_of_four_heads_of_96(dev, packing):
    """An Engine 384 wide with 4 heads (benchmarks/search.py's ingest
    model, two layers deep), Q4_0 in bf16: packed rows through K2 and plain
    buckets through K3 at d 96, no plain route, within cosine 0.999 of the
    port's f32 CPU path."""
    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import BertConfig, ComputeOptions

    config = BertConfig(n_vocab=1000, n_ctx=512, n_embd=384, n_layer=2, n_head=4, n_ff=1536)
    card = Engine.synthetic(config, "q4_0", device=dev, packing=packing,
                            opts=ComputeOptions(dtype="bfloat16"))
    cpu = Engine.synthetic(config, "q4_0", device="cpu", packing=packing)
    rng = np.random.default_rng(96)
    lists = [rng.integers(5, 1000, size=int(n)).tolist() for n in rng.integers(4, 120, 48)]
    fn = flash_attention_packed_bse if packing == "always" else flash_attention_bse
    before = (fn.launches, fn.plain_routes)
    got = card.embed_tokens(lists)
    torch.cuda.synchronize()
    assert fn.launches > before[0] and fn.plain_routes == before[1]
    assert _min_cosine(got, cpu.embed_tokens(lists)) >= 0.999


def test_engine_at_head_dim_24_takes_the_counted_plain_route(dev):
    """tiny-modernbert 48 wide with 2 heads of 24, packed "always" at 2048:
    no kernel has d 24, so each attention call takes its plain version on
    the card, counted, and the result is the CPU path's."""
    from dataclasses import replace

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.cli.make_test_model import PRESETS

    config = replace(PRESETS["tiny-modernbert"], n_embd=48, n_head=2, n_ctx=2048)
    kw = dict(packing="always", pack_seq=2048)
    card = Engine.synthetic(config, "f32", device=dev, **kw)
    cpu = Engine.synthetic(config, "f32", device="cpu", **kw)
    rng = np.random.default_rng(24)
    lists = [rng.integers(5, config.n_vocab, size=n).tolist() for n in (12, 700, 1500)]
    fns = (flash_attention_packed, flash_attention_packed_local)
    before = [(f.launches, f.plain_routes) for f in fns]
    got = card.embed_tokens(lists)
    torch.cuda.synchronize()
    for f, (launches, routes) in zip(fns, before):
        assert f.launches == launches and f.plain_routes > routes, f.__name__
    np.testing.assert_allclose(got, cpu.embed_tokens(lists), rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_lists", [2, 40], ids=["plain", "packed"])
def test_engine_refuses_ids_outside_the_vocab_and_keeps_serving(dev, n_lists):
    """An out-of-range id raises on the host before any launch, so the CUDA
    context survives (a gather past the table would fire a device-side
    assert) and the next call on the card is answered."""
    from dataclasses import replace

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import MINILM_L6

    eng = Engine.synthetic(replace(MINILM_L6, n_layer=1), "q4_0", device=dev)
    n = eng.config.n_vocab
    good = [[2, 7 + i, 3] for i in range(n_lists)]
    for bad in (n, -1, -n - 1):
        with pytest.raises(ValueError, match=f"token id {bad} outside 0..{n - 1}"):
            eng.embed_tokens(good[:-1] + [[2, bad, 3]])
    torch.cuda.synchronize()
    out = eng.embed_tokens(good)
    assert np.isfinite(out).all() and out.shape == (n_lists, eng.n_embd)


# --- the BERT-graph families: K1/K2/K3 inside their forwards ----------------------

def _family(name: str, n_layer: int = 2):
    """A family preset at its published width, `n_layer` deep, vocab cut to
    1000 (a gather: the cut removes bytes, not work)."""
    from dataclasses import replace

    from embedding_cpp_tpu_torch import models

    preset = {"xlmr": models.MULTILINGUAL_E5_BASE, "distilbert": models.MULTI_QA_DISTILBERT,
              "electra": models.MS_MARCO_ELECTRA_BASE, "electra-small": models.ELECTRA_SMALL,
              "xlmr-reranker": replace(models.MULTILINGUAL_E5_BASE, n_labels=1),
              "mpnet": models.MPNET_BASE, "mpnet-reranker": replace(models.MPNET_BASE, n_labels=1),
              "t5": models.GTR_BASE,
              "t5-gated": replace(models.GTR_BASE, n_ff=2048, ffn_act="gelu_tanh",
                                  ffn_gated=True),
              "albert": models.ALBERT_BASE,
              "albert-reranker": replace(models.ALBERT_BASE, n_labels=1)}[name]
    return replace(preset, n_vocab=1000, n_layer=n_layer)


@pytest.fixture()
def held_kernels(monkeypatch):
    """Routes every K1 and K2/K3/K4 call of a forward through a recorder
    that holds the kernel's output against its plain version on the same
    inputs; returns the per-kernel call counts (K4: the calls with a
    position bias)."""
    import embedding_cpp_tpu_torch.models.bert as bert
    import embedding_cpp_tpu_torch.models.t5 as t5
    import embedding_cpp_tpu_torch.ops.linear as linear

    calls = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

    def k1(x, w, bias=None, activation=None, prologue_mul=None):
        got = q4_matmul(x, w, bias=bias, activation=activation, prologue_mul=prologue_mul)
        _close(got, q4_matmul_plain(x, w, bias=bias, activation=activation,
                                    prologue_mul=prologue_mul), x.dtype)
        calls["K1"] += 1
        return got

    def k3(q, k, v, mask_bias, h, pos_bias=None):
        got = flash_attention_bse(q, k, v, mask_bias, h, pos_bias)
        _close(got, attention_bse_plain(q, k, v, mask_bias, h, False, pos_bias), q.dtype)
        calls["K3" if pos_bias is None else "K4"] += 1
        return got

    def k2(q, k, v, seg, h, pos_bias=None):
        got = flash_attention_packed_bse(q, k, v, seg, h, pos_bias)
        _close(got, attention_bse_plain(q, k, v, seg, h, True, pos_bias), q.dtype)
        calls["K2" if pos_bias is None else "K4"] += 1
        return got

    monkeypatch.setattr(linear, "q4_matmul", k1)
    for module in (bert, t5):
        monkeypatch.setattr(module, "flash_attention_bse", k3)
        monkeypatch.setattr(module, "flash_attention_packed_bse", k2)
    return calls


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
@pytest.mark.parametrize("name", ["xlmr", "distilbert", "electra", "electra-small", "mpnet",
                                  "t5", "t5-gated", "albert"])
def test_family_forward_holds_its_kernels(dev, held_kernels, name, packed, dtype):
    """Two layers (ALBERT: its one layer twice) at the published width,
    Q4_0: every K1 and K2/K3/K4 call of the forward within its tolerance of
    the plain version, six K1 (seven with a gated FFN) and one attention
    call a layer (K4 under MPNet's and T5's relative bias), and the output
    against the CPU path's."""
    from embedding_cpp_tpu_torch.benchmarks.profiles import serving_segments
    from embedding_cpp_tpu_torch.models import ComputeOptions, random_params
    from embedding_cpp_tpu_torch.models.bert import bert_embed_batch, bert_embed_packed

    config = _family(name)
    opts = ComputeOptions(dtype=dtype)
    params = random_params(config, "q4_0", seed=1, dense_dtype=opts.tdtype)
    rng = np.random.default_rng(2)
    if packed:
        seg, pos = serving_segments(rng, 4, 512)
        ids = rng.integers(4, config.n_vocab, (4, 512)).astype(np.int32)
        ids[seg < 0] = 0
        args = [torch.from_numpy(a) for a in (ids, seg, pos)]

        def run(p, device):
            return bert_embed_packed(p, *(a.to(device) for a in args), config, opts, n_seg=64)
    else:
        ids = rng.integers(4, config.n_vocab, (4, 128)).astype(np.int32)
        mask = (np.arange(128)[None] < np.array([128, 77, 5, 1])[:, None]).astype(np.int32)
        args = [torch.from_numpy(a) for a in (ids, mask)]

        def run(p, device):
            return bert_embed_batch(p, *(a.to(device) for a in args), config, opts)

    from embedding_cpp_tpu_torch.models.params import params_to

    got = run(params_to(params, dev), dev).float().cpu()
    biased = config.arch in ("mpnet", "t5")
    assert held_kernels == {"K1": (6 + config.ffn_gated) * 2,
                            "K2": 2 * (packed and not biased),
                            "K3": 2 * (not packed and not biased), "K4": 2 * biased}
    want = run(params, "cpu").float()
    real = want.norm(dim=-1) > 0
    cos = torch.nn.functional.cosine_similarity(got[real], want[real], dim=-1)
    assert torch.isfinite(got).all() and cos.min() >= (0.99999 if dtype == "float32" else 0.999)


@pytest.mark.parametrize("name", ["xlmr-reranker", "electra", "mpnet-reranker",
                                  "albert-reranker"])
def test_family_score_holds_its_kernels(dev, held_kernels, name):
    """The cross-encoder path (K3, or K4 under MPNet's bias, over the pairs'
    bucket, then the f32 head) against the CPU path; RoBERTa's single
    token-type row, MPNet's none."""
    from embedding_cpp_tpu_torch.models import ComputeOptions, random_params
    from embedding_cpp_tpu_torch.models.bert import bert_score_batch
    from embedding_cpp_tpu_torch.models.params import params_to

    config = _family(name)
    opts = ComputeOptions(dtype="bfloat16")
    params = random_params(config, "q4_0", seed=3, dense_dtype=torch.bfloat16)
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(4, config.n_vocab, (16, 64)).astype(np.int32))
    mask = torch.from_numpy((np.arange(64)[None] < rng.integers(8, 65, (16, 1))).astype(np.int32))
    types = torch.zeros_like(ids) if config.n_token_types <= 1 else (
        (torch.arange(64)[None] >= 20).to(torch.int32) * mask)
    got = bert_score_batch(params_to(params, dev), ids.to(dev), mask.to(dev), config, opts,
                           type_ids=types.to(dev)).cpu()
    biased = config.arch == "mpnet"
    assert held_kernels == {"K1": 12, "K2": 0, "K3": 2 * (not biased), "K4": 2 * biased}
    want = bert_score_batch(params, ids, mask, config, opts, type_ids=types)
    assert got.shape == (16, 1) and torch.isfinite(got).all()
    # chip_smoke.py's bar for the card's bf16 logits against the CPU's bf16 path
    assert (got - want).abs().max().item() <= 0.015


def test_electra_small_factorized_embedding(dev):
    """ELECTRA-small's 128-wide tables, their LayerNorm and the dense
    128 -> 256 projection on the card, against the CPU path."""
    from embedding_cpp_tpu_torch.models import ComputeOptions, random_params
    from embedding_cpp_tpu_torch.models.bert import embed_tokens
    from embedding_cpp_tpu_torch.models.params import params_to

    config = _family("electra-small")
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        4, config.n_vocab, (8, 512)).astype(np.int32))
    for dtype in ("float32", "bfloat16"):
        opts = ComputeOptions(dtype=dtype)
        params = random_params(config, "q4_0", seed=6, dense_dtype=opts.tdtype)
        assert params["embeddings"]["emb_proj_w"].shape == (128, 256)
        got = embed_tokens(params_to(params, dev), ids.to(dev), config, opts).cpu()
        want = embed_tokens(params, ids, config, opts)
        assert got.shape == (8, 512, 256) and got.dtype == opts.tdtype
        _close(got, want, opts.tdtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("packed,b,s", [(False, 2048, 16), (False, 512, 16), (False, 512, 32),
                                        (False, 96, 64), (False, 32, 512), (True, 128, 512),
                                        (True, 64, 128)])
def test_relative_bias_kernel_at_the_relpos_shapes(dev, dtype, packed, b, s):
    """K4 at 12 heads of 64 with MPNet's / T5's bucketed [12, S, S] bias
    (PH = H, built by `rel_attn_bias` on the card) at the corpus's plain
    buckets (S <= 32: several batch rows a block), the [32, 512] forward
    and the packed rows, against its plain version."""
    from embedding_cpp_tpu_torch.benchmarks.profiles import serving_segments
    from embedding_cpp_tpu_torch.models.bert import rel_attn_bias

    h, d = 12, 64
    gen = torch.Generator(device="cpu").manual_seed(s)
    table = (torch.randn(32, h, generator=gen) * 3).to(dev)
    pb = rel_attn_bias(table, s)
    assert pb.shape == (h, s, s) and pb.is_contiguous()
    q, k, v = _qkv(b, s, h, d, dtype, dev, seed=s)
    rng = np.random.default_rng(b)
    if packed:
        mask = torch.from_numpy(serving_segments(rng, b, s)[0]).to(dev)
        got = flash_attention_bias_packed_bse(q, k, v, mask, pb, h)
    else:
        lens = torch.from_numpy(rng.integers(1, s + 1, size=b))
        mask = torch.where(torch.arange(s)[None] < lens[:, None], 0.0, MASK_BIAS).to(dev)
        got = flash_attention_bias_bse(q, k, v, mask, pb, h)
    _close(got, attention_bse_plain(q, k, v, mask, h, packed, pb), dtype)


# --- the retrieval indexes: each on the card against its CPU path -------------

def _index_engines(dev, **config_kw):
    """One small f32 MiniLM-shaped engine's weights on the card and on the
    CPU (the card's f32 path runs the kernels; the CPU their plain
    versions)."""
    from dataclasses import replace

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import MINILM_L6

    config = replace(MINILM_L6, n_vocab=1000, n_layer=2, **config_kw)
    card = Engine.synthetic(config, "q4_0", device=dev)
    cpu = Engine(card.params, config, card.tokenizer, card.special_ids, device="cpu")
    return card, cpu


INDEX_TEXTS = [f"sentence number {i} about topic {i % 7} and more words" for i in range(60)]
INDEX_QUERIES = ["sentence about topic 3", "totally different words here", INDEX_TEXTS[5]]


@pytest.mark.parametrize("shape", [(3, 300, 7), (64, 4096, 10), (5, 70000, 100)])
def test_select_topk_on_the_card_equals_the_cpu(dev, shape):
    """Ties (equal columns, rounded rows, zeros, -0.0, -inf) keep the lower
    index on the card as on the CPU."""
    from embedding_cpp_tpu_torch.runtime.search import select_topk

    q, n, k = shape
    rng = np.random.default_rng(n)
    x = rng.normal(size=(q, n)).astype(np.float32)
    x[:, 5] = x[:, n // 2]
    x[:, 7], x[:, 8], x[:, 9] = 0.0, -0.0, -np.inf
    x[1] = np.round(x[1])
    x[-1] = 0.0
    s, i = select_topk(torch.from_numpy(x).to(dev), k)
    s_cpu, i_cpu = select_topk(torch.from_numpy(x), k)
    assert torch.equal(i.cpu(), i_cpu) and torch.equal(s.cpu(), s_cpu)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vector_index_on_the_card_equals_the_cpu(dev, dtype):
    """Device ingest of texts (K1 / K2 / K3) and add_vectors: the same ids
    as the CPU index, scores at the f32 bar (bf16: exact products summed in
    f32 by cuBLAS, 1e-5); the corpus stays on the card; an f32 search under
    the TF32 setting still matches an f64 brute force."""
    from embedding_cpp_tpu_torch.runtime.search import VectorIndex

    card, cpu = _index_engines(dev)
    a, b = VectorIndex(card, dtype=dtype), VectorIndex(cpu, dtype=dtype)
    a.add(INDEX_TEXTS)
    b.add(INDEX_TEXTS)
    assert a._rows.bufs[0]["vectors"].device.type == "cuda"
    (ia, sa), (ib, sb) = a.search(INDEX_QUERIES, 8), b.search(INDEX_QUERIES, 8)
    assert ia[2, 0] == ib[2, 0] == 5
    np.testing.assert_allclose(sa, sb, rtol=0, atol=1e-3 if dtype == "bfloat16" else 1e-4)
    rng = np.random.default_rng(0)
    v = rng.normal(size=(3000, card.n_embd)).astype(np.float32)
    v[[100, 2000]] = v[7]
    q = np.concatenate([v[7:8], rng.normal(size=(15, card.n_embd)).astype(np.float32)])
    a, b = VectorIndex(card, dtype=dtype), VectorIndex(cpu, dtype=dtype)
    a.add_vectors(v)
    b.add_vectors(v)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        (ia, sa), (ib, sb) = a.search_vectors(q, 10), b.search_vectors(q, 10)
    finally:
        torch.set_float32_matmul_precision(prev)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(sa, sb, rtol=0, atol=1e-5)
    assert ia[0, :3].tolist() == [7, 100, 2000]
    if dtype == "float32":
        vn = v / np.linalg.norm(v, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        want = np.sort(qn.astype(np.float64) @ vn.T.astype(np.float64), axis=1)[:, ::-1][:, :10]
        np.testing.assert_allclose(sa, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("candidates", [None, 40, 3000])
def test_sparse_index_on_the_card_equals_the_host_backend(dev, candidates):
    from embedding_cpp_tpu_torch.runtime.sparse_search import SparseIndex

    rng = np.random.default_rng(1)
    docs = []
    for _ in range(3000):
        nnz = int(rng.integers(10, 200))
        idx = rng.choice(30522, nnz, replace=False).astype(np.int32)
        docs.append((idx, rng.random(nnz).astype(np.float32)))
    queries = [docs[11]] + [(rng.choice(30522, 40, replace=False).astype(np.int32),
                             rng.random(40).astype(np.float32)) for _ in range(15)]
    card, cpu, host = (SparseIndex(device=dev), SparseIndex(device="cpu"),
                       SparseIndex(device=False))
    for index in (card, cpu, host):
        index.add_vectors(docs)
    assert card._rows.bufs[0]["idx"].device.type == "cuda"
    ia, sa = card.search_vectors(queries, 10, candidates=candidates)
    ib, sb = cpu.search_vectors(queries, 10, candidates=candidates)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(sa, sb, rtol=1e-5)
    ih, sh = host.search_vectors(queries, 10)
    if candidates in (None, 3000):
        np.testing.assert_array_equal(ia, ih)
        np.testing.assert_allclose(sa, sh, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxsim_index_on_the_card_equals_the_cpu(dev, dtype):
    """add() through token_states_device on the card and add_token_vectors;
    exact and candidates (C = n equals exact); the f32 index's scores equal
    Engine.maxsim's."""
    from embedding_cpp_tpu_torch.runtime.maxsim_search import MaxSimIndex

    card, cpu = _index_engines(dev)
    a, b = MaxSimIndex(card, dtype=dtype, doc_maxlen=32), MaxSimIndex(cpu, dtype=dtype,
                                                                       doc_maxlen=32)
    a.add(INDEX_TEXTS)
    b.add(INDEX_TEXTS)
    assert all(t.device.type == "cuda" for t in a._rows.bufs[0].values())
    (ia, sa), (ib, sb) = a.search(INDEX_QUERIES, 6), b.search(INDEX_QUERIES, 6)
    assert ia[2, 0] == ib[2, 0] == 5
    np.testing.assert_allclose(sa, sb, rtol=1e-3 if dtype == "bfloat16" else 1e-4)
    if dtype == "float32":
        ids, scores = a.search(INDEX_QUERIES[:1], 60)
        want = card.maxsim(INDEX_QUERIES[0], INDEX_TEXTS)
        np.testing.assert_allclose(scores[0], want[ids[0]], rtol=1e-5)
    rng = np.random.default_rng(2)
    states = [rng.normal(size=(int(rng.integers(3, 40)), 384)).astype(np.float32)
              for _ in range(500)]
    states[300] = states[9]
    a, b = MaxSimIndex(card, dtype=dtype, doc_maxlen=32), MaxSimIndex(cpu, dtype=dtype,
                                                                       doc_maxlen=32)
    a.add_token_vectors(states)
    b.add_token_vectors(states)
    qs = [states[9][:6]] + [rng.normal(size=(32, 384)).astype(np.float32) for _ in range(7)]
    for c in (None, 50, 500):
        (ia, sa), (ib, sb) = (a.search_token_vectors(qs, 10, candidates=c),
                              b.search_token_vectors(qs, 10, candidates=c))
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(sa, sb, rtol=1e-5)
    assert ia[0, :2].tolist() == [9, 300]
    np.testing.assert_array_equal(a.search_token_vectors(qs, 10, candidates=500)[0],
                                  a.search_token_vectors(qs, 10)[0])


# --- the model-format path and the Engine's switches on the card -----------------

def _minilm_file(tmp_path, ftype: str = "q4_0"):
    """A port-written GGUF of MiniLM-L6's width, two layers deep, from
    `random_state_dict(config, 0)`: the weights `Engine.synthetic` makes."""
    from dataclasses import replace

    from embedding_cpp_tpu_torch.models import MINILM_L6
    from embedding_cpp_tpu_torch.models.convert import FTYPE_NAMES, write_bert_gguf
    from embedding_cpp_tpu_torch.models.params import random_state_dict
    from embedding_cpp_tpu_torch.tokenizer.testvocab import build_tokenizer_json

    config = replace(MINILM_L6, n_vocab=1000, n_layer=2, name="minilm-2")
    path = tmp_path / f"minilm-{ftype}.gguf"
    write_bert_gguf(path, config, random_state_dict(config, 0),
                    build_tokenizer_json(config.n_vocab), FTYPE_NAMES[ftype])
    return str(path), config


def _leaves(params: dict, prefix: str = ""):
    from embedding_cpp_tpu_torch.ops.qtensor import QTensor

    for k, v in params.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        elif isinstance(v, QTensor):
            for f in ("qs", "scales", "mins"):
                if getattr(v, f) is not None:
                    yield f"{prefix}{k}.{f}", getattr(v, f)
        else:
            yield prefix + k, v


_SENTENCES = [" ".join(["the quick brown fox", "jumps over", "the lazy dog"][: 1 + i % 3])
              + f" {i}" for i in range(48)]


@pytest.mark.parametrize("ftype", ["q4_0", "q8_0", "f16"])
def test_from_gguf_on_the_card_equals_synthetic(dev, tmp_path, ftype):
    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import ComputeOptions

    path, config = _minilm_file(tmp_path, ftype)
    opts = ComputeOptions(dtype="bfloat16")
    loaded = Engine.from_gguf(path, opts=opts, device=dev)
    made = Engine.synthetic(config, ftype, seed=0, opts=opts, device=dev)
    a, b = dict(_leaves(loaded.params)), dict(_leaves(made.params))
    assert sorted(a) == sorted(b)
    assert all(a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
    np.testing.assert_array_equal(loaded.encode(_SENTENCES), made.encode(_SENTENCES))


@pytest.mark.parametrize("output_dtype,bar", [("float16", 1e-3), ("bfloat16", 8e-3)])
def test_output_dtypes_on_the_card(dev, tmp_path, output_dtype, bar):
    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import ComputeOptions

    path, _ = _minilm_file(tmp_path)
    f32 = Engine.from_gguf(path, opts=ComputeOptions(dtype="bfloat16"), device=dev)
    half = Engine(f32.params, f32.config, f32.tokenizer, f32.special_ids, device=dev,
                  opts=ComputeOptions(dtype="bfloat16", output_dtype=output_dtype))
    ref, got = f32.encode(_SENTENCES), half.encode(_SENTENCES)
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= bar


@pytest.mark.parametrize("q4_impl,attn_impl", [("plain", "auto"), ("auto", "plain"),
                                               ("plain", "plain")])
@pytest.mark.parametrize("packing", ["auto", "never"])
def test_plain_switches_launch_no_kernel(dev, tmp_path, q4_impl, attn_impl, packing):
    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import ComputeOptions
    from embedding_cpp_tpu_torch.ops import attention as A

    path, _ = _minilm_file(tmp_path)
    auto = Engine.from_gguf(path, opts=ComputeOptions(dtype="bfloat16"), device=dev,
                            packing=packing)
    plain = Engine(auto.params, auto.config, auto.tokenizer, auto.special_ids, device=dev,
                   packing=packing, opts=ComputeOptions(dtype="bfloat16", q4_impl=q4_impl,
                                                        attn_impl=attn_impl))
    ref = auto.encode(_SENTENCES)
    counters = [(q4_matmul, "launches"), (A.flash_attention_bse, "launches"),
                (A.flash_attention_packed_bse, "launches")]
    before = [getattr(f, n) for f, n in counters]
    got = plain.encode(_SENTENCES)
    torch.cuda.synchronize()
    delta = [getattr(f, n) - b for (f, n), b in zip(counters, before)]
    assert (delta[0] == 0) == (q4_impl == "plain") and delta[0] >= 0
    assert (sum(delta[1:]) == 0) == (attn_impl == "plain")
    cos = np.sum(got * ref, -1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert cos.min() >= 0.999


def test_dequant_weight_mode_launches_no_k1(dev, tmp_path):
    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import ComputeOptions

    path, _ = _minilm_file(tmp_path)
    opts = ComputeOptions(dtype="bfloat16")
    dense = Engine.from_gguf(path, opts=opts, device=dev, weight_mode="dequant")
    before = q4_matmul.launches
    got = dense.encode(_SENTENCES)
    torch.cuda.synchronize()
    assert q4_matmul.launches == before
    ref = Engine.from_gguf(path, opts=opts, device=dev).encode(_SENTENCES)
    assert (np.sum(got * ref, -1)).min() >= 0.999
