"""Kernel A/B suite on the GPU: each hand-written kernel of the port against
one PyTorch library call that computes the same function, at the shapes of
the JAX package's suite (`benchmarks/kernels.py`); the port never calls
the library calls.

    python -m embedding_cpp_tpu_torch.benchmarks.kernels [--m 512 4096 32768] [--out FILE]

Times are CUDA-event medians (`utils/profiling.gpu_ms`); the layout
permutes and the library calls' masks are built outside the timed region.
Each entry holds `kernel` and `library` (in place of the JAX suite's
`pallas` and `xla`), each with `us`, `tflops` and `bound_us`, the least
time the card could take for the function (`utils/profiling.bound_ms`:
each input read once, each output written once, the card's published
peaks).  The last line of standard output is one JSON object with a
`device` entry (the card's name and power limit from nvidia-smi).

`bench_k8_ffn` runs K8, the N-tiled dequant-GEMM, at bge-large-en-v1.5's
FFN (Q8_0, M = 16384): each projection alone, as the route gives it to
K8, against torch.addmm on the dequantized weight (+ gelu).
`bench_k1_layers` runs K1 at each model's linears of one layer (M =
16384, bf16, the main path's qtype, `K1_LAYERS`) beside torch.mm /
torch.addmm on the dequantized weight (+ the activation, x * g outside
the kernel for a prologue) and the bound, summed per layer.
`bench_k1_tiles` forces each of K1's bf16 tile instances (`TC_TILES`) at
every distinct K1 shape of those layers over several M, beside the one
`k1_tile` picks: the times its rule is decided from.  `--only` runs the
named sections alone (e.g. `--only k8_ffn k1_layers`).

`bench_bse` runs the projection-layout kernel (K2, K3, K4 plain and
packed with PH = 1 and H) at every model's heads at [32, 512], K3 at
MiniLM-L6's short plain buckets, and K4 with MPNet's / T5's bucketed
per-head bias at [2048, 16], [512, 32] and [32, 512], the shapes its A/B
is held to.
`bench_long` runs the long-row body (K5, K5 with a [1, S, S] bias, K6b,
K6a, K7) at the main paths' shapes, at the source's query-tile rule and
with each query tile forced: the times the rule is decided from.
`bench_attention_headpack` runs B1, the head-packed attention of the JAX
suite's bench of that name (`ops/attention.attention_headpack`, kernel
`csrc/attention_headpack.cu`).  No model path runs B1: it measures
whether packing heads into one wide product pays on the card's tensor
cores.

The full-forward modes of the JAX suite each time a whole forward of a
preset (random weights, seed 0, bf16) with a family of kernels on and off
(`q4_impl` / `attn_impl`, ops/dispatch.py: "kernel" against "plain", where
the JAX suite set "pallas" against "xla"), in ms and tokens/s, and the
largest difference of the two outputs:
    --forward-only   q4_impl, q4_0 MiniLM-L6 at [32, 512] and [128, 128]
    --mpnet-forward  attn_impl, MPNet at [32, 512]
    --bias-ab        K4 against SDPA at [32, 512, 12x64], then attn_impl for
                     mpnet-base and gtr-base at [32, 512] and modernbert-base
                     at [32, 512] and [8, 1024]
    --nomic-ab       attn_impl, nomic-embed-text at [32, 512] and [1, 8192]
    --deberta-ab     K9 against SDPA, then attn_impl for deberta-base at
                     [32, 512] and [32, 256]
The attn_impl forwards keep dense bf16 weights (`random_params` at f32, as
the JAX suite's), so the two arms differ in the attention alone.  These
modes also run on the CPU (`--device cpu`, where the two arms are "auto"
and "plain", both the plain versions: the run checks the code path, not a
speed), cut with `--layers`, `--vocab` and `--shape`; a kernel-against-
library entry runs on the card only.  Without `--device` every mode needs
a card.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..gguf import GGMLType
from ..gguf.quant import quantize
from ..ops import qtensor as tqt
from ..ops.attention import (
    attention_headpack,
    attention_headpack_plain,
    flash_attention,
    flash_attention_bse,
    flash_attention_local,
    flash_attention_packed,
    flash_attention_packed_bse,
)
from ..ops.deberta_attention import (
    delta_tables,
    disentangled_attention,
    disentangled_scores_plain,
)
from ..ops.deberta_attention import work as deberta_work
from ..ops.q4_matmul import _q4_matmul_1d, _q4_matmul_2d, dequant_weight, q4_matmul, route
from ..utils.profiling import bound_ms, device_block, device_ms, gpu_ms, peaks_for
from .profiles import packed_rows, segment_pairs, serving_segments

# --- the A/B suite -------------------------------------------------------------

def _timed(fn, nbytes: float, flops: float, peaks, **kw) -> dict:
    """{us, tflops, bound_us} of one call on the card."""
    ms = gpu_ms(fn, **kw)
    return {"us": ms * 1e3, "tflops": flops / ms / 1e9,
            "bound_us": bound_ms(nbytes, flops, peaks)[0] * 1e3}


def _weight(qtype: str, k: int, n: int, scale: float, rng, dev):
    """A random [k, n] weight (rows drawn as [n, k], the GGUF layout)
    packed as `qtype` on the card, and its dequantized bf16 [k, n]."""
    w_np = (rng.normal(size=(n, k)) * scale).astype(np.float32)
    raw = quantize(w_np, GGMLType[qtype])
    w = (tqt.pack_q8_matmul(raw, (n, k)) if qtype == "Q8_0"
         else tqt.pack_q4_matmul(raw, (n, k), GGMLType[qtype]))
    w = w.map(lambda t: t.to(dev))
    return w, dequant_weight(w, torch.bfloat16)


def _weight_bytes(w) -> int:
    return sum(t.numel() * t.element_size() for t in (w.qs, w.scales, w.mins) if t is not None)


def _ffn_pair(m: int, e: int, f: int, weight_scale: float, qtype: str = "Q4_0"):
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    up, up_d = _weight(qtype, e, f, weight_scale, rng, dev)
    dn, dn_d = _weight(qtype, f, e, weight_scale, rng, dev)
    x = torch.from_numpy(rng.normal(size=(m, e))).to(dev, torch.bfloat16)
    nbytes = 2 * m * e * 2 + _weight_bytes(up) + _weight_bytes(dn)
    return up, up_d, dn, dn_d, x, nbytes, 4.0 * m * e * f


def bench_q4_ffn(m: int, peaks, e: int = 384, f: int = 1536) -> dict:
    """The FFN pair up then down with nothing between (weights scaled so the
    activations stay finite): K1 twice against torch.mm on the dequantized
    weights."""
    up, up_d, dn, dn_d, x, nbytes, flops = _ffn_pair(m, e, f, 2e-2)
    return {"kernel": _timed(lambda: q4_matmul(q4_matmul(x, up), dn), nbytes, flops, peaks),
            "library": _timed(lambda: torch.mm(torch.mm(x, up_d), dn_d), nbytes, flops, peaks),
            "route": [route(m, e, f, up.qtype, x.dtype).kernel,
                      route(m, f, e, dn.qtype, x.dtype).kernel]}


def bench_q4_epilogue(m: int, peaks, e: int = 384, f: int = 1536) -> dict:
    """The same pair with a `* 1e-3` between and after the products, in the
    four combinations of K1 (k) and torch.mm (l) for up and down."""
    up, up_d, dn, dn_d, x, nbytes, flops = _ffn_pair(m, e, f, 1.0)
    mm = {"k": lambda a, w, wd: q4_matmul(a, w), "l": lambda a, w, wd: torch.mm(a, wd)}
    out = {}
    for a in "kl":
        for b in "kl":
            def fn(a=a, b=b):
                h = mm[a](x, up, up_d) * 1e-3
                return mm[b](h, dn, dn_d) * 1e-3
            out[a + b] = _timed(fn, nbytes, flops, peaks, samples=10)
    return out


def bench_q4_fused_epilogue(m: int, peaks, e: int = 384, f: int = 1536,
                            qtype: str = "Q4_0") -> dict:
    """The FFN with its real epilogues, y = gelu(x @ W_up + b_up) @ W_dn +
    b_dn: K1 with bias and gelu in its epilogue against torch.addmm on the
    dequantized weights (+ gelu)."""
    up, up_d, dn, dn_d, x, nbytes, flops = _ffn_pair(m, e, f, 2e-2, qtype)
    rng = np.random.default_rng(7)
    b_up = torch.from_numpy(rng.normal(size=(f,)) * 1e-2).to(x.device, torch.float32)
    b_dn = torch.from_numpy(rng.normal(size=(e,)) * 1e-2).to(x.device, torch.float32)
    bu, bd = b_up.to(x.dtype), b_dn.to(x.dtype)
    nbytes += (e + f) * 4

    def kernel():
        return q4_matmul(q4_matmul(x, up, bias=b_up, activation="gelu_erf"), dn, bias=b_dn)

    def library():
        return torch.addmm(bd, F.gelu(torch.addmm(bu, x, up_d)), dn_d)
    return {"kernel": _timed(kernel, nbytes, flops, peaks),
            "library": _timed(library, nbytes, flops, peaks)}


def bench_k8_ffn(peaks, m: int = 16384, e: int = 1024, f: int = 4096) -> dict:
    """K8 at bge-large's FFN, each projection with its bias (and gelu_erf
    on up) against torch.addmm on the dequantized weight (+ gelu)."""
    up, up_d, dn, dn_d, x, _, _ = _ffn_pair(m, e, f, 2e-2, "Q8_0")
    rng = np.random.default_rng(7)
    h = torch.from_numpy(rng.normal(size=(m, f))).to(x.device, torch.bfloat16)
    out = {}
    for name, a, w, wd, act in (("up", x, up, up_d, "gelu_erf"), ("down", h, dn, dn_d, None)):
        k, n = w.shape
        b = torch.from_numpy(rng.normal(size=(n,)) * 1e-2).to(x.device, torch.float32)
        bb = b.to(a.dtype)
        nbytes = m * k * 2 + _weight_bytes(w) + n * 4 + m * n * 2
        flops = 2.0 * m * k * n

        def kernel(a=a, w=w, b=b, act=act):
            return _q4_matmul_2d(a, w, b, activation=act)

        def library(a=a, wd=wd, bb=bb, act=act):
            y = torch.addmm(bb, a, wd)
            return F.gelu(y) if act else y
        out[name] = {"kernel": _timed(kernel, nbytes, flops, peaks),
                     "library": _timed(library, nbytes, flops, peaks),
                     "route": route(m, k, n, w.qtype, a.dtype).kernel}
    return out


# Each model's K1 linears of one layer: (main-path qtype, bias, [(name, K, N,
# activation, launches per layer, prologue)]).  DeBERTa also projects its
# 512-row relative table through q and k in every layer (K1_TABLE).
K1_LAYERS = {
    "minilm-l6": ("Q4_0", True, [("qkvo", 384, 384, None, 4, False),
                                 ("up", 384, 1536, "gelu_erf", 1, False),
                                 ("down", 1536, 384, None, 1, False)]),
    "modernbert-base": ("Q4_0", False, [("qkvo", 768, 768, None, 4, False),
                                        ("up", 768, 1152, "gelu_erf", 1, False),
                                        ("gate", 768, 1152, None, 1, False),
                                        ("down", 1152, 768, None, 1, True)]),
    "deberta-v3-base": ("Q4_0", True, [("qkvo", 768, 768, None, 4, False),
                                       ("up", 768, 3072, "gelu_erf", 1, False),
                                       ("down", 3072, 768, None, 1, False)]),
    "nomic-embed-text-v1.5": ("Q4_0", False, [("qkvo", 768, 768, None, 4, False),
                                              ("up", 768, 3072, "silu", 1, False),
                                              ("gate", 768, 3072, None, 1, False),
                                              ("down", 3072, 768, None, 1, True)]),
    "bge-large-en-v1.5": ("Q8_0", True, [("qkvo", 1024, 1024, None, 4, False)]),
    # RoBERTa/XLM-R, DistilBERT, ELECTRA, MPNet and ALBERT base run
    # DeBERTa-v3-base's shapes
    "electra-small": ("Q4_0", True, [("qkvo", 256, 256, None, 4, False),
                                     ("up", 256, 1024, "gelu_erf", 1, False),
                                     ("down", 1024, 256, None, 1, False)]),
    # T5 is bias-free; gtr-t5-base's relu follows the linear, outside K1
    "gtr-t5-base": ("Q4_0", False, [("qkvo", 768, 768, None, 4, False),
                                    ("up", 768, 3072, None, 1, False),
                                    ("down", 3072, 768, None, 1, False)]),
    "t5-v1.1-base": ("Q4_0", False, [("qkvo", 768, 768, None, 4, False),
                                     ("up", 768, 2048, "gelu_tanh", 1, False),
                                     ("gate", 768, 2048, None, 1, False),
                                     ("down", 2048, 768, None, 1, True)]),
}
K1_TABLE = (512, 768, 768)  # DeBERTa's relative-table projection: M, K, N
_ACT = {None: lambda y: y, "gelu_erf": F.gelu, "silu": F.silu,
        "gelu_tanh": lambda y: F.gelu(y, approximate="tanh")}


def _k1_case(m: int, k: int, n: int, qtype: str, bias: bool, gated: bool, rng, dev):
    """(x, w, wd, b, g) for one K1 call at [m, k] x [k, n] on the card."""
    w, wd = _weight(qtype, k, n, 2e-2, rng, dev)
    x = torch.from_numpy(rng.normal(size=(m, k))).to(dev, torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=(m, k))).to(dev, torch.bfloat16) if gated else None
    b = torch.from_numpy(rng.normal(size=(n,)) * 1e-2).to(dev, torch.float32) if bias else None
    return x, w, wd, b, g


def _k1_work(m: int, k: int, n: int, w, gated: bool, bias: bool) -> tuple[float, float]:
    """(bytes, flops) of one K1 call: x (and g) read once, the packed
    weight, the bias, the bf16 output written once."""
    nbytes = m * k * 2 * (2 if gated else 1) + _weight_bytes(w) + (n * 4 if bias else 0) + m * n * 2
    return nbytes, 2.0 * m * k * n


def bench_k1_layers(peaks, m: int = 16384) -> dict:
    """K1 at each model's linears of one layer, as the route gives them to
    K1 (bf16, the main path's qtype), against torch.mm / torch.addmm on the
    dequantized weight (+ the activation); per shape and per layer (q/k/v/o
    counted four times).  Runs on any tree that has `_q4_matmul_1d`, so the
    same file times a parent commit."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {}
    for model, (qtype, bias, shapes) in K1_LAYERS.items():
        layer = {"kernel_us": 0.0, "library_us": 0.0, "bound_us": 0.0, "shapes": {}}
        for name, k, n, act, per_layer, gated in shapes:
            x, w, wd, b, g = _k1_case(m, k, n, qtype, bias, gated, rng, dev)
            r = route(m, k, n, w.qtype, x.dtype, prologue=gated).kernel
            assert r in ("1d", "xla"), f"{model} {name}: the route gives {r}, not K1"
            bb = None if b is None else b.to(x.dtype)

            def kernel(x=x, w=w, b=b, g=g, act=act):
                return _q4_matmul_1d(x, w, b, prologue_mul=g, activation=act)

            def library(x=x, wd=wd, bb=bb, g=g, act=act):
                xx = x if g is None else x * g
                return _ACT[act](torch.mm(xx, wd) if bb is None else torch.addmm(bb, xx, wd))
            nbytes, flops = _k1_work(m, k, n, w, gated, bias)
            case = {"kernel": _timed(kernel, nbytes, flops, peaks),
                    "library": _timed(library, nbytes, flops, peaks), "per_layer": per_layer}
            layer["shapes"][name] = case
            layer["kernel_us"] += per_layer * case["kernel"]["us"]
            layer["library_us"] += per_layer * case["library"]["us"]
            layer["bound_us"] += per_layer * case["kernel"]["bound_us"]
            del x, w, wd, b, g
        out[model] = layer
        torch.cuda.empty_cache()
    return out


def bench_k1_tiles(peaks, ms=(512, 5376, 8192, 16384, 22016, 65536)) -> dict:
    """Every K1 bf16 tile instance forced at every distinct K1 shape of
    `K1_LAYERS` (and DeBERTa's table projection) over `ms`, beside the
    instance `k1_tile` picks: {"KxN[+g]": {M: {"BMxBN": us, ..., "rule":
    "BMxBN"}}}."""
    from ..ops.q4_matmul import TC_TILES, _sms, k1_tile

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    shapes = {(k, n, gated, qtype, bias) for qtype, bias, layer in K1_LAYERS.values()
              for _, k, n, _, _, gated in layer}
    out = {}
    for k, n, gated, qtype, bias in sorted(shapes):
        ms_here = ms if (k, n) != K1_TABLE[1:] else sorted({*ms, K1_TABLE[0]})
        key = f"{k}x{n}{'+g' if gated else ''}/{qtype}"
        out[key] = {}
        for m in ms_here:
            x, w, wd, b, g = _k1_case(m, k, n, qtype, bias, gated, rng, dev)
            nbytes, flops = _k1_work(m, k, n, w, gated, bias)
            row = {f"{bm}x{bn}": _timed(
                lambda t=(bm, bn): _q4_matmul_1d(x, w, b, prologue_mul=g, tile=t),
                nbytes, flops, peaks, samples=10)["us"] for bm, bn in TC_TILES}
            bm, bn = k1_tile(m, k, n, _sms(0))
            row["rule"] = f"{bm}x{bn}"
            row["bound_us"] = bound_ms(nbytes, flops, peaks)[0] * 1e3
            out[key][m] = row
            del x, w, wd, b, g
        torch.cuda.empty_cache()
    return out


def _qkv(shape, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape)).to("cuda", torch.bfloat16)
            for _ in range(3)]


def _tail_bias(b: int, s: int) -> torch.Tensor:
    bias = np.zeros((b, s), np.float32)
    bias[:, (s * 3) // 4:] = -1e9
    return torch.from_numpy(bias).cuda()


def _sdpa(q, k, v, mask, **kw):
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, **kw)


def bench_attention(peaks, b: int = 32, s: int = 512, h: int = 12, d: int = 32) -> dict:
    """K3, the projection-layout kernel with a key bias (the last quarter of
    every row masked), against SDPA with the additive mask."""
    q, k, v = _qkv((b, s, h * d))
    bias = _tail_bias(b, s)
    heads = [t.view(b, s, h, d).transpose(1, 2).contiguous() for t in (q, k, v)]
    nbytes, flops = 4 * q.numel() * 2 + bias.numel() * 4, 4.0 * b * h * s * s * d
    return {"kernel": _timed(lambda: flash_attention_bse(q, k, v, bias, h), nbytes, flops, peaks),
            "library": _timed(_sdpa(*heads, bias[:, None, None, :].to(q.dtype)), nbytes, flops,
                              peaks)}


def bench_attention_bias(peaks, b: int = 32, s: int = 512, h: int = 12, d: int = 64) -> dict:
    """K4, a per-head [H, S, S] f32 position bias added after the key bias
    (MPNet's relative attention at all-mpnet-base-v2's shape), against SDPA
    with the float mask (key bias + position bias, materialized)."""
    q, k, v = _qkv((b, s, h * d))
    bias = _tail_bias(b, s)
    pos = torch.from_numpy(np.random.default_rng(1).normal(size=(h, s, s))
                           .astype(np.float32)).cuda()
    heads = [t.view(b, s, h, d).transpose(1, 2).contiguous() for t in (q, k, v)]
    mask = (bias[:, None, None, :] + pos[None]).to(q.dtype)
    nbytes = 4 * q.numel() * 2 + bias.numel() * 4 + pos.numel() * 4
    flops = 4.0 * b * h * s * s * d
    return {"kernel": _timed(lambda: flash_attention_bse(q, k, v, bias, h, pos), nbytes, flops,
                             peaks),
            "library": _timed(_sdpa(*heads, mask), nbytes, flops, peaks)}


def bench_attention_headpack(peaks, b: int = 32, s: int = 512, h: int = 12, d: int = 32,
                             hb: int = 4) -> dict:
    """B1, hb heads packed into one product per stage over block-diagonal
    K/V tiles, beside the per-head kernels at the same shape: K5
    (`flash_attention`, [B, S, H, d]) and K3 (`flash_attention_bse`,
    [B, S, H*d]), SDPA (the library call, [B, H, S, d]) and the plain
    version.  The bias is zero, as in the JAX suite; max_err_vs_per_head is
    max|B1 - K5| and max_err_vs_plain max|B1 - plain|."""
    q, k, v = _qkv((b, h, s, d))
    bias = torch.zeros(b, s, dtype=torch.float32, device="cuda")
    rows = [t.transpose(1, 2).contiguous() for t in (q, k, v)]  # [B, S, H, d]
    proj = [t.view(b, s, h * d) for t in rows]
    nbytes, flops = 4 * q.numel() * 2 + bias.numel() * 4, 4.0 * b * h * s * s * d
    got = attention_headpack(q, k, v, bias, hb)
    per_head = flash_attention(*rows, bias).transpose(1, 2)
    plain = attention_headpack_plain(q, k, v, bias, hb)
    torch.cuda.synchronize()
    return {
        "hb": hb,
        "kernel": _timed(lambda: attention_headpack(q, k, v, bias, hb), nbytes, flops, peaks),
        "per_head": _timed(lambda: flash_attention(*rows, bias), nbytes, flops, peaks),
        "k3": _timed(lambda: flash_attention_bse(*proj, bias, h), nbytes, flops, peaks),
        "library": _timed(_sdpa(q, k, v, bias[:, None, None, :].to(q.dtype)), nbytes, flops,
                          peaks),
        "plain": _timed(lambda: attention_headpack_plain(q, k, v, bias, hb), nbytes, flops,
                        peaks, samples=3, reps=1),
        "max_err_vs_per_head": (got.float() - per_head.float()).abs().max().item(),
        "max_err_vs_plain": (got.float() - plain.float()).abs().max().item(),
    }


def bench_packed_attention(peaks, b: int = 64, s: int = 512, h: int = 12, d: int = 32,
                           seg_len: int = 16) -> dict:
    """K2, segment-masked packed rows (segments of seg_len tokens), against
    SDPA with the boolean block-diagonal [B, 1, S, S] mask.  tflops and the
    bound count the (query, key) pairs that share a segment id, the work no
    skip removes; `bound_us_all_pairs` is that of every pair."""
    q, k, v = _qkv((b, s, h * d))
    seg = torch.arange(s, device="cuda").div(seg_len, rounding_mode="floor") \
        .to(torch.int32).expand(b, s).contiguous()
    heads = [t.view(b, s, h, d).transpose(1, 2).contiguous() for t in (q, k, v)]
    allowed = (seg[:, :, None] == seg[:, None, :])[:, None]
    nbytes = 4 * q.numel() * 2 + seg.numel() * 4
    flops = 4.0 * h * d * segment_pairs(seg.cpu().numpy())
    return {"kernel": _timed(lambda: flash_attention_packed_bse(q, k, v, seg, h), nbytes, flops,
                             peaks),
            "library": _timed(_sdpa(*heads, allowed), nbytes, flops, peaks),
            "bound_us_all_pairs": bound_ms(nbytes, 4.0 * b * h * s * s * d, peaks)[0] * 1e3}


BSE_HEADS = ((12, 32), (12, 64), (16, 64))  # MiniLM-L6; ModernBERT, nomic; bge-large
BSE_SHORT = ((2048, 16), (512, 32))  # MiniLM-L6's plain buckets of the corpus
# MPNet's and T5's per-head relative bias at 12 heads of 64: the corpus's
# short plain buckets and the [32, 512] forward
BSE_RELPOS = ((2048, 16), (512, 32), (32, 512))


def bench_bse(peaks, b: int = 32, s: int = 512) -> dict:
    """The projection-layout kernel at every model's heads at [32, 512],
    bf16, each beside SDPA with its mask materialized: K2 over packed rows
    of the serving profile (tflops and the bound over the pairs that share
    a segment id), K3 with a padded tail, K4 plain and packed with a [1, S,
    S] window-128 bias (ModernBERT's local layers) and a per-head [H, S, S]
    bias; K3 at MiniLM-L6's short plain buckets [2048, 16] and [512, 32];
    K4 plain and packed with MPNet's / T5's bucketed [12, S, S] bias at
    12x64 at `BSE_RELPOS` (packed rows of the serving profile, cut to S;
    tflops and the bound over the pairs that share a segment id)."""
    from ..models.bert import rel_attn_bias
    from ..models.modernbert import window_bias

    seg_np = serving_segments(np.random.default_rng(0), b, s)[0]
    seg = torch.from_numpy(seg_np).cuda()
    allowed = (seg[:, :, None] == seg[:, None, :])[:, None]
    pairs = segment_pairs(seg_np)
    bias = _tail_bias(b, s)
    out = {}
    for h, d in BSE_HEADS:
        q, k, v = _qkv((b, s, h * d))
        heads = [t.view(b, s, h, d).transpose(1, 2).contiguous() for t in (q, k, v)]
        nbytes = 4 * q.numel() * 2 + b * s * 4
        flops = 4.0 * b * h * s * s * d
        r = {"k2": {"kernel": _timed(lambda: flash_attention_packed_bse(q, k, v, seg, h), nbytes,
                                     4.0 * h * d * pairs, peaks),
                    "library": _timed(_sdpa(*heads, allowed), nbytes, 4.0 * h * d * pairs,
                                      peaks)},
             "k3": {"kernel": _timed(lambda: flash_attention_bse(q, k, v, bias, h), nbytes, flops,
                                     peaks),
                    "library": _timed(_sdpa(*heads, bias[:, None, None, :].to(q.dtype)), nbytes,
                                      flops, peaks)}}
        for ph in (1, h):
            pos = (window_bias(s, 128, "cuda") if ph == 1 else torch.from_numpy(
                np.random.default_rng(2).normal(size=(h, s, s)).astype(np.float32)).cuda())
            pb_bytes = nbytes + pos.numel() * 4
            plain_mask = (bias[:, None, None, :] + pos[None]).to(q.dtype)
            r[f"k4_ph{ph}"] = {
                "kernel": _timed(lambda: flash_attention_bse(q, k, v, bias, h, pos), pb_bytes,
                                 flops, peaks),
                "library": _timed(_sdpa(*heads, plain_mask), pb_bytes, flops, peaks)}
            del plain_mask
            packed_mask = torch.where(allowed, pos[None], -1e9).to(q.dtype)
            r[f"k4_packed_ph{ph}"] = {
                "kernel": _timed(lambda: flash_attention_packed_bse(q, k, v, seg, h, pos),
                                 pb_bytes, flops, peaks),
                "library": _timed(_sdpa(*heads, packed_mask), pb_bytes, flops, peaks)}
            del packed_mask, pos
        out[f"{h}x{d}"] = r
        del q, k, v, heads
        torch.cuda.empty_cache()
    h, d = BSE_HEADS[0]
    for bb, ss in BSE_SHORT:
        q, k, v = _qkv((bb, ss, h * d))
        mask = _tail_bias(bb, ss)
        heads = [t.view(bb, ss, h, d).transpose(1, 2).contiguous() for t in (q, k, v)]
        nbytes, flops = 4 * q.numel() * 2 + bb * ss * 4, 4.0 * bb * h * ss * ss * d
        out[f"k3_b{bb}_s{ss}"] = {
            "kernel": _timed(lambda: flash_attention_bse(q, k, v, mask, h), nbytes, flops, peaks),
            "library": _timed(_sdpa(*heads, mask[:, None, None, :].to(q.dtype)), nbytes, flops,
                              peaks)}
    h, d = 12, 64
    table = torch.from_numpy(np.random.default_rng(3).normal(size=(32, h))
                             .astype(np.float32)).cuda()
    for bb, ss in BSE_RELPOS:
        q, k, v = _qkv((bb, ss, h * d))
        mask = _tail_bias(bb, ss)
        pos = rel_attn_bias(table, ss)
        seg_np = serving_segments(np.random.default_rng(ss), bb, ss)[0]
        seg = torch.from_numpy(seg_np).cuda()
        seg_flops = 4.0 * h * d * segment_pairs(seg_np)
        allowed = (seg[:, :, None] == seg[:, None, :])[:, None]
        heads = [t.view(bb, ss, h, d).transpose(1, 2).contiguous() for t in (q, k, v)]
        nbytes = 4 * q.numel() * 2 + bb * ss * 4 + pos.numel() * 4
        flops = 4.0 * bb * h * ss * ss * d
        plain_mask = (mask[:, None, None, :] + pos[None]).to(q.dtype)
        r = {"plain": {"kernel": _timed(lambda: flash_attention_bse(q, k, v, mask, h, pos),
                                        nbytes, flops, peaks),
                       "library": _timed(_sdpa(*heads, plain_mask), nbytes, flops, peaks)}}
        del plain_mask
        packed_mask = torch.where(allowed, pos[None], -1e9).to(q.dtype)
        r["packed"] = {
            "kernel": _timed(lambda: flash_attention_packed_bse(q, k, v, seg, h, pos), nbytes,
                             seg_flops, peaks),
            "library": _timed(_sdpa(*heads, packed_mask), nbytes, seg_flops, peaks)}
        out[f"k4_relpos_b{bb}_s{ss}"] = r
        del packed_mask, q, k, v, heads
        torch.cuda.empty_cache()
    return out


def bench_long(peaks, b: int = 8, h: int = 12, d: int = 64, window: int = 128) -> dict:
    """The long-row body (K5, K6, K7) at the main paths' shapes, bf16, each
    beside SDPA with its mask materialized and the bound: K5 at [8, 8192]
    with key padding (every row padded past a random length in S/2..S, one
    row all padding); K5 with ModernBERT's [1, S, S] window-128 bias at [8,
    2048]; K6b over nomic's chunk rows (segments of 128-512 tokens, bound
    512) and K6a over its document rows (600-1400, bound 2048) at [8, 2048]
    (tflops and the bound over the pairs that share a segment id within each
    query tile's key slice); K7 at [8, 8192], window 128, the same padding
    (over the pairs within the window).  `kernel` is the wrapper, at the
    source's query-tile rule; `tile_64` / `tile_128` force each query tile
    the bf16 body is built for (absent on a tree that cannot force them)."""
    from ..models.modernbert import window_bias
    from ..ops import attention as A

    tiles = getattr(A, "LONG_TILES", ())
    rng = np.random.default_rng(4)
    out = {}

    def key_bias(bb, ss):
        lens = rng.integers(ss // 2, ss + 1, size=bb)
        lens[-1] = 0  # one row all padding
        return torch.from_numpy(np.where(np.arange(ss)[None] < lens[:, None], 0.0, -1e9)
                                .astype(np.float32)).cuda()

    def case(name, rule, forced, lib, nbytes, flops):
        r = {"kernel": _timed(rule, nbytes, flops, peaks),
             "library": _timed(lib, nbytes, flops, peaks)}
        for t in tiles:
            r[f"tile_{t}"] = _timed(lambda t=t: forced(t), nbytes, flops, peaks)
        out[name] = r

    s = 8192
    q, k, v = _qkv((b, s, h, d))
    heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    keyb = key_bias(b, s)
    nbytes = 4 * q.numel() * 2 + b * s * 4
    case("k5_b8_s8192", lambda: flash_attention(q, k, v, keyb),
         lambda t: A._launch_long(q, k, v, keyb, A._FULL, tile_q=t),
         _sdpa(*heads, keyb[:, None, None, :].to(q.dtype)), nbytes, 4.0 * b * h * s * s * d)
    pos = torch.arange(s, device="cuda")
    inwin = (pos[None, :] - pos[:, None]).abs() <= window // 2
    lmask = torch.where(inwin[None, None], keyb[:, None, None, :], -1e9).to(q.dtype)
    pairs = float(b * (torch.clamp(pos + window // 2, max=s - 1)
                       - torch.clamp(pos - window // 2, min=0) + 1).sum())
    case("k7_b8_s8192_w128", lambda: flash_attention_local(q, k, v, keyb, window),
         lambda t: A._launch_long(q, k, v, keyb, A._LOCAL, window=window, tile_q=t),
         _sdpa(*heads, lmask), nbytes, 4.0 * h * d * pairs)
    del q, k, v, heads, lmask, inwin
    torch.cuda.empty_cache()

    s = 2048
    q, k, v = _qkv((b, s, h, d))
    heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    keyb = key_bias(b, s)
    pb = window_bias(s, window, "cuda")
    nbytes = 4 * q.numel() * 2 + b * s * 4
    case("k5_bias_b8_s2048", lambda: flash_attention(q, k, v, keyb, pb),
         lambda t: A._launch_long(q, k, v, keyb, A._FULL, pb, tile_q=t),
         _sdpa(*heads, (keyb[:, None, None, :] + pb[None]).to(q.dtype)),
         nbytes + pb.numel() * 4, 4.0 * b * h * s * s * d)
    for name, lo, hi, bound in (("k6b_chunks_b8_s2048", 128, 512, 512),
                                ("k6a_documents_b8_s2048", 600, 1400, 2048)):
        seg_np = packed_rows(rng, b, s, lo, hi)[0]
        seg = torch.from_numpy(seg_np).cuda()
        tq, wmax = A.packed_window_tiles(s, bound)
        allowed = (seg[:, :, None] == seg[:, None, :])[:, None]
        case(name, lambda seg=seg, bound=bound: flash_attention_packed(q, k, v, seg, bound),
             lambda t, seg=seg, bound=bound: A._launch_long(q, k, v, seg, A._SEG,
                                                            max_seg_len=bound, tile_q=t),
             _sdpa(*heads, allowed), 4 * q.numel() * 2 + seg.numel() * 4,
             4.0 * h * d * segment_pairs(seg_np, tq, wmax))
        out[name]["wmax"] = wmax or s
        del allowed
    return out


def bench_windowed_attention(peaks, b: int = 8, s: int = 2048, h: int = 12, d: int = 32,
                             seg_len: int = 64, window: int = 128) -> dict:
    """Long rows [B, S, H, d]: K6 over packed segments of seg_len tokens,
    windowed (`kernel`, the query tile's key slice) and over every key
    (`full`); K7, the sliding window (`local`), beside K5 over every key
    (`long`); SDPA with the boolean block-diagonal mask (`library`).  tflops
    count the visible (query, key) pairs of each function."""
    q, k, v = _qkv((b, s, h, d))
    seg = torch.arange(s, device="cuda").div(seg_len, rounding_mode="floor") \
        .to(torch.int32).expand(b, s).contiguous()
    keyb = torch.zeros(b, s, dtype=torch.float32, device="cuda")
    heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    allowed = (seg[:, :, None] == seg[:, None, :])[:, None]
    nbytes = 4 * q.numel() * 2 + b * s * 4
    pos = np.arange(s)
    local_pairs = float(b * (np.minimum(pos + window // 2, s - 1)
                             - np.maximum(pos - window // 2, 0) + 1).sum())
    seg_flops, all_flops = 4.0 * h * d * b * s * seg_len, 4.0 * b * h * s * s * d
    return {
        "kernel": _timed(lambda: flash_attention_packed(q, k, v, seg, seg_len), nbytes,
                         seg_flops, peaks),
        "full": _timed(lambda: flash_attention_packed(q, k, v, seg), nbytes, seg_flops, peaks),
        "local": _timed(lambda: flash_attention_local(q, k, v, keyb, window), nbytes,
                        4.0 * h * d * local_pairs, peaks),
        "long": _timed(lambda: flash_attention(q, k, v, keyb), nbytes, all_flops, peaks),
        "library": _timed(_sdpa(*heads, allowed), nbytes, seg_flops, peaks),
    }


def bench_deberta_attention(peaks, b: int = 16, s: int = 512, h: int = 12, d: int = 64,
                            span: int = 256) -> dict:
    """K9, disentangled attention at deberta-v3-base's geometry with a key
    bias, against SDPA given the materialized scaled c2p + p2c bias with
    the key bias folded in (building it is not timed)."""
    max_dist = 2 * span
    q, k, v = _qkv((b, s, h, d))
    rng = np.random.default_rng(1)
    pos_k, pos_q = (torch.from_numpy(rng.normal(size=(2 * span, h, d))).to("cuda", q.dtype)
                    for _ in range(2))
    bias = _tail_bias(b, s)
    scale = 1.0 / float(np.sqrt(3 * d))
    c2p, p2c = (torch.from_numpy(t).to(q.device) for t in delta_tables(s, span, max_dist))
    heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    rel = (disentangled_scores_plain(q, k, pos_k, pos_q, c2p.long(), p2c.long())
           - torch.matmul(heads[0].float(), heads[1].float().transpose(-1, -2))) * scale
    mask = (rel + bias[:, None, None, :]).to(q.dtype)
    del rel
    flops, nbytes = deberta_work(b, s, h, d, span, q.element_size())
    return {"kernel": _timed(lambda: disentangled_attention(q, k, v, bias, pos_k, pos_q, span,
                                                            max_dist), nbytes, flops, peaks),
            "library": _timed(_sdpa(*heads, mask, scale=scale), nbytes, flops, peaks)}


# --- the full-forward A/Bs -----------------------------------------------------

# GPU spin (cycles) queued before each sample of a whole forward: ~25 ms on
# an H100, long enough for the host to queue a forward's few hundred launches
FORWARD_SPIN = 50_000_000


def ab_impls(device) -> tuple[str, str]:
    """The two arms of a forward A/B: the kernel and its plain version on
    the card; on the CPU, where no kernel runs, "auto" (the plain version
    chosen by the device) and "plain"."""
    return ("kernel", "plain") if torch.device(device).type == "cuda" else ("auto", "plain")


def forward_ms(fn, device, samples: int = 5, warmup: int = 2) -> float:
    """ms per call of `fn`, a whole forward or a piece of one: on the card
    CUDA events around one call queued behind a GPU spin (`gpu_ms`, after
    `warmup` calls), the median of `samples`; on the CPU the least
    host-clock time."""
    if torch.device(device).type == "cuda":
        return gpu_ms(fn, samples=samples, reps=1, spin=FORWARD_SPIN, warmup=warmup)
    return device_ms(fn, device, samples)


def preset_config(preset: str, layers: int | None = None, vocab: int | None = None):
    """The preset's config, its depth cut to `layers` and its vocabulary to
    `vocab` where given (widths and heads stay the published ones)."""
    from dataclasses import replace

    from ..cli.make_test_model import PRESETS

    config = PRESETS[preset]
    cut = {k: v for k, v in (("n_layer", layers), ("n_vocab", vocab)) if v}
    return replace(config, **cut) if cut else config


def forward_case(config, b: int, s: int, device, ftype: str = "q4_0", seed: int = 0,
                 params: dict | None = None) -> dict:
    """Parameters of `config` stored as `ftype` (random, `seed`; dense
    weights in bf16), or the `params` given, and the in-device forward's
    inputs at [b, s] (`bench.forward_inputs`: full rows, and packed rows
    of the corpus's length profile) on `device`."""
    from ..models import random_params
    from .bench import forward_inputs

    if params is None:
        params = random_params(config, ftype, seed=seed, dense_dtype=torch.bfloat16,
                               device=device)
    ids, mask, pids, seg, pos = forward_inputs(config.n_vocab, device, b, s, seed)
    return {"params": params, "config": config, "ids": ids, "mask": mask, "pids": pids,
            "seg": seg, "pos": pos}


def forward_fn(case: dict, opts, packed: bool = False):
    """A no-argument call of the case's forward under `opts`: plain
    buckets (`bert_embed_batch`) or packed rows (`bert_embed_packed`, 64
    segment slots a row)."""
    from ..models import bert_embed_batch, bert_embed_packed

    c = case
    if packed:
        return lambda: bert_embed_packed(c["params"], c["pids"], c["seg"], c["pos"],
                                         c["config"], opts, n_seg=64)
    return lambda: bert_embed_batch(c["params"], c["ids"], c["mask"], c["config"], opts)


def bench_forward_impl(family: str, case: dict, device, samples: int = 5,
                       packed: bool = False) -> dict:
    """A whole forward with `family` ("q4" | "attn") of kernels on and off
    (`ab_impls`), everything else "auto": {arm: {ms, tokens_per_sec}},
    `max_abs_diff` between the two arms' outputs.  Each arm runs once for
    that output (its warmup), then `samples` times timed."""
    from ..models import ComputeOptions

    tokens = int((case["seg"] >= 0).sum()) if packed else case["ids"].numel()
    out, ys = {}, []
    with torch.inference_mode():
        for impl in ab_impls(device):
            fn = forward_fn(case, ComputeOptions(dtype="bfloat16", **{f"{family}_impl": impl}),
                            packed)
            ys.append(fn().float())
            ms = forward_ms(fn, device, samples, warmup=0)
            out[impl] = {"ms": ms, "tokens_per_sec": tokens / ms * 1e3}
    out["max_abs_diff"] = (ys[0] - ys[1]).abs().max().item()
    out.update(shape=list(case["ids"].shape), packed=packed, tokens=tokens)
    return out


def bench_forward_q4_impl(b: int = 32, s: int = 512, preset: str = "minilm-l6", *,
                          device="cuda", ftype: str = "q4_0", samples: int = 5,
                          layers: int | None = None, vocab: int | None = None,
                          params: dict | None = None) -> dict:
    """The whole forward with the quantized matmul as K1/K8 ("kernel") and
    as its plain version (dequantize, then matmul): the JAX suite's
    bench_forward_q4_impl.  `params` reuses weights built for the preset
    (at `ftype`, seed 0)."""
    case = forward_case(preset_config(preset, layers, vocab), b, s, device, ftype,
                        params=params)
    return {"preset": preset, "ftype": ftype,
            **bench_forward_impl("q4", case, device, samples)}


def bench_forward_attn_impl(b: int = 32, s: int = 512, preset: str = "mpnet-base", *,
                            device="cuda", ftype: str = "f32", samples: int = 5,
                            packed: bool = False, layers: int | None = None,
                            vocab: int | None = None, params: dict | None = None) -> dict:
    """The whole forward with the attention kernels on ("kernel") and as
    their plain versions: the JAX suite's bench_forward_attn_impl (dense
    bf16 weights by default, as there); `params` as bench_forward_q4_impl."""
    case = forward_case(preset_config(preset, layers, vocab), b, s, device, ftype,
                        params=params)
    return {"preset": preset, "ftype": ftype,
            **bench_forward_impl("attn", case, device, samples, packed)}


# mode: (family, the JAX suite's key of a forward A/B, [(preset, b, s,
# samples)]) at the JAX suite's shapes; `samples` 1 for the [1, 8192] plain
# attention (~0.5 s a forward)
FORWARD_MODES = {
    "forward_only": ("q4", "forward_b{b}_s{s}",
                     [("minilm-l6", 32, 512, 5), ("minilm-l6", 128, 128, 5)]),
    "mpnet_forward": ("attn", "mpnet_forward_b{b}_s{s}", [("mpnet-base", 32, 512, 5)]),
    "bias_ab": ("attn", "{preset}_forward_b{b}_s{s}",
                [("mpnet-base", 32, 512, 5), ("gtr-base", 32, 512, 5),
                 ("modernbert-base", 32, 512, 5), ("modernbert-base", 8, 1024, 5)]),
    "nomic_ab": ("attn", "nomic_forward_b{b}_s{s}",
                 [("nomic-embed-text", 32, 512, 5), ("nomic-embed-text", 1, 8192, 1)]),
    "deberta_ab": ("attn", "{preset}_forward_b{b}_s{s}",
                   [("deberta-base", 32, 512, 5), ("deberta-base", 32, 256, 5)]),
}


def run_forward_mode(mode: str, device, *, samples: int | None = None,
                     layers: int | None = None, vocab: int | None = None,
                     shape: tuple[int, int] | None = None, log=print) -> dict:
    """One full-forward mode: its kernel-against-library entry on the card
    (K4 for --bias-ab, K9 for --deberta-ab), then each preset's forward
    A/B, keyed as the JAX suite keys them (`FORWARD_MODES`).  `shape`
    replaces every [B, S]; `samples` caps every sample count."""
    family, key, cases = FORWARD_MODES[mode]
    results = {}
    if torch.device(device).type == "cuda":
        _, peaks = peaks_for(torch.cuda.get_device_name(0))
        if mode == "bias_ab":
            results["attention_bias_b32_s512_d64"] = r = bench_attention_bias(peaks)
            log(f"bias kernel K4 B=32 S=512 d=64: kernel {r['kernel']['us']:.1f}us | "
                f"library {r['library']['us']:.1f}us")
        if mode == "deberta_ab":
            results["deberta_attention_b16_s512_d64"] = r = bench_deberta_attention(peaks)
            log(f"deberta attention K9 B=16 S=512 d=64: kernel {r['kernel']['us']:.1f}us | "
                f"library {r['library']['us']:.1f}us")
    from ..models import random_params

    bench = bench_forward_q4_impl if family == "q4" else bench_forward_attn_impl
    ftype = "q4_0" if family == "q4" else "f32"
    built = {}  # one set of weights a preset
    for preset, b, s, n in cases:
        b, s = shape or (b, s)
        name = key.format(preset=preset, b=b, s=s)
        if name in results:  # `shape` made two cases one
            continue
        if preset not in built:
            built[preset] = random_params(preset_config(preset, layers, vocab), ftype, seed=0,
                                          dense_dtype=torch.bfloat16, device=device)
        r = bench(b, s, preset, device=device, samples=min(samples or n, n), layers=layers,
                  vocab=vocab, ftype=ftype, params=built[preset])
        results[name] = r
        a, p = ab_impls(device)
        log(f"{preset} forward {family}_impl A/B b={b} s={s}: {a} {r[a]['ms']:.3f}ms | "
            f"{p} {r[p]['ms']:.3f}ms | max|diff| {r['max_abs_diff']:.3g}")
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return results


def write_result(results_dir, name: str, result: dict) -> None:
    """The JSON line also to <results_dir>/<name>.json, where a directory
    is given (the scripts' default `RESULTS`, which git ignores)."""
    from pathlib import Path

    if results_dir is not None:
        path = Path(results_dir)
        path.mkdir(parents=True, exist_ok=True)
        (path / f"{name}.json").write_text(json.dumps(result, indent=1) + "\n")


def time_piece(name: str, fn, device, samples: int, count: float, peaks=None,
               flops: float | None = None, nbytes: float | None = None,
               library=None) -> dict:
    """One piece of a forward breakdown, logged under `name`: {us,
    per_layer_count, tflops} of `fn` (`forward_ms`), and on the card
    (`peaks` given) its bound where `nbytes` is given and the time of
    `library`, one PyTorch call of the same function, where one is given."""
    us = forward_ms(fn, device, samples) * 1e3
    piece = {"us": us, "per_layer_count": count,
             "tflops": flops / us / 1e6 if flops and peaks else None}
    if peaks is not None and nbytes is not None:
        bound, by = bound_ms(nbytes, flops, peaks)
        piece.update(bound_us=bound * 1e3, bound_by=by)
    if peaks is not None and library is not None:
        piece["library_us"] = forward_ms(library, device, samples) * 1e3
    print(f"{name:>18}: {piece['us']:10.1f} us" + (f"  bound {piece['bound_us']:.1f} us, library "
                                                     f"{piece['library_us']:.1f} us"
                                                     if "library_us" in piece else ""),
          file=sys.stderr, flush=True)
    return piece


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--m", type=int, nargs="+", default=[512, 4096, 32768])
    p.add_argument("--out", default=None, help="also write the JSON result to this file")
    p.add_argument("--only", nargs="+", default=None, metavar="SECTION",
                   help="run only these sections (keys of the JSON result, e.g. k8_ffn)")
    for mode in FORWARD_MODES:
        p.add_argument(f"--{mode.replace('_', '-')}", dest=mode, action="store_true",
                       help=f"only the full-forward A/B of {mode} (see above)")
    p.add_argument("--device", default=None,
                   help="torch device of the full-forward modes (default: the GPU)")
    p.add_argument("--samples", type=int, default=None,
                   help="at most this many samples of each forward (default: 5; 1 at "
                        "[1, 8192])")
    p.add_argument("--layers", type=int, default=None, help="cut each preset's depth")
    p.add_argument("--vocab", type=int, default=None, help="cut each preset's vocabulary")
    p.add_argument("--shape", type=int, nargs=2, default=None, metavar=("B", "S"),
                   help="run every forward at [B, S]")
    p.add_argument("--results", default=None,
                   help="also write <mode>.json there (a mode's run)")
    args = p.parse_args(argv)

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    modes = [m for m in FORWARD_MODES if getattr(args, m)]
    if modes:
        from ..runtime.engine import resolve_device

        dev = resolve_device(args.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        results = {"platform": dev.type, "device": device_block(dev)}
        for mode in modes:
            results[mode] = run_forward_mode(mode, dev, samples=args.samples,
                                             layers=args.layers, vocab=args.vocab,
                                             shape=args.shape, log=log)
            write_result(args.results or None, mode, results[mode])
        print(json.dumps(results))
        return results
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernel suite runs only on the GPU")
    if args.device is not None and torch.device(args.device).type != "cuda":
        raise SystemExit("the kernel sections run only on the GPU; --device cpu takes a "
                         "full-forward mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = device_block()
    _, peaks = peaks_for(device["name"])

    def ab(r: dict) -> str:
        return (f"kernel {r['kernel']['us']:9.1f}us {r['kernel']['tflops']:6.1f} TF/s | "
                f"library {r['library']['us']:9.1f}us {r['library']['tflops']:6.1f} TF/s | "
                f"bound {r['kernel']['bound_us']:7.1f}us")

    def want(section: str) -> bool:
        return args.only is None or section in args.only

    results = {"platform": "gpu", "device": device}
    if want("q4_ffn"):
        results["q4_ffn"] = {}
        for m in args.m:
            results["q4_ffn"][m] = r = bench_q4_ffn(m, peaks)
            log(f"q4 ffn M={m:6d} ({'/'.join(r['route'])}): {ab(r)}")
    if want("q4_epilogue"):
        m = max(args.m)
        results["q4_epilogue"] = {m: bench_q4_epilogue(m, peaks)}
        log(f"q4 epilogue combos (up,dn) M={m}: " + "  ".join(
            f"{k}={v['us']:.1f}us" for k, v in results["q4_epilogue"][m].items()))
    for qtype, key in (("Q4_0", "q4_fused_epilogue"), ("Q8_0", "q8_fused_epilogue")):
        if want(key):
            results[key] = {}
            for m in args.m:
                results[key][m] = r = bench_q4_fused_epilogue(m, peaks, qtype=qtype)
                log(f"{qtype} fused bias+gelu M={m:6d}: {ab(r)}")
    if want("k8_ffn"):
        results["k8_ffn"] = {"m16384_q8": (r := bench_k8_ffn(peaks))}
        for name in ("up", "down"):
            log(f"K8 bge-large {name} M=16384 ({r[name]['route']}): {ab(r[name])}")
    if want("k1_layers"):
        results["k1_layers"] = {"m16384_bf16": (r := bench_k1_layers(peaks))}
        for model, layer in r.items():
            log(f"K1 {model} layer M=16384: kernel {layer['kernel_us']:9.1f}us | library "
                f"{layer['library_us']:9.1f}us | bound {layer['bound_us']:7.1f}us")
    if want("k1_tiles"):
        results["k1_tiles"] = r = bench_k1_tiles(peaks)
        for key, rows in r.items():
            for m, row in rows.items():
                log(f"K1 tiles {key} M={m}: " + "  ".join(
                    f"{t}={us:.1f}" for t, us in row.items() if t not in ("rule", "bound_us"))
                    + f"  rule={row['rule']}  bound={row['bound_us']:.1f}us")
    if want("attention"):
        results["attention"] = {"b32_s512": (r := bench_attention(peaks))}
        log(f"attention K3 B=32 S=512: {ab(r)}")
    if want("attention_bias"):
        results["attention_bias"] = {"b32_s512_d64": (r := bench_attention_bias(peaks))}
        log(f"attention K4 + pos-bias B=32 S=512 d=64: {ab(r)}")
    if want("attention_headpack"):
        results["attention_headpack"] = {}
        for d, hb in ((32, 4), (64, 2)):
            key = f"b32_s512_d{d}_hb{hb}"
            results["attention_headpack"][key] = r = bench_attention_headpack(peaks, d=d, hb=hb)
            log(f"attention head-pack B1 {key}: {ab(r)} | K5 {r['per_head']['us']:.1f}us | "
                f"K3 {r['k3']['us']:.1f}us | max_err vs K5 {r['max_err_vs_per_head']:.5f}")
    if want("bse"):
        results["bse"] = r = bench_bse(peaks)
        for key, row in r.items():
            if "kernel" in row:
                log(f"bse {key}: {ab(row)}")
                continue
            for name, case in row.items():
                log(f"bse {key} {name}: {ab(case)}")
    if want("long"):
        results["long"] = r = bench_long(peaks)
        for key, row in r.items():
            log(f"long {key}: {ab(row)} | " + "  ".join(
                f"{t}={row[t]['us']:.1f}us" for t in row if t.startswith("tile_")))
    if want("packed_attention"):
        results["packed_attention"] = {"b64_s512_w16": (r := bench_packed_attention(peaks))}
        log(f"packed attention K2 B=64 S=512: {ab(r)}")
    if want("windowed_attention"):
        results["windowed_attention"] = {"b8_s2048_w64": (r := bench_windowed_attention(peaks))}
        log(f"windowed attention B=8 S=2048: K6 windowed {r['kernel']['us']:.1f}us | "
            f"K6 full {r['full']['us']:.1f}us | K7 {r['local']['us']:.1f}us | "
            f"K5 {r['long']['us']:.1f}us | library {r['library']['us']:.1f}us")
    if want("deberta_attention"):
        results["deberta_attention"] = {"b16_s512_d64": (r := bench_deberta_attention(peaks))}
        log(f"deberta attention K9 B=16 S=512 d=64: {ab(r)}")
    line = json.dumps(results)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return results


if __name__ == "__main__":
    main()
