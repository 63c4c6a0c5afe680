"""Packed attention at the served geometry: the projection layout (K2)
against the [B, S, H, d] route, kernel and whole forward.

The port's copy of the JAX package's `benchmarks/packed_bse_ab.py`.
Packing is the Engine's default for short sentences (`packing="auto"`,
pack_seq 512), so this measures the layout choice on the shape the engine
serves: [32, 512, 12 x 32] (MiniLM-L6's heads) over packed rows of the
corpus's length profile (`profiles.serving_segments`).

- The kernel A/B: K2 (`flash_attention_packed_bse` on the projections
  [B, S, H*d]) against the [B, S, H, d] route (`flash_attention_packed`,
  the long-row body's mode 2 over every key, K6a, on views of the same
  projections; the reshapes to and from that layout are timed in, and are
  free views on the card) and against SDPA under the boolean block mask.
  Parity first: K2 and K6a on the valid rows, each against K2's plain
  version.
- The whole packed forward, K2 route against the [B, S, H, d] route, for
  q4_0 MiniLM-L6 and nomic-embed-text: the script swaps the packed
  attention the model calls (`flash_attention_packed_bse` in
  models/bert.py and models/nomic.py) for the [B, S, H, d] route and
  restores it in `finally`, as the JAX script swaps `packed_bse_applies`;
  the Engine gets no option for it.
- MPNet and gtr-base (q4_0) packed forwards, attention kernels on and off
  ("kernel" / "plain", `kernels.bench_forward_attn_impl`), with the
  shared [H, S, S] relative bias.

The JAX script's `xla_per_row` variant timed a per-row [B, H, S, S] bias
of the TPU era's XLA path; the port never had that path, so it is left
out.  Times are CUDA events on resident tensors (`kernels.forward_ms`).

    python -m embedding_cpp_tpu_torch.benchmarks.packed_bse_ab [--device cpu]
        [--batch 32] [--seq 512] [--layers N] [--results DIR]

Without `--device` it needs a card.  The last line of standard output is
the JSON object, with a `device` entry; `--results` (default
`bench_results/`, which git ignores) also gets it as packed_bse_ab.json.
"""
from __future__ import annotations

import argparse
import json
import sys
from contextlib import contextmanager, nullcontext

from .forward_breakdown import RESULTS


def bhsd_route(q, k, v, seg, h: int, pos_bias=None):
    """The [B, S, H, d] route for packed rows in the projection layout's
    signature: K6a (every key) over views of the projections [B, S, H*d].
    It takes no position bias."""
    from ..ops.attention import flash_attention_packed

    if pos_bias is not None:
        raise ValueError("the [B, S, H, d] packed route takes no position bias")
    b, s, e = q.shape
    return flash_attention_packed(*(t.view(b, s, h, e // h) for t in (q, k, v)),
                                  seg).reshape(b, s, e)


@contextmanager
def packed_route(route):
    """Within the block, the BERT and nomic-bert forwards call `route` for
    their packed attention instead of `flash_attention_packed_bse`."""
    from ..models import bert, nomic

    saved = bert.flash_attention_packed_bse, nomic.flash_attention_packed_bse
    bert.flash_attention_packed_bse = nomic.flash_attention_packed_bse = route
    try:
        yield
    finally:
        bert.flash_attention_packed_bse, nomic.flash_attention_packed_bse = saved


def bench_kernel_ab(device, b: int = 32, s: int = 512, h: int = 12, d: int = 32,
                    samples: int = 20) -> dict:
    """K2 against the [B, S, H, d] route and SDPA (the block mask built
    outside the timed call) on packed rows of the serving profile."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ..ops.attention import attention_bse_plain, flash_attention_packed_bse
    from ..utils.profiling import bound_ms, peaks_for
    from .kernels import forward_ms
    from .profiles import segment_pairs, serving_segments

    gen = torch.Generator().manual_seed(0)
    e = h * d
    q, k, v = (torch.randn(b, s, e, generator=gen).to(device, torch.bfloat16) for _ in range(3))
    seg_np = serving_segments(np.random.default_rng(0), b, s)[0]
    seg = torch.from_numpy(seg_np).to(device)
    valid = seg >= 0
    got_bse = flash_attention_packed_bse(q, k, v, seg, h)
    got_bhsd = bhsd_route(q, k, v, seg, h)
    ref = attention_bse_plain(q, k, v, seg, h, True)

    def err(a, c):
        return (a[valid].float() - c[valid].float()).abs().max().item()

    out = {"max_err_valid": err(got_bse, got_bhsd), "bse_vs_plain": err(got_bse, ref),
           "bhsd_vs_plain": err(got_bhsd, ref), "shape": [b, s, h, d],
           "pair_share": segment_pairs(seg_np) / (b * s * s)}
    del got_bse, got_bhsd, ref
    heads = [t.view(b, s, h, d).transpose(1, 2).contiguous() for t in (q, k, v)]
    allowed = (seg[:, :, None] == seg[:, None, :])[:, None]
    calls = {"bse": lambda: flash_attention_packed_bse(q, k, v, seg, h),
             "bhsd": lambda: bhsd_route(q, k, v, seg, h)}
    if torch.device(device).type == "cuda":
        calls["library"] = lambda: F.scaled_dot_product_attention(*heads, attn_mask=allowed)
        peaks = peaks_for(torch.cuda.get_device_name(0))[1]
        flops = 4.0 * h * d * segment_pairs(seg_np)
        out["bound_us"], out["bound_by"] = bound_ms(4 * q.numel() * 2 + seg.numel() * 4,
                                                    flops, peaks)
        out["bound_us"] *= 1e3
    for name, fn in calls.items():
        us = forward_ms(fn, device, samples) * 1e3
        out[name] = {"us": us}
        if "bound_us" in out:
            out[name]["tflops"] = flops / us / 1e6
    return out


def bench_forward_ab(device, preset: str, b: int = 32, s: int = 512, samples: int = 5,
                     layers: int | None = None, vocab: int | None = None) -> dict:
    """The whole q4_0 packed forward, K2 route against the [B, S, H, d]
    route: {bse, bhsd: {ms, sentences_per_sec}}, `max_abs_diff` of the two
    outputs."""
    import torch

    from ..models import ComputeOptions
    from .kernels import forward_case, forward_fn, forward_ms, preset_config

    case = forward_case(preset_config(preset, layers, vocab), b, s, device, "q4_0")
    seg = case["seg"]
    n_sent = int((seg.max(dim=1).values + 1).sum())
    fn = forward_fn(case, ComputeOptions(dtype="bfloat16"), packed=True)
    out = {"preset": preset, "sentences_per_row": n_sent / b,
           "real_tokens": int((seg >= 0).sum())}
    ys = {}
    with torch.inference_mode():
        for name, route in (("bse", None), ("bhsd", bhsd_route)):
            with packed_route(route) if route else nullcontext():
                ys[name] = fn().float()
                ms = forward_ms(fn, device, samples)
            out[name] = {"ms": ms, "sentences_per_sec": n_sent / ms * 1e3}
    out["max_abs_diff"] = (ys["bse"] - ys["bhsd"]).abs().max().item()
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the plain versions)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--layers", type=int, default=None, help="cut each model's depth")
    p.add_argument("--vocab", type=int, default=None, help="cut each model's vocabulary")
    p.add_argument("--samples", type=int, default=20, help="samples of the kernel A/B")
    p.add_argument("--forward-samples", type=int, default=5)
    p.add_argument("--results", default=str(RESULTS),
                   help="directory for packed_bse_ab.json ('' for none)")
    args = p.parse_args(argv)

    import torch

    from ..runtime.engine import resolve_device
    from ..utils.profiling import device_block
    from .kernels import ab_impls, bench_forward_attn_impl, write_result

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s = args.batch, args.seq

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    results = {"platform": dev.type}
    r = bench_kernel_ab(dev, b, s, samples=args.samples)
    results[f"packed_kernel_b{b}_s{s}_minilm_geom"] = r
    log(f"packed kernel A/B (B={b} S={s} h=12 d=32): bse {r['bse']['us']:.1f}us | bhsd "
        f"{r['bhsd']['us']:.1f}us" + (f" | library {r['library']['us']:.1f}us"
                                      if "library" in r else "")
        + f" | max_err {r['max_err_valid']:.2e}")
    for preset, key in (("minilm-l6", "q4"), ("nomic-embed-text", "nomic")):
        r = bench_forward_ab(dev, preset, b, s, args.forward_samples, args.layers, args.vocab)
        results[f"{key}_forward_packed_b{b}_s{s}"] = r
        log(f"{preset} packed forward A/B (B={b} S={s}): bse {r['bse']['ms']:.3f}ms | "
            f"bhsd {r['bhsd']['ms']:.3f}ms")
    a, pl = ab_impls(dev)
    for preset in ("mpnet-base", "gtr-base"):
        r = bench_forward_attn_impl(b, s, preset, device=dev, ftype="q4_0", packed=True,
                                    samples=args.forward_samples, layers=args.layers,
                                    vocab=args.vocab)
        results[f"{preset}_forward_packed_b{b}_s{s}"] = r
        log(f"{preset} packed forward A/B (B={b} S={s}): {a} {r[a]['ms']:.3f}ms | "
            f"{pl} {r[pl]['ms']:.3f}ms")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    results["device"] = device_block(dev)
    print(json.dumps(results))
    write_result(args.results or None, "packed_bse_ab", results)
    return results


if __name__ == "__main__":
    main()
