"""Per-op accounting of the ModernBERT-base bf16 forward at [32, 512], and
the attn_impl forward A/B at [32, 512] and [8, 1024], plain and packed.

The port's copy of the JAX package's `benchmarks/modernbert_breakdown.py`.
In one run it times, at their production shapes:

- one q/k/v projection (K1, three a layer);
- the RoPE of q or k (its cos/sin tables built in the call, as the JAX
  script's), two a layer;
- attention with the [1, S, S] window bias (K4, the local layers' call;
  the global layers take the same kernel without it);
- the o projection with its residual;
- the bias-free LayerNorm, two a layer;
- the GeGLU trio (up + gelu, gate, down with the gate in K1's prologue)
  with its residual;
- a global and a local layer, and the 22-layer stack;
- the whole forward, with the same weights and inputs.

Times are CUDA events on resident tensors (`kernels.forward_ms`); the K1
and K4 pieces carry their bound and the library call's time (`torch.mm`
on the dequantized weight, SDPA with the float mask).  `accounted_us` is
n_layer x the layer's pieces and `accounted_pct` its share of the whole
forward.  Then `kernels.bench_forward_attn_impl` runs the whole forward
with the attention kernels on and off ("kernel" / "plain") at [32, 512]
and [8, 1024], over full rows and over packed rows of the corpus's
length profile.

The JAX script ran dense bf16 weights; this one runs Q4_0, the weights
the port's main path serves ModernBERT in (chip_smoke.py's ModernBERT
phases), so its K1 pieces are the served ones.

    python -m embedding_cpp_tpu_torch.benchmarks.modernbert_breakdown [--device cpu]
        [--batch 32] [--seq 512] [--layers 22] [--ab-shapes 32 512 8 1024] [--results DIR]

Without `--device` it needs a card.  The last line of standard output is
the JSON object, with a `device` entry; `--results` (default
`bench_results/`, which git ignores) also gets it as
modernbert_breakdown.json.
"""
from __future__ import annotations

import argparse
import json
import sys

from .forward_breakdown import RESULTS


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the plain versions)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--layers", type=int, default=None, help="cut the depth (default: 22)")
    p.add_argument("--vocab", type=int, default=None, help="cut the vocabulary")
    p.add_argument("--samples", type=int, default=20)
    p.add_argument("--ab-samples", type=int, default=5)
    p.add_argument("--ab-shapes", type=int, nargs="*", default=[32, 512, 8, 1024],
                   metavar="B S", help="the forward A/B's [B, S] pairs")
    p.add_argument("--results", default=str(RESULTS),
                   help="directory for modernbert_breakdown.json ('' for none)")
    args = p.parse_args(argv)
    if len(args.ab_shapes) % 2:
        p.error("--ab-shapes takes pairs B S")

    import torch
    import torch.nn.functional as F

    from ..models import ComputeOptions
    from ..models.modernbert import (
        _Ctx,
        _ln,
        _run_layers,
        apply_rope,
        encoder_layer,
        layer_kinds,
        rope_cos_sin,
        window_bias,
    )
    from ..ops.attention import flash_attention_bse
    from ..ops.linear import linear
    from ..ops.q4_matmul import dequant_weight
    from ..runtime.engine import resolve_device
    from ..utils.profiling import device_block, peaks_for
    from .kernels import (
        _weight_bytes,
        bench_forward_attn_impl,
        forward_case,
        forward_fn,
        forward_ms,
        preset_config,
        time_piece,
        write_result,
    )

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    on_card = dev.type == "cuda"
    peaks = peaks_for(torch.cuda.get_device_name(0))[1] if on_card else None
    config = preset_config("modernbert-base", args.layers, args.vocab)
    opts = ComputeOptions(dtype="bfloat16")
    dt = torch.bfloat16
    b, s = args.batch, args.seq
    e, f, h, d = config.n_embd, config.n_ff, config.n_head, config.head_dim
    m = b * s
    case = forward_case(config, b, s, dev, "q4_0")
    params = case["params"]
    lp = {k: v[0] for k, v in params["layers"].items()}
    lp_local = {k: v[1] for k, v in params["layers"].items()}
    is_local, inv_freq = layer_kinds(config)
    gen = torch.Generator().manual_seed(0)
    x_bse = (torch.randn(b, s, e, generator=gen) * 0.1).to(dev, dt)
    x_me = x_bse.reshape(m, e)
    q0 = torch.randn(b, s, h, d, generator=gen).to(dev, dt)
    pos = torch.arange(s, device=dev)
    pad = torch.zeros(b, s, dtype=torch.float32, device=dev)
    win = window_bias(s, config.local_window, dev)
    inv_local = torch.from_numpy(inv_freq[1]).to(dev)
    ctx = _Ctx(config, pos, dt, s, dev, pad=pad)

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    pieces: dict[str, dict] = {}

    def record(name, fn, count, flops=None, nbytes=None, library=None):
        pieces[name] = time_piece(name, fn, dev, args.samples, count, peaks, flops, nbytes,
                                  library)

    with torch.inference_mode():
        full_us = forward_ms(forward_fn(case, opts), dev, args.samples) * 1e3
        log(f"      full forward: {full_us:9.1f} us")
        w_q = lp["q_w"]
        wd = dequant_weight(w_q, dt) if on_card else None
        record("qkv_proj", lambda: linear(x_me, w_q), 3, flops=2.0 * m * e * e,
               nbytes=m * e * 2 * 2 + _weight_bytes(w_q), library=lambda: torch.mm(x_me, wd))

        def rope():
            cos, sin = rope_cos_sin(pos, inv_local, dt)
            return apply_rope(q0, cos, sin)
        record("rope(q or k)", rope, 2)
        xh = x_bse.view(b, s, h, d).transpose(1, 2).contiguous()
        fmask = (pad[:, None, None, :] + win[None]).to(dt)
        record("attention_bse", lambda: flash_attention_bse(x_bse, x_bse, x_bse, pad, h, win), 1,
               flops=4.0 * b * h * s * s * d, nbytes=4 * m * e * 2 + m * 4 + win.numel() * 4,
               library=lambda: F.scaled_dot_product_attention(xh, xh, xh, attn_mask=fmask))
        record("o_proj+res", lambda: linear(x_bse, lp["o_w"], residual=x_bse), 1,
               flops=2.0 * m * e * e)
        eps = config.layer_norm_eps
        record("layernorm", lambda: _ln(x_bse, lp["ln_out_scale"], eps, dt), 2)

        def geglu():
            u = linear(x_bse, lp["ffn_up_w"], activation="gelu_erf")
            g = linear(x_bse, lp["ffn_gate_w"])
            return linear(u, lp["ffn_down_w"], residual=x_bse, prologue_mul=g)
        record("geglu_trio+res", geglu, 1, flops=3 * 2.0 * m * e * f)
        record("whole_layer_global", lambda: encoder_layer(x_bse, lp, 0, ctx, config), 0)
        if is_local[1]:
            record("whole_layer_local", lambda: encoder_layer(x_bse, lp_local, 1, ctx, config),
                   0)
        record(f"layers_x{config.n_layer}", lambda: _run_layers(x_bse, params, ctx, config), 0)

    per_layer = sum(p["us"] * p["per_layer_count"] for p in pieces.values())
    result = {
        "platform": dev.type,
        "shape": {"b": b, "s": s, "model": config.name, "n_layer": config.n_layer,
                  "ftype": "q4_0", "dtype": "bfloat16"},
        "full_forward_us": full_us,
        "pieces": pieces,
        "per_layer_us": per_layer,
        "accounted_us": config.n_layer * per_layer,
        "accounted_pct": 100.0 * config.n_layer * per_layer / full_us,
    }
    log(f"     per layer: {per_layer:9.1f} us x {config.n_layer} = "
        f"{result['accounted_us']:.1f} us ({result['accounted_pct']:.1f}% of the forward)")

    # --- the whole-forward A/B: attention kernels on and off --------------------
    pairs = list(zip(args.ab_shapes[::2], args.ab_shapes[1::2]))
    for bb, ss in pairs:
        for packed in (False, True):
            r = bench_forward_attn_impl(bb, ss, "modernbert-base", device=dev,
                                        ftype="q4_0", samples=args.ab_samples,
                                        packed=packed, layers=args.layers, vocab=args.vocab,
                                        params=params)
            key = f"forward_b{bb}_s{ss}" + ("_packed" if packed else "")
            result[key] = r
            arms = [k for k in r if isinstance(r[k], dict)]
            log(f"modernbert forward A/B b={bb} s={ss} {'packed' if packed else 'plain'}: "
                + " | ".join(f"{k} {r[k]['ms']:.3f}ms" for k in arms))
    result["device"] = device_block(dev)
    print(json.dumps(result))
    write_result(args.results or None, "modernbert_breakdown", result)
    return result


if __name__ == "__main__":
    main()
