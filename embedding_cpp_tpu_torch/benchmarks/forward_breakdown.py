"""Per-op accounting of the q4_0 MiniLM-L6 bf16 forward at [32, 512].

The port's copy of the JAX package's `benchmarks/forward_breakdown.py`.  In
one run it times the whole forward and every piece of it at its exact
production shape, and sets the sum of the pieces beside the whole:

- the whole forward (`bert_embed_batch`, pooling, head and output cast);
- embed+ln, once a forward;
- one q/k/v projection (K1, three a layer);
- attention in the projection layout [B, S, H*d] (K3, the path's) and in
  [B, S, H, d] (K5, the long-row body, beside it);
- the o projection with its residual add and LayerNorm;
- the FFN pair (up + gelu, down) with its residual add and LayerNorm;
- pool+head, once a forward;
- one whole layer, and the 6-layer stack.

Each piece is timed with CUDA events on resident tensors
(`kernels.forward_ms`), where the JAX script chained the piece in a
`fori_loop` and took off a dispatch floor.  The K1 and K3 / K5 pieces also
carry their bound (`utils.profiling.bound_ms`: each input read once, each
output written once) and the time of the one PyTorch call that computes the
same function (`torch.addmm` on the dequantized weight; SDPA with the
additive mask), a comparator that no model path calls.  The JSON line
ends with `per_layer_us`, `accounted_us` (embed + pool + n_layer x the
layer's pieces) and `accounted_pct` of the whole forward, as the JAX
script reports them.

    python -m embedding_cpp_tpu_torch.benchmarks.forward_breakdown [--device cpu]
        [--batch 32] [--seq 512] [--layers 6] [--samples 20] [--results DIR]

Without `--device` it needs a card.  The last line of standard output is
the JSON object, with a `device` entry (the card's name and power limit);
`--results` (default `bench_results/`, which git ignores) also gets it as
forward_breakdown.json.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[2] / "bench_results"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the plain versions)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--layers", type=int, default=None, help="cut the depth (default: 6)")
    p.add_argument("--vocab", type=int, default=None, help="cut the vocabulary")
    p.add_argument("--samples", type=int, default=20)
    p.add_argument("--results", default=str(RESULTS),
                   help="directory for forward_breakdown.json ('' for none)")
    args = p.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from ..models import ComputeOptions
    from ..models.bert import (
        _cast_output,
        _output_head,
        _run_layers,
        embed_tokens,
        encoder_layer,
        pool_normalize,
    )
    from ..ops.attention import MASK_BIAS, flash_attention, flash_attention_bse
    from ..ops.linear import linear
    from ..ops.q4_matmul import dequant_weight
    from ..runtime.engine import resolve_device
    from ..utils.profiling import device_block, peaks_for
    from .kernels import (
        _weight_bytes,
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
    config = preset_config("minilm-l6", args.layers, args.vocab)
    opts = ComputeOptions(dtype="bfloat16")
    b, s = args.batch, args.seq
    e, f, h = config.n_embd, config.n_ff, config.n_head
    d, m = e // h, b * s
    case = forward_case(config, b, s, dev, "q4_0")
    params = case["params"]
    lp = {k: v[0] for k, v in params["layers"].items()}
    ids, mask = case["ids"], case["mask"]
    mask_bias = torch.where(mask.to(torch.bool), 0.0, MASK_BIAS).to(torch.float32)
    gen = torch.Generator().manual_seed(0)
    x_bse = (torch.randn(b, s, e, generator=gen) * 0.1).to(dev, torch.bfloat16)
    x_me = x_bse.reshape(m, e)
    q0 = torch.randn(b, s, h, d, generator=gen).to(dev, torch.bfloat16)

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)

    pieces: dict[str, dict] = {}

    def record(name, fn, count, flops=None, nbytes=None, library=None):
        pieces[name] = time_piece(name, fn, dev, args.samples, count, peaks, flops, nbytes,
                                  library)

    with torch.inference_mode():
        # --- the whole forward (the number being accounted for) ---------------
        full_us = forward_ms(forward_fn(case, opts), dev, args.samples) * 1e3
        log(f"    full forward: {full_us:9.1f} us")

        # --- each piece at its production shape --------------------------------
        record("embed+ln", lambda: embed_tokens(params, ids, config, opts), 0)
        w_q, b_q = lp["q_w"], lp["q_b"]
        wd = dequant_weight(w_q, torch.bfloat16) if on_card else None
        record("qkv_proj", lambda: linear(x_me, w_q, b_q), 3, flops=2.0 * m * e * e,
               nbytes=m * e * 2 * 2 + _weight_bytes(w_q) + e * 4,
               library=lambda: torch.addmm(b_q.to(torch.bfloat16), x_me, wd))
        heads = [q0.transpose(1, 2).contiguous()] * 3
        amask = mask_bias.to(torch.bfloat16)[:, None, None, :]
        attn_flops, attn_bytes = 4.0 * b * h * s * s * d, 4 * b * s * e * 2 + b * s * 4
        record("attention_bhsd", lambda: flash_attention(q0, q0, q0, mask_bias), 0,
               flops=attn_flops, nbytes=attn_bytes,
               library=lambda: F.scaled_dot_product_attention(*heads, attn_mask=amask))
        xh = x_bse.view(b, s, h, d).transpose(1, 2).contiguous()
        record("attention", lambda: flash_attention_bse(x_bse, x_bse, x_bse, mask_bias, h), 1,
               flops=attn_flops, nbytes=attn_bytes,
               library=lambda: F.scaled_dot_product_attention(xh, xh, xh, attn_mask=amask))
        eps = config.layer_norm_eps
        record("o_proj+add&ln", lambda: linear(x_bse, lp["o_w"], lp["o_b"], residual=x_bse,
                                               ln=(lp["ln_att_scale"], lp["ln_att_bias"], eps)),
               1, flops=2.0 * m * e * e)

        def ffn():
            u = linear(x_bse, lp["ffn_up_w"], lp["ffn_up_b"], activation="gelu_erf")
            return linear(u, lp["ffn_down_w"], lp["ffn_down_b"], residual=x_bse,
                          ln=(lp["ln_out_scale"], lp["ln_out_bias"], eps))
        record("ffn_pair+add&ln", ffn, 1, flops=4.0 * m * e * f)
        record("pool+head", lambda: _cast_output(_output_head(
            pool_normalize(x_bse, mask, config.pooling, normalize=False), params, config),
            opts), 0)

        # --- composition levels: one whole layer, then the stack ----------------
        record("whole_layer", lambda: encoder_layer(x_bse, lp, mask_bias, config), 0)
        record(f"layers_x{config.n_layer}",
               lambda: _run_layers(x_bse, params["layers"], config, mask_bias), 0)

    per_layer = sum(p["us"] * p["per_layer_count"] for p in pieces.values())
    accounted = pieces["embed+ln"]["us"] + pieces["pool+head"]["us"] + config.n_layer * per_layer
    result = {
        "platform": dev.type,
        "shape": {"b": b, "s": s, "model": config.name, "n_layer": config.n_layer,
                  "ftype": "q4_0", "dtype": "bfloat16"},
        "full_forward_us": full_us,
        "pieces": pieces,
        "per_layer_us": per_layer,
        "accounted_us": accounted,
        "accounted_pct": 100.0 * accounted / full_us,
        "device": device_block(dev),
    }
    log(f"     per layer: {per_layer:9.1f} us x {config.n_layer}")
    log(f"     accounted: {accounted:9.1f} us of {full_us:.1f} us "
        f"({result['accounted_pct']:.1f}%)")
    print(json.dumps(result))
    write_result(args.results or None, "forward_breakdown", result)
    return result


if __name__ == "__main__":
    main()
