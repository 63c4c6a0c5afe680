"""The card's parity record for the bias and window attention kernels at
family geometry.

The port's copy of the JAX package's `benchmarks/attn_bias_smoke.py`: each
case runs the kernel at a family's production geometry and holds it
against a plain einsum reference written here (the counterpart of the JAX
script's `_xla_attn` and of its DeBERTa einsum sequence), by the largest
absolute difference over the valid query rows, at the JAX script's
tolerance 0.06 (a bf16 PV product over S <= 2048 keys errs by about
sqrt(S) * 2^-8):

- K5 (`flash_attention`, the long-row body) with a per-head [H, S, S]
  bias at MPNet / gtr-base geometry (8, 512, 12, 64), at (8, 384, 12, 64)
  and at MiniLM's heads (8, 512, 12, 32);
- K4 (`flash_attention_bias_bse`, the projection layout) with the same
  bias at (8, 512, 12, 64) and (8, 384, 12, 64);
- K5 with a head-invariant [1, S, S] window bias (ModernBERT's global
  window form) at (8, 512, 12, 64);
- K7 (`flash_attention_local`, ModernBERT's local layers) at S 1024 and
  2048, window 128;
- K9 (`disentangled_attention`) at deberta-v3-base geometry, S 512 and 384
  (span 256), and at span 32, S 128.

Every key row past 3/4 of S is padding, as in the JAX script.  On the CPU
(`--device cpu`) the wrappers run their plain versions, so the run checks
the reference and the plain versions against each other; `--scale` divides
every batch and sequence length for such a run.  The script exits 1 when
a case misses.

    python -m embedding_cpp_tpu_torch.benchmarks.attn_bias_smoke [--device cpu]
        [--scale 1] [--results DIR]

Without `--device` it needs a card.  The last line of standard output is
the JSON object, with `ok`, `tolerance`, the cases and a `device` entry;
`--results` (default `bench_results/`, which git ignores) also gets it as
attn_bias_smoke.json.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .forward_breakdown import RESULTS

TOLERANCE = 0.06  # bf16 PV dot over S <= 2048 keys: |err| ~ sqrt(S) * 2^-8


def reference_attention(q, k, v, mask_bias, pos_bias=None, window=None):
    """softmax(q.k^T / sqrt(d) + key bias [+ pos_bias] [+ window bias]) v by
    einsum, f32 scores, p cast to q's dtype, f32 PV: q/k/v [B, S, H, d],
    mask_bias [B, S], pos_bias [H|1, S, S] -> [B, S, H, d]."""
    import torch

    d = q.shape[-1]
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / d**0.5)
    sc = sc + mask_bias[:, None, None, :]
    if pos_bias is not None:
        sc = sc + pos_bias
    if window is not None:
        pos = torch.arange(q.shape[1], device=q.device)
        inside = (pos[:, None] - pos[None, :]).abs() <= window // 2
        sc = sc + torch.where(inside, 0.0, -1e9)
    p = torch.softmax(sc, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def reference_deberta(q, k, v, mask_bias, pos_k, pos_q, span: int, max_dist: int):
    """The JAX model's DeBERTa einsum sequence: (q.k + c2p gathered by
    bucket(q - k) + p2c gathered by the negated bucket, transposed) *
    1/sqrt(3d) + key bias, softmax, p cast, f32 PV."""
    import torch

    from ..ops.deberta_attention import deberta_log_bucket

    b, s, h, d = q.shape
    rel = deberta_log_bucket(np.arange(s)[:, None] - np.arange(s)[None, :], span, max_dist)
    c2p_pos = torch.from_numpy(np.clip(rel + span, 0, 2 * span - 1).astype(np.int64))
    p2c_pos = torch.from_numpy(np.clip(-rel + span, 0, 2 * span - 1).astype(np.int64))
    c2p_pos, p2c_pos = c2p_pos.to(q.device), p2c_pos.to(q.device)
    scale = 1.0 / float(np.sqrt(d * 3))
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    c2p = torch.einsum("bqhd,rhd->bhqr", q.float(), pos_k.float())
    sc = sc + torch.take_along_dim(c2p, c2p_pos[None, None], dim=-1) * scale
    p2c = torch.einsum("bkhd,rhd->bhkr", k.float(), pos_q.float())
    gathered = torch.take_along_dim(p2c, p2c_pos[None, None], dim=-1)
    sc = sc + gathered.transpose(-1, -2) * scale + mask_bias[:, None, None, :]
    p = torch.softmax(sc, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def _mae(a, b, valid_q: int | None = None) -> float:
    """max |a - b| over the valid query rows (padded queries attend only
    masked keys: both sides are arbitrary there, and pooling drops them)."""
    if valid_q is not None:
        a, b = a[:, :valid_q], b[:, :valid_q]
    return (a.float() - b.float()).abs().max().item()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the plain versions)")
    p.add_argument("--scale", type=int, default=1,
                   help="divide every batch and sequence length by this (a quick run)")
    p.add_argument("--results", default=str(RESULTS),
                   help="directory for attn_bias_smoke.json ('' for none)")
    args = p.parse_args(argv)

    import torch

    from ..ops.attention import flash_attention, flash_attention_bias_bse, flash_attention_local
    from ..ops.deberta_attention import disentangled_attention
    from ..runtime.engine import resolve_device
    from ..utils.profiling import device_block
    from .kernels import write_result

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    cases = {}

    def cut(b, s):
        return max(1, b // args.scale), max(8, s // args.scale)

    def qkv(b, s, h, d):
        q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
                   .to(dev, torch.bfloat16) for _ in range(3))
        mb = torch.zeros(b, s, device=dev)
        mb[:, (s * 3) // 4:] = -1e9
        return q, k, v, mb

    def record(name, err, shape):
        cases[name] = {"max_abs_err": err, "shape": shape}
        print(f"{name}: max|err| {err:.5f}", file=sys.stderr, flush=True)

    with torch.inference_mode():
        # --- [H, S, S] bias: mpnet-base / gtr-base geometry (K5) ------------------
        for name, (b, s, h, d) in {"bias_h_mpnet_base": (8, 512, 12, 64),
                                   "bias_h_mpnet_base_s384": (8, 384, 12, 64),
                                   "bias_h_minilm_d32": (8, 512, 12, 32)}.items():
            b, s = cut(b, s)
            q, k, v, mb = qkv(b, s, h, d)
            pb = torch.from_numpy(rng.normal(size=(h, s, s)).astype(np.float32)).to(dev)
            record(name, _mae(flash_attention(q, k, v, mb, pos_bias=pb),
                              reference_attention(q, k, v, mb, pos_bias=pb)), [b, s, h, d])
        # --- the projection layout with the bias (K4) ---------------------------
        for name, (b, s, h, d) in {"bias_bse_mpnet_base": (8, 512, 12, 64),
                                   "bias_bse_s384": (8, 384, 12, 64)}.items():
            b, s = cut(b, s)
            q, k, v, mb = qkv(b, s, h, d)
            pb = torch.from_numpy(rng.normal(size=(h, s, s)).astype(np.float32)).to(dev)
            got = flash_attention_bias_bse(*(t.reshape(b, s, h * d) for t in (q, k, v)), mb, pb,
                                           h)
            ref = reference_attention(q, k, v, mb, pos_bias=pb).reshape(b, s, h * d)
            record(name, _mae(got, ref), [b, s, h, d])
        # --- [1, S, S] head-invariant window bias (K5) ----------------------------
        b, s = cut(8, 512)
        h, d = 12, 64
        q, k, v, mb = qkv(b, s, h, d)
        pos = torch.arange(s, device=dev)
        pb1 = torch.where((pos[:, None] - pos[None, :]).abs() <= 64, 0.0, -1e9)[None]
        record("bias_1_head_invariant", _mae(flash_attention(q, k, v, mb, pos_bias=pb1),
                                             reference_attention(q, k, v, mb, pos_bias=pb1)),
               [b, s, h, d])
        # --- the sliding window (K7) ---------------------------------------------
        for name, (b, s, h, d, w) in {"local_s1024_w128": (4, 1024, 12, 64, 128),
                                      "local_s2048_w128": (2, 2048, 12, 64, 128)}.items():
            b, s = cut(b, s)
            s = max(512, s // 128 * 128)  # K7's slice: S % 128 == 0 and narrower than S
            q, k, v, mb = qkv(b, s, h, d)
            record(name, _mae(flash_attention_local(q, k, v, mb, w),
                              reference_attention(q, k, v, mb, window=w), (s * 3) // 4),
                   [b, s, h, d])
        # --- disentangled attention (K9) -----------------------------------------
        for name, (b, s, h, d, span, max_dist) in {
                "deberta_v3_base_s512": (4, 512, 12, 64, 256, 512),
                "deberta_v3_base_s384": (4, 384, 12, 64, 256, 512),
                "deberta_small_span_s128": (4, 128, 12, 64, 32, 128)}.items():
            b, s = cut(b, s)
            q, k, v, mb = qkv(b, s, h, d)
            pos_k, pos_q = (torch.from_numpy(rng.normal(size=(2 * span, h, d))
                                             .astype(np.float32)).to(dev, torch.bfloat16)
                            for _ in range(2))
            got = disentangled_attention(q, k, v, mb, pos_k, pos_q, span, max_dist)
            ref = reference_deberta(q, k, v, mb, pos_k, pos_q, span, max_dist)
            record(name, _mae(got, ref, (s * 3) // 4), [b, s, h, d])
            if dev.type == "cuda":
                torch.cuda.empty_cache()

    ok = all(c["max_abs_err"] < TOLERANCE for c in cases.values())
    result = {"platform": dev.type, "cases": cases, "tolerance": TOLERANCE, "ok": ok,
              "device": device_block(dev)}
    print(json.dumps(result))
    write_result(args.results or None, "attn_bias_smoke", result)
    if not ok:
        sys.exit(1)
    return result


if __name__ == "__main__":
    main()
