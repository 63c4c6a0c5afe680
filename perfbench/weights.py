"""Random model weights drawn from the seed, as raw GGUF blocks.

Every matrix (2-D `.weight`, embedding tables included, as the port's
converter quantizes a Q8_0 / Q4_0 file) is drawn as raw blocks: int8 codes
(Q8_0) or packed nibbles (Q4_0) uniform over their range, and an f16
scale per 32-weight block, uniform in [0.5, 1.5] x the scale that gives
the weights a standard deviation of 0.02.  Norm scales are 1 + 0.1 N(0, 1)
and biases 0.02 N(0, 1), in f32.  All of it comes from one
`torch.Generator` on the device, in three calls (codes, block scales,
vectors), so the same seed gives the same bytes on that device and the
reference can draw them again after the program has been freed.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from . import gguf_file
from .reference import arch_module

# the std of one code: uniform int8 on [-127, 127]; a nibble minus 8
_CODE_STD = {"q8_0": float(np.sqrt((255 ** 2 - 1) / 12)), "q4_0": float(np.sqrt((16 ** 2 - 1) / 12))}
WEIGHT_STD = 0.02


def _split(flat: torch.Tensor, sizes: list[int]) -> list[torch.Tensor]:
    return list(torch.split(flat, sizes)) if sizes else []


def draw(config: dict, seed: int, device) -> dict[str, tuple[str, torch.Tensor]]:
    """{name: ("blocks", [n_blocks, block_bytes] uint8) or ("f32", tensor)}
    of the configuration's tensors, on `device`, from `seed`."""
    specs = arch_module(config["arch"]).tensors(config)
    qtype = config["qtype"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    mats = [(n, s) for n, s, kind in specs if kind == "matrix"]
    vecs = [(n, s, kind) for n, s, kind in specs if kind != "matrix"]
    nblk = [int(np.prod(s)) // 32 for _, s in mats]
    total = sum(nblk)
    if qtype == "q8_0":
        codes = torch.randint(-127, 128, (total, 32), generator=g, device=device,
                              dtype=torch.int8).view(torch.uint8)
    else:
        codes = torch.randint(0, 256, (total, 16), generator=g, device=device,
                              dtype=torch.uint8)
    scales = torch.rand(total, generator=g, device=device) + 0.5
    scales = (scales * (WEIGHT_STD / _CODE_STD[qtype])).to(torch.float16)
    blocks = torch.cat([scales.view(torch.uint8).reshape(total, 2), codes], dim=1)
    vsizes = [int(np.prod(s)) for _, s, _ in vecs]
    noise = torch.randn(sum(vsizes), generator=g, device=device)
    out = {}
    for (name, _), b in zip(mats, _split(blocks, nblk)):
        out[name] = ("blocks", b)
    for (name, shape, kind), v in zip(vecs, _split(noise, vsizes)):
        v = 1.0 + 0.1 * v if kind == "scale" else 0.02 * v
        out[name] = ("f32", v.reshape(shape))
    return out


def gguf_kv(config: dict, vocab) -> list[tuple[str, int, object]]:
    """The file's kv: the `bert.*` hyperparameters the port's loader reads,
    ModernBERT's family keys, the tokenizer (its tokenizer.json, token list
    and special ids) and the prompts."""
    g = gguf_file
    e, h = config["hidden_size"], config["num_attention_heads"]
    kv = [
        ("general.architecture", g.STRING, config["arch"]),
        ("general.name", g.STRING, config["name"]),
        ("general.file_type", g.U32, g.FILE_TYPE[config["qtype"]]),
        ("bert.context_length", g.U32, config["max_position_embeddings"]),
        ("bert.embedding_length", g.U32, e),
        ("bert.block_count", g.U32, config["num_hidden_layers"]),
        ("bert.feed_forward_length", g.U32, config["intermediate_size"]),
        ("bert.rope.dimension_count", g.U32, e // h),
        ("bert.attention.head_count", g.U32, h),
        ("bert.attention.head_count_kv", g.U32, h),
        ("bert.attention.layer_norm_epsilon", g.F32, config["layer_norm_eps"]),
        ("bert.pooling_type", g.STRING, config["pooling"]),
    ]
    if config["arch"] == "modernbert":
        kv += [
            ("bert.token_type_count", g.U32, 0),
            ("bert.position_offset", g.U32, 0),
            ("bert.rope.freq_base", g.F32, config["global_rope_theta"]),
            ("bert.rope.freq_base_local", g.F32, config["local_rope_theta"]),
            ("bert.attention.global_every_n_layers", g.U32,
             config["global_attn_every_n_layers"]),
            ("bert.attention.local_window", g.U32, config["local_attention"]),
        ]
    if config.get("prompts"):
        kv.append(("bert.prompts", g.STRING, json.dumps(config["prompts"])))
    sp = vocab.special
    kv += [
        ("tokenizer.ggml.model", g.STRING, "bert" if vocab.kind == "wordpiece" else "gpt2"),
        ("tokenizer.ggml.tokens", g.ARRAY, (g.STRING, vocab.tokens)),
        ("tokenizer.ggml.unknown_token_id", g.U32, sp["unk"]),
        ("tokenizer.ggml.seperator_token_id", g.U32, sp["sep"]),
        ("tokenizer.ggml.padding_token_id", g.U32, sp["pad"]),
        ("tokenizer.ggml.cls_token_id", g.U32, sp["cls"]),
        ("blob.tokenizer.json", g.STRING, vocab.tokenizer_json),
    ]
    return kv


def write_model(path: str, config: dict, vocab, drawn: dict) -> int:
    """Write the GGUF of the drawn weights; returns its size in bytes."""
    specs = arch_module(config["arch"]).tensors(config)
    gtype = gguf_file.GGML_TYPE[config["qtype"]]
    tensors = []
    for name, shape, _ in specs:
        kind, t = drawn[name]
        raw = t.cpu().numpy()
        if kind == "blocks":
            tensors.append((name, shape, gtype, raw.reshape(-1)))
        else:
            tensors.append((name, shape, gguf_file.GGML_F32, raw.astype(np.float32)))
    return gguf_file.write_gguf(path, gguf_kv(config, vocab), tensors)
