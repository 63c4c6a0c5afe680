"""Write a synthetic GGUF model: random weights from a seed and a synthetic
vocabulary, so every surface runs without downloads.

    python -m embedding_cpp_tpu_torch.cli.make_test_model out.gguf \\
        [--preset tiny|minilm-l6|...] [--ftype f32|f16|q4_0|q4_1|q8_0] [--seed 0]

The same presets as the JAX package's `make_test_model`, and for the same
preset, ftype, seed and vocabulary the same file, byte for byte.  The
roberta and modernbert presets carry a byte-level BPE vocabulary, tiny-xlmr,
t5 and deberta a Unigram one (both trained with the HF `tokenizers`
library, which must then be installed); the rest WordPiece.
"""
from __future__ import annotations

import argparse
import json
from dataclasses import replace

from ..models.config import (
    BERT_BASE,
    DEBERTA_V3_BASE,
    GTR_BASE,
    MINILM_L6,
    MINILM_L12,
    MODERNBERT_BASE,
    MPNET_BASE,
    NOMIC_EMBED,
    BertConfig,
)
from ..models.convert import FTYPE_NAMES, _vocab_token_id, write_bert_gguf
from ..models.params import random_state_dict
from ..tokenizer.testvocab import (
    build_bpe_tokenizer_json,
    build_tokenizer_json,
    build_unigram_tokenizer_json,
)

_TINY = dict(n_ctx=128, n_embd=64, n_layer=2, n_head=4, n_ff=128)
_MODERNBERT = dict(n_token_types=0, arch="modernbert", layer_norm_eps=1e-5,
                   rope_theta=160000.0, local_rope_theta=10000.0, global_attn_every=3,
                   local_window=16)
_DEBERTA = dict(n_token_types=0, arch="deberta", layer_norm_eps=1e-7, rel_attn_buckets=32,
                rel_attn_max_dist=128)
_ROBERTA = dict(layer_norm_eps=1e-5, n_token_types=1, arch="roberta", pos_offset=2)

PRESETS = {
    "tiny": BertConfig(n_vocab=1000, **_TINY, name="tiny-test"),
    "tiny-roberta": BertConfig(n_vocab=600, **_TINY, **_ROBERTA, name="tiny-roberta-test"),
    # XLM-R: RoBERTa's encoder with a Unigram vocabulary
    "tiny-xlmr": BertConfig(n_vocab=600, **_TINY, **_ROBERTA, name="tiny-xlmr-test"),
    "tiny-distilbert": BertConfig(n_vocab=1000, **_TINY, n_token_types=0, arch="distilbert",
                                  name="tiny-distilbert-test"),
    # MPNet tokenizes with WordPiece behind RoBERTa-style specials
    "tiny-mpnet": BertConfig(n_vocab=1000, **_TINY, n_token_types=0, arch="mpnet",
                             pos_offset=2, rel_attn_buckets=32, name="tiny-mpnet-test"),
    # 4 layers cover the global/local alternation (g, l, l, g)
    "tiny-modernbert": BertConfig(n_vocab=600, **{**_TINY, "n_layer": 4}, **_MODERNBERT,
                                  name="tiny-modernbert-test"),
    "tiny-t5": BertConfig(n_vocab=600, **_TINY, n_token_types=0, arch="t5",
                          layer_norm_eps=1e-6, rel_attn_buckets=32, n_head_dim=16,
                          ffn_act="relu", name="tiny-t5-test"),
    "tiny-deberta": BertConfig(n_vocab=600, **_TINY, **_DEBERTA, name="tiny-deberta-test"),
    "tiny-deberta-reranker": BertConfig(n_vocab=600, **_TINY, **_DEBERTA, n_labels=1,
                                        head_activation="gelu",
                                        name="tiny-deberta-reranker-test"),
    # one shared layer applied 3 times, tables 32 wide projected to 64
    "tiny-albert": BertConfig(n_vocab=1000, **{**_TINY, "n_layer": 3}, arch="albert",
                              gelu="tanh", n_embd_emb=32, name="tiny-albert-test"),
    "tiny-electra": BertConfig(n_vocab=1000, **_TINY, arch="electra", n_embd_emb=32,
                               name="tiny-electra-test"),
    "tiny-splade": BertConfig(n_vocab=1000, **_TINY, mlm_head=True, name="tiny-splade-test"),
    "tiny-reranker": BertConfig(n_vocab=1000, **_TINY, n_labels=1, name="tiny-reranker-test"),
    "tiny-modernbert-reranker": BertConfig(
        n_vocab=600, **{**_TINY, "n_layer": 4}, **_MODERNBERT, n_labels=1,
        head_activation="gelu", pooling="cls", name="tiny-modernbert-reranker-test"),
    # n_ctx past rope_max_trained exercises the dynamic-NTK scaling
    "tiny-nomic": BertConfig(n_vocab=1000, **{**_TINY, "n_ctx": 256}, arch="nomic-bert",
                             rope_theta=1000.0, rope_scaling_factor=2.0, rope_max_trained=128,
                             ffn_act="silu", ffn_gated=True, attn_bias=False, ffn_bias=False,
                             name="tiny-nomic-test"),
    # marker and mask ids are placeholders: make_test_model resolves them
    # from the vocabulary ([unused0] / [unused1] / [MASK]) as the converter does
    "tiny-colbert": BertConfig(n_vocab=300, **{**_TINY, "n_ctx": 64}, colbert_dim=32,
                               query_maxlen=16, mask_punctuation=True, q_marker_id=5,
                               d_marker_id=6, mask_id=4, name="tiny-colbert-test"),
    "minilm-l6": replace(MINILM_L6, n_vocab=1000, name="minilm-l6-synthetic"),
    "minilm-l12": replace(MINILM_L12, n_vocab=1000, name="minilm-l12-synthetic"),
    "bert-base": replace(BERT_BASE, n_vocab=1000, name="bert-base-synthetic"),
    "mpnet-base": replace(MPNET_BASE, n_vocab=1000, name="mpnet-base-synthetic"),
    "modernbert-base": replace(MODERNBERT_BASE, n_vocab=1000, name="modernbert-base-synthetic"),
    "gtr-base": replace(GTR_BASE, n_vocab=600, name="gtr-base-synthetic"),
    "nomic-embed-text": replace(NOMIC_EMBED, n_vocab=1000, name="nomic-embed-synthetic"),
    "deberta-base": replace(DEBERTA_V3_BASE, n_vocab=600, name="deberta-base-synthetic"),
}


def _preset_vocab(preset: str) -> tuple[BertConfig, bytes]:
    """The preset's config sized to its vocabulary, and the tokenizer.json:
    a trained BPE or Unigram vocabulary may come out smaller than asked."""
    config = PRESETS[preset]
    if preset == "tiny-xlmr" or config.arch in ("t5", "deberta"):
        tokenizer_json = build_unigram_tokenizer_json(config.n_vocab)
        spec = json.loads(tokenizer_json)
        n = max([len(spec["model"]["vocab"])]
                + [t["id"] + 1 for t in spec.get("added_tokens", [])])
        config = replace(config, n_vocab=n)
    elif config.arch in ("roberta", "modernbert"):
        tokenizer_json = build_bpe_tokenizer_json(config.n_vocab)
        spec = json.loads(tokenizer_json)
        ids = [*spec["model"]["vocab"].values(), *(t["id"] for t in spec.get("added_tokens", []))]
        config = replace(config, n_vocab=max(ids) + 1)
    else:
        tokenizer_json = build_tokenizer_json(config.n_vocab)
    if config.colbert_dim:
        config = replace(config, q_marker_id=_vocab_token_id(tokenizer_json, "[unused0]"),
                         d_marker_id=_vocab_token_id(tokenizer_json, "[unused1]"),
                         mask_id=_vocab_token_id(tokenizer_json, "[MASK]"))
    return config, tokenizer_json


def make_test_model(out_path: str, preset: str = "tiny", ftype: str = "f32",
                    seed: int = 0) -> None:
    config, tokenizer_json = _preset_vocab(preset)
    write_bert_gguf(out_path, config, random_state_dict(config, seed=seed), tokenizer_json,
                    FTYPE_NAMES[ftype])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("out")
    p.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    p.add_argument("--ftype", choices=sorted(FTYPE_NAMES), default="f32")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    make_test_model(args.out, args.preset, args.ftype, args.seed)
    print(f"wrote {args.preset} ({args.ftype}) model to {args.out}")


if __name__ == "__main__":
    main()
