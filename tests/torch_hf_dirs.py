"""Small HF checkpoint directories built in code (no downloads), one per
encoder family the converters read, for the port's converter tests.

Each is what `transformers` saves for a tiny random model (config.json,
pytorch_model.bin or model.safetensors) beside a tokenizer.json of the
family's kind, plus the family's extra files: a sentence-transformers
pooling / Dense / prompts set, SPLADE's modules.json, ColBERT's
artifact.metadata and projection.  nomic-bert has no `transformers` class:
its directory is a config.json and a state dict of the schema's names.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _tokenizer(kind: str) -> bytes:
    from embedding_cpp_tpu_torch.tokenizer import testvocab

    if kind == "bpe":
        return testvocab.build_bpe_tokenizer_json(600)
    if kind == "unigram":
        return testvocab.build_unigram_tokenizer_json(600)
    return testvocab.build_tokenizer_json(1000)


def vocab_size(tokenizer_json: bytes) -> int:
    spec = json.loads(tokenizer_json)
    vocab = spec["model"]["vocab"]
    ids = list(vocab.values()) if isinstance(vocab, dict) else [len(vocab) - 1]
    return max(ids + [t["id"] for t in spec.get("added_tokens", [])]) + 1


def _bert(t, n):
    return t.BertConfig(vocab_size=n, max_position_embeddings=128, **TINY)


def _roberta(t, n, cls="RobertaConfig"):
    return getattr(t, cls)(vocab_size=n, max_position_embeddings=130, type_vocab_size=1,
                           layer_norm_eps=1e-5, pad_token_id=1, **TINY)


def _deberta(t, n):
    return t.DebertaV2Config(vocab_size=n, max_position_embeddings=128, type_vocab_size=0,
                             layer_norm_eps=1e-7, relative_attention=True, position_buckets=32,
                             max_relative_positions=128, pos_att_type="p2c|c2p",
                             position_biased_input=False, share_att_key=True,
                             norm_rel_ebd="layer_norm", pooler_dropout=0.0, **TINY)


def _modernbert(t, n):
    return t.ModernBertConfig(vocab_size=n, hidden_size=64, num_hidden_layers=4,
                              num_attention_heads=4, intermediate_size=128,
                              max_position_embeddings=128, global_attn_every_n_layers=3,
                              local_attention=16, global_rope_theta=160000.0,
                              local_rope_theta=10000.0, norm_eps=1e-5, attention_dropout=0.0,
                              mlp_dropout=0.0, embedding_dropout=0.0, reference_compile=False,
                              pad_token_id=1, classifier_pooling="mean")


def _t5(t, n, ff="relu"):
    return t.T5Config(vocab_size=n, d_model=64, d_kv=16, d_ff=128, num_layers=2, num_heads=4,
                      relative_attention_num_buckets=32, dropout_rate=0.0,
                      layer_norm_epsilon=1e-6, feed_forward_proj=ff)


# name -> (config builder, model class, tokenizer kind)
FAMILIES = {
    "bert": (_bert, "BertModel", "wordpiece"),
    "bert-reranker": (_bert, "BertForSequenceClassification", "wordpiece"),
    "splade": (_bert, "BertForMaskedLM", "wordpiece"),
    "colbert": (_bert, "BertModel", "wordpiece"),
    "st-dense": (_bert, "BertModel", "wordpiece"),
    "distilbert": (lambda t, n: t.DistilBertConfig(vocab_size=n, dim=64, n_layers=2, n_heads=4,
                                                   hidden_dim=128, max_position_embeddings=128,
                                                   dropout=0.0, attention_dropout=0.0),
                   "DistilBertModel", "wordpiece"),
    "distilbert-reranker": (lambda t, n: t.DistilBertConfig(
        vocab_size=n, dim=64, n_layers=2, n_heads=4, hidden_dim=128,
        max_position_embeddings=128, dropout=0.0, attention_dropout=0.0, seq_classif_dropout=0.0),
        "DistilBertForSequenceClassification", "wordpiece"),
    "roberta": (_roberta, "RobertaModel", "bpe"),
    "roberta-splade": (_roberta, "RobertaForMaskedLM", "bpe"),
    "roberta-reranker": (_roberta, "RobertaForSequenceClassification", "bpe"),
    "xlmr": (lambda t, n: _roberta(t, n, "XLMRobertaConfig"), "XLMRobertaModel", "unigram"),
    "camembert": (lambda t, n: _roberta(t, n, "CamembertConfig"), "CamembertModel", "unigram"),
    "mpnet": (lambda t, n: t.MPNetConfig(vocab_size=n, max_position_embeddings=130,
                                         layer_norm_eps=1e-5, **TINY), "MPNetModel", "wordpiece"),
    "modernbert": (_modernbert, "ModernBertModel", "bpe"),
    "modernbert-reranker": (_modernbert, "ModernBertForSequenceClassification", "bpe"),
    "albert": (lambda t, n: t.AlbertConfig(vocab_size=n, embedding_size=32,
                                           max_position_embeddings=128, **{**TINY,
                                                                          "num_hidden_layers": 3}),
               "AlbertModel", "wordpiece"),
    "albert-reranker": (lambda t, n: t.AlbertConfig(vocab_size=n, embedding_size=32,
                                                    max_position_embeddings=128,
                                                    classifier_dropout_prob=0.0, **TINY),
                        "AlbertForSequenceClassification", "wordpiece"),
    "t5": (_t5, "T5EncoderModel", "unigram"),
    "t5-gated": (lambda t, n: _t5(t, n, "gated-gelu"), "T5EncoderModel", "unigram"),
    "electra": (lambda t, n: t.ElectraConfig(vocab_size=n, embedding_size=32,
                                             max_position_embeddings=128, **TINY),
                "ElectraModel", "wordpiece"),
    "electra-reranker": (lambda t, n: t.ElectraConfig(vocab_size=n, embedding_size=64,
                                                      max_position_embeddings=128, **TINY),
                         "ElectraForSequenceClassification", "wordpiece"),
    "deberta": (_deberta, "DebertaV2Model", "unigram"),
    "deberta-reranker": (_deberta, "DebertaV2ForSequenceClassification", "unigram"),
    "nomic": (None, "NomicBertModel", "wordpiece"),
}

NOMIC_HF = dict(model_type="nomic_bert", architectures=["NomicBertModel"], n_embd=64, n_layer=2,
                n_head=4, n_inner=128, n_positions=256, rotary_emb_fraction=1.0,
                rotary_emb_base=1000, rotary_scaling_factor=2.0, max_trained_positions=128,
                qkv_proj_bias=False, mlp_fc1_bias=False, mlp_fc2_bias=False,
                activation_function="swiglu", layer_norm_epsilon=1e-12, type_vocab_size=2)


def hf_config_dict(family: str, n_vocab: int = 1000) -> dict:
    """The config.json content of `family`'s tiny checkpoint."""
    build, model_cls, _ = FAMILIES[family]
    if build is None:
        return {**NOMIC_HF, "vocab_size": n_vocab}
    import transformers

    cfg = build(transformers, n_vocab)
    cfg.architectures = ["HF_ColBERT" if family == "colbert" else model_cls]
    return json.loads(cfg.to_json_string())


def _state_dict(family: str, hf: dict, seed: int) -> dict:
    """{name: torch tensor} of a tiny random model of `family`."""
    import torch

    if family == "nomic":
        from embedding_cpp_tpu_torch.models.config import BertConfig
        from embedding_cpp_tpu_torch.models.params import random_state_dict

        config = BertConfig.from_hf_config(hf)
        return {k: torch.from_numpy(v) for k, v in random_state_dict(config, seed).items()}
    import transformers

    torch.manual_seed(seed)
    build, model_cls, _ = FAMILIES[family]
    model = getattr(transformers, model_cls)(build(transformers, hf["vocab_size"])).eval()
    sd = dict(model.state_dict())
    if family == "colbert":
        sd["linear.weight"] = torch.randn(32, 64) * 0.02
    return sd


def write_weights(directory: Path, sd: dict, fmt: str) -> None:
    """`sd` as pytorch_model.bin ("bin") or model.safetensors in f32
    ("safetensors") or bf16 ("bf16"); tied views are copied apart."""
    import torch

    if fmt == "bin":
        torch.save(sd, directory / "pytorch_model.bin")
        return
    from safetensors.torch import save_file

    dtype = torch.bfloat16 if fmt == "bf16" else None
    save_file({k: (v.to(dtype) if dtype and v.is_floating_point() else v).clone().contiguous()
               for k, v in sd.items()}, str(directory / "model.safetensors"))


def make_hf_dir(root: Path, family: str, *, fmt: str = "bin", seed: int = 0,
                tokenizer_json: bytes | None = None) -> Path:
    """Write `family`'s tiny checkpoint directory under `root` (weights as
    `write_weights` takes `fmt`) and return it."""
    tokenizer_json = tokenizer_json or _tokenizer(FAMILIES[family][2])
    hf = hf_config_dict(family, vocab_size(tokenizer_json))
    d = Path(root) / f"hf-{family}-{fmt}"
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(hf))
    (d / "tokenizer.json").write_bytes(tokenizer_json)
    write_weights(d, _state_dict(family, hf, seed), fmt)
    if family in ("splade", "roberta-splade"):
        (d / "modules.json").write_text(json.dumps([
            {"idx": 0, "name": "0", "path": "", "type": "sentence_transformers.sparse_encoder."
             "models.MLMTransformer"},
            {"idx": 1, "name": "1", "path": "1_SpladePooling",
             "type": "sentence_transformers.sparse_encoder.models.SpladePooling"}]))
    if family == "colbert":
        (d / "artifact.metadata").write_text(json.dumps(
            {"query_maxlen": 16, "mask_punctuation": True, "dim": 32}))
    if family == "st-dense":
        import torch

        (d / "1_Pooling").mkdir(exist_ok=True)
        (d / "1_Pooling" / "config.json").write_text(json.dumps(
            {"word_embedding_dimension": 64, "pooling_mode_cls_token": True}))
        dense = d / "2_Dense"
        dense.mkdir(exist_ok=True)
        (dense / "config.json").write_text(json.dumps(
            {"in_features": 64, "out_features": 48,
             "activation_function": "torch.nn.modules.activation.Tanh"}))
        g = torch.Generator().manual_seed(seed + 1)
        torch.save({"linear.weight": torch.randn(48, 64, generator=g) * 0.05,
                    "linear.bias": torch.randn(48, generator=g) * 0.05},
                   dense / "pytorch_model.bin")
        (d / "config_sentence_transformers.json").write_text(json.dumps(
            {"prompts": {"query": "query: ", "passage": "passage: ", "empty": ""},
             "default_prompt_name": "query"}))
        (d / "special_tokens_map.json").write_text(json.dumps(
            {"unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]",
             "cls_token": {"content": "[CLS]"}}))
    return d


def upcast_bf16(sd: dict) -> dict:
    """`sd` rounded to bf16 and back to f32, as a bf16 checkpoint holds it."""
    import torch

    return {k: v.to(torch.bfloat16).float() if v.is_floating_point() else v
            for k, v in sd.items()}


def random_rows(n: int, s: int, n_vocab: int, seed: int) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(5, n_vocab, size=int(rng.integers(2, s))).tolist() for _ in range(n)]
