"""BERT and ModernBERT encoders: configuration, tensor schema, parameters
and forward."""
from .bert import ComputeOptions, bert_embed_batch, bert_embed_packed
from .config import MINILM_L6, MODERNBERT_BASE, BertConfig
from .params import from_jax_params, load_params, random_params, random_state_dict

__all__ = [
    "MINILM_L6",
    "MODERNBERT_BASE",
    "BertConfig",
    "ComputeOptions",
    "bert_embed_batch",
    "bert_embed_packed",
    "from_jax_params",
    "load_params",
    "random_params",
    "random_state_dict",
]
