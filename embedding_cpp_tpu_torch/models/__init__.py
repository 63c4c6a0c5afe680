"""BERT-graph (BERT, RoBERTa/XLM-R, DistilBERT, ELECTRA, MPNet, ALBERT), T5,
ModernBERT, DeBERTa and nomic-bert encoders: configuration, tensor schema,
parameters, forward and the cross-encoder score path."""
from .bert import ComputeOptions, bert_embed_batch, bert_embed_packed, bert_score_batch
from .config import (
    ALBERT_BASE,
    BGE_LARGE_EN,
    DEBERTA_V3_BASE,
    ELECTRA_SMALL,
    GTR_BASE,
    MINILM_L6,
    MODERNBERT_BASE,
    MPNET_BASE,
    MS_MARCO_ELECTRA_BASE,
    MULTI_QA_DISTILBERT,
    MULTILINGUAL_E5_BASE,
    NOMIC_EMBED,
    BertConfig,
)
from .params import from_jax_params, load_params, random_params, random_state_dict

__all__ = [
    "ALBERT_BASE",
    "BGE_LARGE_EN",
    "DEBERTA_V3_BASE",
    "ELECTRA_SMALL",
    "GTR_BASE",
    "MINILM_L6",
    "MODERNBERT_BASE",
    "MPNET_BASE",
    "MS_MARCO_ELECTRA_BASE",
    "MULTILINGUAL_E5_BASE",
    "MULTI_QA_DISTILBERT",
    "NOMIC_EMBED",
    "BertConfig",
    "ComputeOptions",
    "bert_embed_batch",
    "bert_embed_packed",
    "bert_score_batch",
    "from_jax_params",
    "load_params",
    "random_params",
    "random_state_dict",
]
