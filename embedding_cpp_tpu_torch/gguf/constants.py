"""GGUF format constants (the subset the BERT-family paths read and the
writer, converter and quantizer write).

The same format semantics as the JAX package's `gguf/constants.py`: key
names follow the GGUF BERT convention, tensor types follow ggml's
`ggml_type` enum.  Kept as a copy so this package imports nothing of the
JAX package.
"""
from __future__ import annotations

import enum

GGUF_MAGIC = b"GGUF"
GGUF_DEFAULT_ALIGNMENT = 32
GGUF_SUPPORTED_VERSIONS = (1, 2, 3)
# the version written: v2, what the reference's pinned ggml reads
GGUF_WRITE_VERSION = 2


class GGUFValueType(enum.IntEnum):
    """Metadata (kv) value types — GGUF spec."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """Tensor dtypes as stored in the GGUF tensor directory."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    I8 = 24
    I16 = 25
    I32 = 26


# Block geometry: (elements per block, bytes per block).
QK4 = 32
QK8 = 32
GGML_TYPE_SIZES: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.Q4_0: (QK4, 2 + QK4 // 2),  # f16 scale + 16 nibble bytes
    GGMLType.Q4_1: (QK4, 4 + QK4 // 2),  # f16 scale + f16 min + 16 bytes
    GGMLType.Q8_0: (QK8, 2 + QK8),  # f16 scale + 32 int8 codes
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
}


class GGUFTokenType(enum.IntEnum):
    """Vocabulary token types (`tokenizer.ggml.token_type`)."""

    UNDEFINED = 0
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6


class GGUFFileType(enum.IntEnum):
    """File-level quantization mode (`general.file_type`)."""

    ALL_F32 = 0
    MOSTLY_F16 = 1
    MOSTLY_Q4_0 = 2
    MOSTLY_Q4_1 = 3
    MOSTLY_Q8_0 = 7


FTYPE_TO_GGML = {
    GGUFFileType.ALL_F32: GGMLType.F32,
    GGUFFileType.MOSTLY_F16: GGMLType.F16,
    GGUFFileType.MOSTLY_Q4_0: GGMLType.Q4_0,
    GGUFFileType.MOSTLY_Q4_1: GGMLType.Q4_1,
    GGUFFileType.MOSTLY_Q8_0: GGMLType.Q8_0,
}

ARCH = "bert"


class Keys:
    """kv key names read by the BERT-family paths (every family
    keeps the `bert.*` prefix; `general.architecture` names the family)."""

    ARCHITECTURE = "general.architecture"
    ALIGNMENT = "general.alignment"
    NAME = "general.name"
    FILE_TYPE = "general.file_type"
    SOURCE_HF_REPO = "general.source_hf_repo"

    CONTEXT_LENGTH = f"{ARCH}.context_length"
    EMBEDDING_LENGTH = f"{ARCH}.embedding_length"
    BLOCK_COUNT = f"{ARCH}.block_count"
    FEED_FORWARD_LENGTH = f"{ARCH}.feed_forward_length"
    TENSOR_DATA_LAYOUT = f"{ARCH}.tensor_data_layout"
    HEAD_COUNT = f"{ARCH}.attention.head_count"
    HEAD_COUNT_KV = f"{ARCH}.attention.head_count_kv"
    ROPE_DIMENSION_COUNT = f"{ARCH}.rope.dimension_count"
    LAYER_NORM_EPS = f"{ARCH}.attention.layer_norm_epsilon"
    POOLING_TYPE = f"{ARCH}.pooling_type"
    NORMALIZE = f"{ARCH}.normalize_embeddings"
    DENSE_OUT = f"{ARCH}.dense_feat_out"
    DENSE_ACTIVATION = f"{ARCH}.dense_activation"
    TOKEN_TYPE_COUNT = f"{ARCH}.token_type_count"
    POSITION_OFFSET = f"{ARCH}.position_offset"
    GELU = f"{ARCH}.gelu_variant"
    # ALBERT and ELECTRA-small: the width of the factorized embedding
    # tables, which a linear projects up to embedding_length (absent: no
    # projection)
    EMB_WIDTH = f"{ARCH}.embedding_width"
    # T5: the per-head width d_kv where it is not embedding_length /
    # head_count (llama.cpp's name)
    HEAD_DIM = f"{ARCH}.attention.key_length"
    # ModernBERT: RoPE bases (global / local layers), the global-layer
    # period and the sliding-window width
    ROPE_FREQ_BASE = f"{ARCH}.rope.freq_base"
    ROPE_FREQ_BASE_LOCAL = f"{ARCH}.rope.freq_base_local"
    GLOBAL_ATTN_EVERY = f"{ARCH}.attention.global_every_n_layers"
    LOCAL_ATTN_WINDOW = f"{ARCH}.attention.local_window"
    # DeBERTa: the log-bucketed relative positions (buckets and far-field
    # cap), and the sequence-classification head of cross-encoder rerankers
    REL_ATTN_BUCKETS = f"{ARCH}.attention.relative_buckets"
    REL_ATTN_MAX_DIST = f"{ARCH}.attention.relative_max_distance"
    N_LABELS = f"{ARCH}.classifier.n_labels"
    HEAD_ACTIVATION = f"{ARCH}.classifier.activation"
    # nomic-bert: dynamic-NTK RoPE scaling past the trained length and the
    # checkpoint's bias layout; nomic-bert and T5: the FFN recipe
    ROPE_SCALING_FACTOR = f"{ARCH}.rope.scaling_factor"
    ROPE_MAX_TRAINED = f"{ARCH}.rope.max_trained_positions"
    ATTN_BIAS = f"{ARCH}.attention.bias"
    FFN_BIAS = f"{ARCH}.ffn_bias"
    FFN_ACT = f"{ARCH}.ffn_activation"
    FFN_GATED = f"{ARCH}.ffn_gated"
    # SPLADE: the file carries its MLM prediction head (sparse lexical
    # vectors instead of pooled embeddings)
    MLM_HEAD = f"{ARCH}.mlm_head"
    # ColBERT: the per-token projection width (absent: not ColBERT), the
    # [MASK]-augmented query length, punctuation filtering of document
    # tokens, and the [Q] / [D] marker and [MASK] ids the framing inserts
    COLBERT_DIM = f"{ARCH}.colbert.dim"
    COLBERT_QUERY_MAXLEN = f"{ARCH}.colbert.query_maxlen"
    COLBERT_MASK_PUNCT = f"{ARCH}.colbert.mask_punctuation"
    COLBERT_Q_MARKER = f"{ARCH}.colbert.query_marker_id"
    COLBERT_D_MARKER = f"{ARCH}.colbert.doc_marker_id"
    COLBERT_MASK_ID = f"{ARCH}.colbert.mask_token_id"
    # named prompt prefixes: a JSON object {name: prefix}, and the name
    # applied when the caller names none
    PROMPTS = f"{ARCH}.prompts"
    DEFAULT_PROMPT = f"{ARCH}.default_prompt_name"

    TOKENIZER_MODEL = "tokenizer.ggml.model"
    TOKENIZER_LIST = "tokenizer.ggml.tokens"
    TOKENIZER_TOKEN_TYPE = "tokenizer.ggml.token_type"
    TOKENIZER_SCORES = "tokenizer.ggml.scores"
    TOKENIZER_UNK_ID = "tokenizer.ggml.unknown_token_id"
    TOKENIZER_SEP_ID = "tokenizer.ggml.seperator_token_id"  # sic — GGUF spelling
    TOKENIZER_PAD_ID = "tokenizer.ggml.padding_token_id"
    TOKENIZER_CLS_ID = "tokenizer.ggml.cls_token_id"
    TOKENIZER_JSON_BLOB = "blob.tokenizer.json"


def ggml_nbytes(ggml_type: GGMLType, n_elements: int) -> int:
    """Byte size of a tensor with `n_elements` of the given type."""
    block_elems, block_bytes = GGML_TYPE_SIZES[ggml_type]
    if n_elements % block_elems:
        raise ValueError(
            f"{ggml_type.name}: {n_elements} elements not divisible by "
            f"block size {block_elems}"
        )
    return n_elements // block_elems * block_bytes


def align_offset(offset: int, alignment: int = GGUF_DEFAULT_ALIGNMENT) -> int:
    return (offset + alignment - 1) // alignment * alignment
