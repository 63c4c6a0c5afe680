"""HF checkpoint directory -> GGUF (and the legacy .bin) converter.

The JAX package's `models/convert.py`, file for file: the `bert.*` kv
schema with the family's own keys, the `tokenizer.ggml.*` vocabulary and
the whole tokenizer.json as the `blob.tokenizer.json` string, prompts,
classification-head and ColBERT keys; HF state-dict names verbatim, the
poolers and id buffers of embedding models dropped (`schema.SKIPPED_TENSORS`),
2-D `.weight` tensors cast to the file's type (a block type only where the
contraction axis is a whole number of blocks), everything else f32.

The reader half reads a local directory (no network): config.json, the
tokenizer, `model.safetensors` (parsed here: the card's machine has no
`safetensors` package) or `pytorch_model.bin`, a sentence-transformers
Dense module, pooling and prompts, SPLADE (modules.json) and ColBERT
(architectures, artifact.metadata) checkpoints, and a *ForMaskedLM
checkpoint's tied MLM head.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np

from ..gguf.constants import (
    FTYPE_TO_GGML,
    QK4,
    GGMLType,
    GGUFFileType,
    GGUFTokenType,
    GGUFValueType,
    Keys,
)
from ..gguf.quant import quantize
from ..gguf.writer import GGUFWriter
from .config import HEAD_ACT_DEFAULTS, BertConfig
from .params import FTYPE_NAMES
from .schema import (
    _MLM_TENSORS_BY_ARCH,
    MLM_TIED_TENSORS,
    SKIPPED_TENSORS,
    head_tensors,
    mlm_tensors,
)

__all__ = ["FTYPE_NAMES", "convert_hf_dir", "convert_hf_dir_to_legacy", "load_hf_dir",
           "load_safetensors", "special_ids_from_vocab", "write_bert_gguf"]

# special-token names tried when no special_tokens_map.json names them:
# BERT's WordPiece names, then RoBERTa's (<s> / </s> take the cls / sep roles)
_SPECIAL_TOKEN_NAMES = {"unk": ("[UNK]", "<unk>"), "sep": ("[SEP]", "</s>"),
                        "pad": ("[PAD]", "<pad>"), "cls": ("[CLS]", "<s>")}
# tokenizer.ggml.model: "bert" (WordPiece, the reference's value), "gpt2"
# (byte-level BPE), "t5" (Unigram); informational, the blob decides
_TOK_MODEL_NAMES = {"BPE": "gpt2", "Unigram": "t5"}


def special_ids_from_vocab(vocab: dict[str, int], overrides: dict | None = None) -> dict:
    """unk / sep / pad / cls ids from the vocab, `overrides` first."""
    ids = {}
    for key, candidates in _SPECIAL_TOKEN_NAMES.items():
        if overrides and key in overrides:
            ids[key] = int(overrides[key])
            continue
        for tok in candidates:
            if tok in vocab:
                ids[key] = int(vocab[tok])
                break
    return ids


def _vocab_tokens(tok: dict, n_vocab: int) -> tuple[list[bytes], list[float], dict]:
    """(token strings in id order, scores, piece -> id) of a tokenizer.json:
    WordPiece / BPE vocabs are dicts, Unigram's a [piece, score] list in id
    order with real scores (zeros elsewhere); added tokens fill ids the
    model's vocab leaves out."""
    vocab = tok["model"]["vocab"]
    scores = [0.0] * n_vocab
    if isinstance(vocab, list):
        id_to_token = {i: p for i, (p, _) in enumerate(vocab)}
        for i, (_, s) in enumerate(vocab[:n_vocab]):
            scores[i] = float(s)
        vocab = {p: i for i, p in id_to_token.items()}
    elif isinstance(vocab, dict):
        id_to_token = {int(i): t for t, i in vocab.items()}
    else:
        raise ValueError("tokenizer.json model.vocab must be a dict (WordPiece/BPE) "
                         "or a [piece, score] list (Unigram)")
    for added in tok.get("added_tokens", []):
        id_to_token.setdefault(int(added["id"]), added["content"])
    missing = next((i for i in range(n_vocab) if i not in id_to_token), None)
    if missing is not None:
        raise ValueError(f"vocab has no token for id {missing} (vocab_size {n_vocab})")
    return [id_to_token[i].encode("utf-8") for i in range(n_vocab)], scores, vocab


def _write_hparams(w: GGUFWriter, config: BertConfig) -> None:
    """The `bert.*` hyperparameters, with each non-BERT family's shape keys
    written explicitly (the reader needs no guessing)."""
    w.add_uint32(Keys.CONTEXT_LENGTH, config.n_ctx)
    w.add_uint32(Keys.EMBEDDING_LENGTH, config.n_embd)
    w.add_uint32(Keys.BLOCK_COUNT, config.n_layer)
    w.add_uint32(Keys.FEED_FORWARD_LENGTH, config.n_ff)
    w.add_uint32(Keys.ROPE_DIMENSION_COUNT, config.head_dim)
    w.add_uint32(Keys.HEAD_COUNT, config.n_head)
    w.add_uint32(Keys.HEAD_COUNT_KV, config.n_head)
    w.add_float32(Keys.LAYER_NORM_EPS, config.layer_norm_eps)
    if config.pooling != "mean":
        w.add_string(Keys.POOLING_TYPE, config.pooling)
    if not config.normalize:
        w.add_bool(Keys.NORMALIZE, False)
    if config.dense_out:
        w.add_uint32(Keys.DENSE_OUT, config.dense_out)
        w.add_string(Keys.DENSE_ACTIVATION, config.dense_activation)
    if config.n_labels:
        w.add_uint32(Keys.N_LABELS, config.n_labels)
        w.add_string(Keys.HEAD_ACTIVATION, config.head_activation)
    if config.mlm_head:
        w.add_bool(Keys.MLM_HEAD, True)
    if config.colbert_dim:
        w.add_uint32(Keys.COLBERT_DIM, config.colbert_dim)
        w.add_uint32(Keys.COLBERT_QUERY_MAXLEN, config.query_maxlen)
        w.add_bool(Keys.COLBERT_MASK_PUNCT, config.mask_punctuation)
        w.add_uint32(Keys.COLBERT_Q_MARKER, config.q_marker_id)
        w.add_uint32(Keys.COLBERT_D_MARKER, config.d_marker_id)
        w.add_uint32(Keys.COLBERT_MASK_ID, config.mask_id)


def _write_family_keys(w: GGUFWriter, config: BertConfig) -> None:
    arch = config.arch
    w.add_uint32(Keys.TOKEN_TYPE_COUNT, config.n_token_types)
    w.add_uint32(Keys.POSITION_OFFSET, config.pos_offset)
    if config.rel_attn_buckets:
        w.add_uint32(Keys.REL_ATTN_BUCKETS, config.rel_attn_buckets)
    if config.n_embd_emb:
        w.add_uint32(Keys.EMB_WIDTH, config.n_embd_emb)
    if arch in ("t5", "deberta"):
        w.add_uint32(Keys.REL_ATTN_MAX_DIST, config.rel_attn_max_dist)
    if arch == "t5":
        w.add_uint32(Keys.HEAD_DIM, config.head_dim)
        w.add_string(Keys.FFN_ACT, config.ffn_act or "relu")
        w.add_bool(Keys.FFN_GATED, config.ffn_gated)
    if config.gelu != ("tanh" if arch == "albert" else "erf"):
        w.add_string(Keys.GELU, config.gelu)  # only where it is not the default
    if arch == "modernbert":
        w.add_float32(Keys.ROPE_FREQ_BASE, config.rope_theta)
        w.add_float32(Keys.ROPE_FREQ_BASE_LOCAL, config.local_rope_theta)
        w.add_uint32(Keys.GLOBAL_ATTN_EVERY, config.global_attn_every)
        w.add_uint32(Keys.LOCAL_ATTN_WINDOW, config.local_window)
    if arch == "nomic-bert":
        w.add_float32(Keys.ROPE_FREQ_BASE, config.rope_theta)
        w.add_float32(Keys.ROPE_SCALING_FACTOR, config.rope_scaling_factor)
        w.add_uint32(Keys.ROPE_MAX_TRAINED, config.rope_max_trained)
        w.add_bool(Keys.ATTN_BIAS, config.attn_bias)
        w.add_bool(Keys.FFN_BIAS, config.ffn_bias)
        w.add_string(Keys.FFN_ACT, "silu")
        w.add_bool(Keys.FFN_GATED, True)


def write_bert_gguf(out_path: str | os.PathLike, config: BertConfig,
                    state_dict: dict[str, np.ndarray], tokenizer_json: bytes,
                    ftype: GGUFFileType = GGUFFileType.ALL_F32, *,
                    special_ids: dict | None = None, source_hf_repo: str = "",
                    prompts: dict[str, str] | None = None,
                    default_prompt_name: str = "") -> None:
    """Write a GGUF of `config` holding `state_dict` (HF names, f32-castable
    arrays) and the tokenizer, with `ftype`'s tensor policy."""
    tok = json.loads(tokenizer_json)
    tok_model = str(tok["model"].get("type", "WordPiece"))
    tokens, scores, vocab = _vocab_tokens(tok, config.n_vocab)
    sp = special_ids_from_vocab(vocab, special_ids)

    w = GGUFWriter()
    # every family keeps the `bert.` key prefix; general.architecture names it
    w.add_string(Keys.ARCHITECTURE, config.arch)
    w.add_string(Keys.NAME, config.name or Path(out_path).stem)
    if source_hf_repo:
        w.add_string(Keys.SOURCE_HF_REPO, source_hf_repo)
    w.add_string(Keys.TENSOR_DATA_LAYOUT, "")
    _write_hparams(w, config)
    if prompts:
        # a JSON object, so any name and any unicode survive the string kv
        w.add_string(Keys.PROMPTS, json.dumps(prompts, ensure_ascii=False))
        if default_prompt_name:
            w.add_string(Keys.DEFAULT_PROMPT, default_prompt_name)
    if config.arch != "bert":
        _write_family_keys(w, config)
    w.add_uint32(Keys.FILE_TYPE, int(ftype))
    w.add_string(Keys.TOKENIZER_JSON_BLOB, tokenizer_json)
    w.add_string(Keys.TOKENIZER_MODEL, _TOK_MODEL_NAMES.get(tok_model, "bert"))
    w.add_array(Keys.TOKENIZER_LIST, tokens, GGUFValueType.STRING)
    w.add_array(Keys.TOKENIZER_SCORES, scores, GGUFValueType.FLOAT32)
    w.add_array(Keys.TOKENIZER_TOKEN_TYPE, [int(GGUFTokenType.NORMAL)] * config.n_vocab,
                GGUFValueType.INT32)
    for key, kv_key in (("unk", Keys.TOKENIZER_UNK_ID), ("sep", Keys.TOKENIZER_SEP_ID),
                        ("pad", Keys.TOKENIZER_PAD_ID), ("cls", Keys.TOKENIZER_CLS_ID)):
        if key in sp:
            w.add_uint32(kv_key, sp[key])

    target = FTYPE_TO_GGML[ftype]
    # a classification model keeps its pooler: it is the head's dense layer
    skipped = SKIPPED_TENSORS - set(head_tensors(config))
    for name, data in state_dict.items():
        if name in skipped:
            continue
        arr = np.ascontiguousarray(np.asarray(data), dtype=np.float32)
        if arr.ndim > 2:
            # stray singleton dims only: a [1, E] table stays 2-D
            arr = np.squeeze(arr)
        if target != GGMLType.F32 and name.endswith(".weight") and arr.ndim == 2:
            if target == GGMLType.F16:
                w.add_tensor(name, arr.astype(np.float16))
            elif arr.shape[-1] % QK4:
                # a block must not straddle rows (MPNet's [32, H] bias table)
                w.add_tensor(name, arr)
            else:
                w.add_tensor_raw(name, arr.shape, target, quantize(arr.reshape(-1), target))
        else:
            w.add_tensor(name, arr)
    w.write(os.fspath(out_path))


# --- reading a checkpoint directory --------------------------------------------

# safetensors dtype names -> numpy (BF16 has none: read as bits, upcast)
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
              "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
              "U16": np.uint16, "U32": np.uint32, "U64": np.uint64, "BOOL": np.bool_}


def load_safetensors(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """A `.safetensors` file -> {name: numpy array}: an 8-byte little-endian
    header length, the JSON header ({name: {dtype, shape, data_offsets}},
    offsets relative to the end of the header), then the raw data.  Arrays
    keep their dtype, as `safetensors.numpy.load_file` gives them, but
    bfloat16, which numpy lacks: it is upcast to float32 (exactly) through
    torch."""
    import torch

    raw = Path(path).read_bytes()
    if len(raw) < 8:
        raise ValueError(f"{path}: truncated safetensors file")
    n = int.from_bytes(raw[:8], "little")
    if n > len(raw) - 8:
        raise ValueError(f"{path}: header length {n} past the end of the file")
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        shape = tuple(int(d) for d in info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(data[begin:end], dtype=np.uint16).reshape(shape)
            out[name] = torch.from_numpy(bits.copy()).view(torch.bfloat16).float().numpy()
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        out[name] = np.frombuffer(data[begin:end], _ST_DTYPES[info["dtype"]]).reshape(shape).copy()
    return out


def _load_weights(directory: Path, what: str) -> dict[str, np.ndarray]:
    """model.safetensors, else pytorch_model.bin (upcast to f32)."""
    st_path = directory / "model.safetensors"
    if st_path.is_file():
        return load_safetensors(st_path)
    pt_path = directory / "pytorch_model.bin"
    if pt_path.is_file():
        import torch

        sd = torch.load(str(pt_path), map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in sd.items()}
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in {what}")


def _read_json(path: Path, default=None):
    """A JSON file's content; `default` when it is absent or unreadable."""
    if not path.is_file():
        return default
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return default


def _detect_sparse(model_dir: Path) -> bool:
    """A sentence-transformers SparseEncoder: modules.json stacks
    MLMTransformer + SpladePooling (raw naver/splade-* ForMaskedLM
    directories have no modules.json and need sparse=True)."""
    modules = _read_json(model_dir / "modules.json")
    if not isinstance(modules, list):
        return False
    return any("SpladePooling" in str(m.get("type", "")) for m in modules if isinstance(m, dict))


def _vocab_token_id(tokenizer_json: bytes, token: str) -> int:
    """A token string's id in tokenizer.json (model.vocab, a dict or a
    Unigram piece list, then added_tokens); -1 when absent."""
    tok = json.loads(tokenizer_json)
    vocab = tok.get("model", {}).get("vocab", {})
    if isinstance(vocab, dict) and token in vocab:
        return int(vocab[token])
    if isinstance(vocab, list):
        for i, item in enumerate(vocab):
            if isinstance(item, (list, tuple)) and item and item[0] == token:
                return i
    for added in tok.get("added_tokens", []):
        if added.get("content") == token:
            return int(added["id"])
    return -1


# the encoder families and their task-head variants (models/schema.py)
_SUPPORTED = (
    "BertModel", "BertForMaskedLM", "DistilBertModel", "DistilBertForMaskedLM",
    "RobertaModel", "RobertaForMaskedLM", "XLMRobertaModel", "XLMRobertaForMaskedLM",
    "CamembertModel", "MPNetModel", "MPNetForMaskedLM", "ModernBertModel",
    "ModernBertForMaskedLM", "AlbertModel", "AlbertForMaskedLM",
    # T5 encoder stacks; seq2seq checkpoints lose their decoder
    "T5EncoderModel", "T5Model", "T5ForConditionalGeneration",
    "ElectraModel", "ElectraForPreTraining", "ElectraForMaskedLM",
    "BertForSequenceClassification", "DistilBertForSequenceClassification",
    "RobertaForSequenceClassification", "XLMRobertaForSequenceClassification",
    "CamembertForSequenceClassification", "MPNetForSequenceClassification",
    "ModernBertForSequenceClassification", "AlbertForSequenceClassification",
    "ElectraForSequenceClassification",
    "DebertaV2Model", "DebertaV2ForMaskedLM", "DebertaV2ForSequenceClassification",
    "NomicBertModel", "HF_ColBERT", "ColBERT",
)
# base-model prefixes of the task checkpoints ("model." is ModernBERT's)
_PREFIXES = ("bert.", "distilbert.", "roberta.", "mpnet.", "model.", "albert.", "electra.",
             "deberta.")
# task heads dropped from an encoder: BERT's cls.*, RoBERTa/MPNet's lm_head.*,
# DistilBERT's vocab_*, ALBERT's predictions.*, ELECTRA's and DeBERTa-v3's
_HEADS = ("cls.", "lm_head.", "vocab_transform.", "vocab_layer_norm.", "vocab_projector.",
          "decoder.", "predictions.", "discriminator_predictions.", "generator_predictions.",
          "generator_lm_head.", "lm_predictions.", "mask_predictions.")


def load_hf_dir(model_dir: str | os.PathLike, *, sparse: bool | None = None,
                colbert: bool | None = None):
    """A local HF checkpoint directory -> (config, state_dict,
    tokenizer_json, special-id overrides, HF repo name, (prompts, default
    prompt name)).

    sparse: keep the MLM head as the model's output (SPLADE; None detects
    it from modules.json).  colbert: keep the per-token `linear.weight` and
    resolve the [Q] / [D] / [MASK] ids (None detects it from the
    architectures list or artifact.metadata)."""
    model_dir = Path(model_dir)
    if sparse is None:
        sparse = _detect_sparse(model_dir)
    with open(model_dir / "config.json") as f:
        hf_config = json.load(f)
    archs = hf_config.get("architectures") or []
    if archs and archs[0] not in _SUPPORTED:
        raise ValueError(f"unsupported architecture: {archs[0]}")
    colbert_meta = _read_json(model_dir / "artifact.metadata", {})
    if not isinstance(colbert_meta, dict):
        colbert_meta = {}
    if colbert is None:
        colbert = (bool(archs and archs[0] in ("HF_ColBERT", "ColBERT"))
                   or bool(colbert_meta.get("dim") or colbert_meta.get("query_maxlen")))
    if colbert and sparse:
        raise ValueError("a checkpoint cannot be both ColBERT and SPLADE")
    config = BertConfig.from_hf_config(hf_config, name=model_dir.name)
    pooling = _read_st_pooling(model_dir)
    if pooling is not None:
        config = dataclasses.replace(config, pooling=pooling)
    dense = _read_st_dense(model_dir)

    tokenizer_json_path = model_dir / "tokenizer.json"
    if not tokenizer_json_path.is_file():
        raise FileNotFoundError(f"missing {tokenizer_json_path}")
    tokenizer_json = tokenizer_json_path.read_bytes()

    state_dict = _load_weights(model_dir, str(model_dir))
    is_seq_cls = bool(archs) and archs[0].endswith("ForSequenceClassification")
    if sparse and is_seq_cls:
        raise ValueError("sparse (SPLADE) conversion requires a *ForMaskedLM checkpoint, "
                         f"not {archs[0]}")
    # ModernBertForMaskedLM's "head." prediction head is dead weight without
    # a classifier
    heads = _HEADS if is_seq_cls else _HEADS + ("head.",)
    keep: frozenset[str] = frozenset()
    if sparse:
        if config.arch not in _MLM_TENSORS_BY_ARCH:
            raise ValueError("sparse (SPLADE) conversion is only supported for "
                             f"bert/roberta/distilbert, not {config.arch!r}")
        # the MLM head is the output: its names (and the tied views, checked
        # and dropped below) pass the head filter
        keep = frozenset(_MLM_TENSORS_BY_ARCH[config.arch]) | MLM_TIED_TENSORS
    state_dict = {
        next((k[len(p):] for p in _PREFIXES if k.startswith(p)), k): v
        for k, v in state_dict.items() if k in keep or not k.startswith(heads)
    }
    if config.arch == "nomic-bert":
        # the tensors, not the config flags, say whether biases exist
        config = dataclasses.replace(
            config, attn_bias="encoder.layers.0.attn.Wqkv.bias" in state_dict,
            ffn_bias="encoder.layers.0.mlp.fc2.bias" in state_dict)
    if sparse:
        config = dataclasses.replace(config, mlm_head=True)
        state_dict = _canonicalize_mlm_head(config, state_dict)
    if colbert:
        config = _colbert_config(config, state_dict, tokenizer_json, colbert_meta)
    if dense is not None:
        out_features, activation, tensors = dense
        config = dataclasses.replace(config, dense_out=out_features,
                                     dense_activation=activation)
        state_dict.update(tensors)
    if is_seq_cls:
        config = _classifier_config(config, state_dict, hf_config)
    return (config, state_dict, tokenizer_json, _special_overrides(model_dir),
            hf_config.get("_name_or_path", ""), _read_st_prompts(model_dir))


def _colbert_config(config: BertConfig, state_dict: dict, tokenizer_json: bytes,
                    meta: dict) -> BertConfig:
    """ColBERT's projection width, query length, skiplist switch and the
    [Q] / [D] marker and [MASK] ids (artifact.metadata names the marker
    tokens; the published BERT checkpoints use [unused0] / [unused1])."""
    if "linear.weight" not in state_dict:
        raise ValueError("ColBERT conversion needs the per-token projection "
                         "`linear.weight` (not found in the checkpoint)")
    q_tok = str(meta.get("query_token_id") or "[unused0]")
    d_tok = str(meta.get("doc_token_id") or "[unused1]")
    q_id = _vocab_token_id(tokenizer_json, q_tok)
    d_id = _vocab_token_id(tokenizer_json, d_tok)
    mask_id = next((i for i in (_vocab_token_id(tokenizer_json, t) for t in ("[MASK]", "<mask>"))
                    if i >= 0), -1)
    if min(q_id, d_id, mask_id) < 0:
        raise ValueError(f"could not resolve ColBERT special tokens in the tokenizer: "
                         f"{q_tok!r} -> {q_id}, {d_tok!r} -> {d_id}, "
                         f"[MASK]/<mask> -> {mask_id}")
    return dataclasses.replace(
        config, colbert_dim=int(np.asarray(state_dict["linear.weight"]).shape[0]),
        query_maxlen=int(meta.get("query_maxlen", 32)),
        mask_punctuation=bool(meta.get("mask_punctuation", True)),
        q_marker_id=q_id, d_marker_id=d_id, mask_id=mask_id)


def _classifier_config(config: BertConfig, state_dict: dict, hf_config: dict) -> BertConfig:
    """A cross-encoder's head: n_labels from the out-projection's rows, the
    family's activation; ModernBERT pools before its head, per
    classifier_pooling, and has only the bias-free dense."""
    out_name = ("classifier.out_proj.weight" if "classifier.out_proj.weight" in state_dict
                else "classifier.weight")
    replacements = dict(n_labels=int(np.asarray(state_dict[out_name]).shape[0]),
                        head_activation=HEAD_ACT_DEFAULTS.get(config.arch, "tanh"))
    if config.arch == "modernbert":
        if bool(hf_config.get("classifier_bias", False)):
            raise ValueError("modernbert with classifier_bias=True is not supported "
                             "(no published checkpoint uses it)")
        replacements["pooling"] = str(hf_config.get("classifier_pooling") or "cls")
    return dataclasses.replace(config, **replacements)


def _canonicalize_mlm_head(config: BertConfig, state_dict: dict) -> dict:
    """Check that the MLM decoder is tied to the word table, and keep only
    the canonical names (schema.mlm_tensors).  Safetensors stores a tied
    tensor once, torch dicts may hold both views: a decoder view that
    differs from the word table cannot ride it and is refused."""
    word = np.asarray(state_dict["embeddings.word_embeddings.weight"])
    decoder_name, bias_alias, bias_canon = {
        "bert": ("cls.predictions.decoder.weight", "cls.predictions.decoder.bias",
                 "cls.predictions.bias"),
        "roberta": ("lm_head.decoder.weight", "lm_head.decoder.bias", "lm_head.bias"),
        "distilbert": ("vocab_projector.weight", None, "vocab_projector.bias"),
    }[config.arch]
    dec = state_dict.pop(decoder_name, None)
    if dec is not None and not np.array_equal(np.asarray(dec), word):
        raise ValueError(f"{decoder_name} is not tied to the word-embedding table; untied "
                         "MLM decoders are not supported (no published SPLADE checkpoint "
                         "unties them)")
    if bias_alias is not None:
        alias = state_dict.pop(bias_alias, None)
        if alias is not None:
            canon = state_dict.get(bias_canon)
            if canon is None:
                state_dict[bias_canon] = alias
            elif not np.array_equal(np.asarray(alias), np.asarray(canon)):
                raise ValueError(f"{bias_alias} differs from {bias_canon}; inconsistent tied "
                                 "MLM bias views")
    missing = [n for n in mlm_tensors(config) if n not in state_dict]
    if missing:
        raise ValueError(f"MLM head tensors missing from checkpoint: {missing}")
    return state_dict


def convert_hf_dir(model_dir: str | os.PathLike, out_path: str | os.PathLike,
                   ftype: str | GGUFFileType = "f32", *, sparse: bool | None = None,
                   colbert: bool | None = None) -> None:
    """A local HF checkpoint directory -> GGUF of `ftype` (one step to a
    block type too); sparse / colbert as `load_hf_dir` takes them."""
    if isinstance(ftype, str):
        ftype = FTYPE_NAMES[ftype]
    config, state_dict, tokenizer_json, overrides, repo, (prompts, default) = load_hf_dir(
        model_dir, sparse=sparse, colbert=colbert)
    write_bert_gguf(out_path, config, state_dict, tokenizer_json, ftype,
                    special_ids=overrides, source_hf_repo=repo, prompts=prompts,
                    default_prompt_name=default)


def convert_hf_dir_to_legacy(model_dir: str | os.PathLike, out_path: str | os.PathLike,
                             ftype: str = "f16") -> None:
    """A local HF checkpoint directory -> the legacy pre-GGUF .bin (f32 or
    f16).  Its header has no MLM hparam, so a SPLADE directory converts as
    a dense model."""
    from ..gguf.legacy import write_legacy_bin

    config, state_dict, tokenizer_json, *_ = load_hf_dir(model_dir, sparse=False)
    write_legacy_bin(out_path, config, state_dict, tokenizer_json, ftype)


def _read_st_dense(model_dir: Path):
    """A sentence-transformers Dense module (LaBSE's 2_Dense: a linear and
    an activation between pooling and the L2 norm) -> (out_features,
    activation, {"dense.linear.weight", "dense.linear.bias"}), or None."""
    dense_dirs = sorted(model_dir.glob("*_Dense"), key=lambda q: int(q.name.split("_")[0]))
    if not dense_dirs:
        return None
    if len(dense_dirs) > 1:
        raise NotImplementedError(f"{len(dense_dirs)} stacked Dense modules in {model_dir}; "
                                  "only a single projection head is supported")
    d = dense_dirs[0]
    with open(d / "config.json") as f:
        cfg = json.load(f)
    act_name = str(cfg.get("activation_function", "")).rsplit(".", 1)[-1]
    if act_name == "Tanh":
        activation = "tanh"
    elif act_name in ("Identity", ""):
        activation = "identity"
    else:
        raise ValueError(f"unsupported Dense activation {act_name!r} in {d} "
                         "(supported: Tanh, Identity)")
    weights = _load_weights(d, str(d))
    bias = weights.get("linear.bias", np.zeros(int(cfg["out_features"]), np.float32))
    tensors = {"dense.linear.weight": np.asarray(weights["linear.weight"], np.float32),
               "dense.linear.bias": np.asarray(bias, np.float32)}
    return int(cfg["out_features"]), activation, tensors


def _read_st_prompts(model_dir: Path) -> tuple[dict[str, str], str]:
    """Named prompt prefixes and the default name from
    config_sentence_transformers.json (empty prefixes and a dangling
    default dropped)."""
    path = model_dir / "config_sentence_transformers.json"
    if not path.is_file():
        return {}, ""
    with open(path) as f:
        cfg = json.load(f)
    prompts = {str(name): str(prefix) for name, prefix in (cfg.get("prompts") or {}).items()
               if isinstance(prefix, str) and prefix}
    default = cfg.get("default_prompt_name") or ""
    return prompts, str(default) if default in prompts else ""


def _read_st_pooling(model_dir: Path) -> str | None:
    """The pooling of a sentence-transformers 1_Pooling/config.json."""
    path = model_dir / "1_Pooling" / "config.json"
    if not path.is_file():
        return None
    with open(path) as f:
        cfg = json.load(f)
    for key, pooling in (("pooling_mode_cls_token", "cls"), ("pooling_mode_max_tokens", "max"),
                         ("pooling_mode_mean_tokens", "mean")):
        if cfg.get(key):
            return pooling
    return None


def _special_overrides(model_dir: Path) -> dict | None:
    """Special-token ids named by special_tokens_map.json, looked up in
    tokenizer.json's model vocab."""
    path = model_dir / "special_tokens_map.json"
    if not path.is_file():
        return None
    with open(path) as f:
        smap = json.load(f)
    with open(model_dir / "tokenizer.json", "rb") as f:
        vocab = json.load(f)["model"]["vocab"]
    out = {}
    for key in ("unk", "sep", "pad", "cls"):
        tok = smap.get(f"{key}_token")
        if isinstance(tok, dict):
            tok = tok.get("content")
        if tok in vocab:
            out[key] = vocab[tok]
    return out or None
