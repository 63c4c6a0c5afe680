"""Parameter construction: GGUF files, raw state dicts or a JAX parameter
tree -> dicts of torch tensors on a device.

The JAX package's `models/params.py` for every family it serves:
tensors are shape-checked against the schema,
per-layer tensors are stacked on a leading layer axis (ALBERT's one shared
layer as a stack of one), and quantized
matmul weights and the word table stay packed in the QTensor layout
(ops/qtensor.py) — weights stay 4- or 8-bit in device memory.  The fused
Wqkv (ModernBERT, nomic-bert; nomic's bias too) and ModernBERT's Wi split
at load into q/k/v and up/gate.  Encoder-level
tensors (DeBERTa's relative table, the MPNet and T5 relative-bias tables,
T5's final norm), a classification head, ColBERT's projection and SPLADE's
MLM transform load dense f32 (SPLADE's decoder is the word table again, in
matmul orientation); ALBERT's and
ELECTRA's factorized-embedding projection loads dense in the
activation dtype, contraction-major (a small matmul the JAX package also
runs outside its kernels).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..gguf.constants import FTYPE_TO_GGML, GGMLType, GGUFFileType, ggml_nbytes
from ..gguf.quant import dequantize as gguf_dequantize
from ..gguf.quant import quantize as gguf_quantize
from ..ops.qtensor import (
    Q4_TYPES,
    QTensor,
    pack_q4_matmul,
    pack_q4_rows,
    pack_q8_matmul,
    pack_q8_rows,
)
from . import schema
from .config import BertConfig

FTYPE_NAMES = {
    "f32": GGUFFileType.ALL_F32,
    "f16": GGUFFileType.MOSTLY_F16,
    "q4_0": GGUFFileType.MOSTLY_Q4_0,
    "q4_1": GGUFFileType.MOSTLY_Q4_1,
    "q8_0": GGUFFileType.MOSTLY_Q8_0,
}

_MATMUL_KEYS = frozenset({"q_w", "k_w", "v_w", "o_w", "ffn_up_w", "ffn_gate_w",
                          "ffn_down_w"})
# fused [out, in] tensors split into equal out-row groups at load
_SPLIT_KEYS = {"wqkv": ("q_w", "k_w", "v_w"), "wi": ("ffn_up_w", "ffn_gate_w")}
# fused biases split into equal thirds, matching the wqkv weight split
_SPLIT_BIAS_KEYS = {"wqkv_b": ("q_b", "k_b", "v_b")}


class _TensorSource:
    """Uniform access to tensors as (raw bytes, ggml_type, hf_shape)."""

    def __init__(self, get: Callable[[str], tuple[np.ndarray, GGMLType, tuple]]):
        self.get = get

    def _raw(self, name: str, shape: tuple):
        raw, gtype, actual = self.get(name)
        if tuple(shape) != tuple(actual):
            raise ValueError(
                f"tensor {name}: shape {tuple(actual)} != expected {tuple(shape)}"
            )
        return raw, gtype, tuple(actual)

    def dense(self, name: str, shape: tuple, dtype) -> torch.Tensor:
        raw, gtype, actual = self._raw(name, shape)
        arr = gguf_dequantize(raw, gtype, int(np.prod(actual))).reshape(actual)
        return torch.from_numpy(arr).to(dtype)

    def matmul_weight(self, name: str, shape: tuple, dtype, keep_q: bool = True):
        """[out, in] weight -> contraction-major [in, out]: a QTensor where
        the file is quantized and `keep_q`, else dense in `dtype`."""
        raw, gtype, actual = self._raw(name, shape)
        if keep_q and gtype in Q4_TYPES:
            return pack_q4_matmul(raw, actual, gtype)
        if keep_q and gtype == GGMLType.Q8_0:
            return pack_q8_matmul(raw, actual)
        return self.dense(name, shape, dtype).T.contiguous()

    def matmul_weight_split(self, name: str, shape: tuple, dtype,
                            sections: int, keep_q: bool = True) -> list:
        """A fused [out, in] weight split into `sections` equal out-row
        groups, each in matmul orientation.  The quantized split is exact:
        ggml blocks run along the contraction (in) axis, so every out-row
        is a whole number of blocks."""
        raw, gtype, (out, k) = self._raw(name, shape)
        sub = out // sections
        if keep_q and (gtype in Q4_TYPES or gtype == GGMLType.Q8_0):
            rows = np.asarray(raw).reshape(out, ggml_nbytes(gtype, k))
            parts = [np.ascontiguousarray(rows[j * sub:(j + 1) * sub]).reshape(-1)
                     for j in range(sections)]
            if gtype in Q4_TYPES:
                return [pack_q4_matmul(p, (sub, k), gtype) for p in parts]
            return [pack_q8_matmul(p, (sub, k)) for p in parts]
        w = self.dense(name, shape, dtype)
        return [w[j * sub:(j + 1) * sub].T.contiguous() for j in range(sections)]

    def gather_table(self, name: str, shape: tuple, dtype, keep_q: bool = True):
        raw, gtype, actual = self._raw(name, shape)
        if keep_q and gtype in Q4_TYPES:
            return pack_q4_rows(raw, actual, gtype)
        if keep_q and gtype == GGMLType.Q8_0:
            return pack_q8_rows(raw, actual)
        return self.dense(name, shape, dtype)


def _stack(values: list):
    """Stack per-layer leaves (tensors or QTensors) on a new leading axis."""
    first = values[0]
    if isinstance(first, QTensor):
        return QTensor(
            qs=torch.stack([v.qs for v in values]),
            scales=torch.stack([v.scales for v in values]),
            mins=None if first.mins is None
            else torch.stack([v.mins for v in values]),
            shape=first.shape, qtype=first.qtype,
        )
    return torch.stack(values)


def params_to(params: dict, device) -> dict:
    """Move every leaf (tensor or QTensor) of a parameter dict to `device`."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = params_to(v, device)
        elif isinstance(v, QTensor):
            out[k] = v.map(lambda t: t.to(device))
        else:
            out[k] = v.to(device)
    return out


WEIGHT_MODES = ("auto", "dequant")


def build_params(source: _TensorSource, config: BertConfig, *, weight_mode: str = "auto",
                 dense_dtype=torch.float32, device="cpu") -> dict:
    """Assemble the parameter dict on `device`.  weight_mode "auto":
    quantized matmul weights and the word table stay packed (the fused
    dequant-matmul kernel reads them); "dequant": they are dequantized at
    load and stored dense in `dense_dtype` (their linears run a plain
    matmul).  Dense weights and tables take `dense_dtype`; LayerNorm
    parameters and biases stay f32."""
    if weight_mode not in WEIGHT_MODES:
        raise ValueError(f"weight_mode {weight_mode!r} not in {WEIGHT_MODES}")
    keep_q = weight_mode == "auto"
    f32 = torch.float32
    emb = {}
    for name, (key, shape_fn) in schema.embedding_tensors(config).items():
        shape = shape_fn(config)
        if key == "word":
            emb[key] = source.gather_table(name, shape, dense_dtype, keep_q)
        elif key in ("token_type", "position"):
            emb[key] = source.dense(name, shape, dense_dtype)
        elif key == "emb_proj_w":
            emb[key] = source.dense(name, shape, dense_dtype).T.contiguous()
        else:  # LayerNorm scale/bias and the projection's bias
            emb[key] = source.dense(name, shape, f32)
    per_layer: dict[str, list] = {}
    for i in range(1 if config.shared_layers else config.n_layer):
        for name, (key, shape_fn) in schema.layer_tensor_names(i, config).items():
            shape = shape_fn(config)
            if key in _SPLIT_KEYS:
                subkeys = _SPLIT_KEYS[key]
                parts = source.matmul_weight_split(name, shape, dense_dtype,
                                                   len(subkeys), keep_q)
                for subkey, v in zip(subkeys, parts):
                    per_layer.setdefault(subkey, []).append(v)
                continue
            if key in _SPLIT_BIAS_KEYS:
                full = source.dense(name, shape, f32)
                subkeys = _SPLIT_BIAS_KEYS[key]
                for subkey, v in zip(subkeys, full.chunk(len(subkeys))):
                    per_layer.setdefault(subkey, []).append(v.contiguous())
                continue
            if key in _MATMUL_KEYS:
                v = source.matmul_weight(name, shape, dense_dtype, keep_q)
            else:  # LayerNorm scales/biases and linear biases
                v = source.dense(name, shape, f32)
            per_layer.setdefault(key, []).append(v)
    if config.arch == "modernbert":
        # layer 0 has no attention norm: a row of ones keeps the stack
        # rectangular (the forward never reads it)
        per_layer["ln_att_scale"].insert(0, torch.ones(config.n_embd, dtype=f32))
    params = {
        "embeddings": emb,
        "layers": {k: _stack(v) for k, v in per_layer.items()},
    }
    for name, (key, shape_fn) in schema.extra_tensors(config).items():
        params[key] = source.dense(name, shape_fn(config), f32)
    if config.dense_out:
        dense = {}
        for name, (key, shape_fn) in schema.DENSE_TENSORS.items():
            t = source.dense(name, shape_fn(config), f32)
            if key == "dense_w":
                dense["w"] = t.T.contiguous()
            else:
                dense["b"] = t
        params["dense"] = dense
    if config.mlm_head:
        # SPLADE's MLM head: the transform and its LayerNorm dense f32; the
        # decoder is the tied word table again, in matmul orientation
        # [E, V] and packed where the file is quantized (the K1/K8 operand
        # of the logits product)
        mlm = {}
        for name, (key, shape_fn) in schema.mlm_tensors(config).items():
            t = source.dense(name, shape_fn(config), f32)
            mlm[key.removeprefix("mlm_")] = t.T.contiguous() if key == "mlm_dense_w" else t
        mlm["decoder_w"] = source.matmul_weight("embeddings.word_embeddings.weight",
                                                (config.n_vocab, config.emb_width),
                                                dense_dtype, keep_q)
        params["mlm"] = mlm
    if config.n_labels:
        # classification head: small linears computed in f32 on the pooled
        # state, dense whatever the file's type; weights as [in, out]
        head = {}
        for name, (key, shape_fn) in schema.head_tensors(config).items():
            t = source.dense(name, shape_fn(config), f32)
            head[key.removeprefix("head_")] = t.T.contiguous() if key.endswith("_w") else t
        params["head"] = head
    if config.colbert_dim:
        # ColBERT's per-token projection: one bias-free [E, dim] f32 matmul
        (name, (_, shape_fn)), = schema.COLBERT_TENSORS.items()
        params["colbert"] = {"w": source.dense(name, shape_fn(config), f32).T.contiguous()}
    return params_to(params, device)


def source_from_gguf(reader) -> _TensorSource:
    def get(name: str):
        info = reader.tensors[name]
        return reader.tensor_raw(name), info.ggml_type, info.shape

    return _TensorSource(get)


def source_from_arrays(arrays: dict[str, np.ndarray],
                       ftype: GGUFFileType = GGUFFileType.ALL_F32) -> _TensorSource:
    """f32 numpy state dict (HF names/shapes) -> source: 2-D tensors named
    *weight get the file's type, everything else stays f32 (the
    converter's per-tensor policy)."""
    target = FTYPE_TO_GGML[ftype]

    def get(name: str):
        arr = np.ascontiguousarray(arrays[name], dtype=np.float32)
        gtype = target if name.endswith("weight") and arr.ndim == 2 else GGMLType.F32
        return gguf_quantize(arr.reshape(-1), gtype), gtype, arr.shape

    return _TensorSource(get)


def load_params(reader, config: BertConfig | None = None, *, weight_mode: str = "auto",
                dense_dtype=torch.float32, device="cpu"):
    if config is None:
        config = BertConfig.from_gguf_kv(reader.kv)
    params = build_params(source_from_gguf(reader), config, weight_mode=weight_mode,
                          dense_dtype=dense_dtype, device=device)
    return params, config


def random_state_dict(config: BertConfig, seed: int = 0) -> dict[str, np.ndarray]:
    """Random HF-style state dict — the same numbers as the JAX package's
    `random_state_dict` for the same config and seed (tensors drawn in the
    same order: embeddings, layers, encoder-level extras, Dense head,
    ColBERT projection, classification head, MLM head)."""
    rng = np.random.default_rng(seed)

    def init(shape):
        return (rng.standard_normal(shape) * 0.02).astype(np.float32)

    sd: dict[str, np.ndarray] = {}
    for name, (key, shape_fn) in schema.embedding_tensors(config).items():
        shape = shape_fn(config)
        if key == "ln_scale":
            sd[name] = np.ones(shape, np.float32)
        elif key == "ln_bias":
            sd[name] = np.zeros(shape, np.float32)
        else:
            sd[name] = init(shape)
    for i in range(1 if config.shared_layers else config.n_layer):
        for name, (key, shape_fn) in schema.layer_tensor_names(i, config).items():
            shape = shape_fn(config)
            if key.startswith("ln_") and key.endswith("scale"):
                sd[name] = np.ones(shape, np.float32)
            elif key.endswith("_b") or key.endswith("bias"):
                sd[name] = np.zeros(shape, np.float32)
            else:
                sd[name] = init(shape)
    for name, (key, shape_fn) in schema.extra_tensors(config).items():
        # norm scales are ones; tables (and DeBERTa's rel-table LN bias) random
        if key.endswith("ln_scale"):
            sd[name] = np.ones(shape_fn(config), np.float32)
        else:
            sd[name] = init(shape_fn(config))
    if config.dense_out:
        for name, (_, shape_fn) in schema.DENSE_TENSORS.items():
            sd[name] = init(shape_fn(config))
    if config.colbert_dim:
        for name, (_, shape_fn) in schema.COLBERT_TENSORS.items():
            sd[name] = init(shape_fn(config))
    for name, (_, shape_fn) in schema.head_tensors(config).items():
        sd[name] = init(shape_fn(config))  # head biases random too
    for name, (key, shape_fn) in schema.mlm_tensors(config).items():
        shape = shape_fn(config)
        if key == "mlm_ln_scale":
            sd[name] = np.ones(shape, np.float32)
        elif key == "mlm_ln_bias":
            sd[name] = np.zeros(shape, np.float32)
        else:  # the |V| output bias random too
            sd[name] = init(shape)
    return sd


def random_params(config: BertConfig, ftype="f32", seed: int = 0, *,
                  weight_mode: str = "auto", dense_dtype=torch.float32,
                  device="cpu") -> dict:
    """Parameters from `random_state_dict`, stored as a file of `ftype`
    ("f32" | "f16" | "q4_0" | "q4_1" | "q8_0", or a GGUFFileType) holds them."""
    if isinstance(ftype, str):
        ftype = FTYPE_NAMES[ftype]
    return build_params(
        source_from_arrays(random_state_dict(config, seed), ftype), config,
        weight_mode=weight_mode, dense_dtype=dense_dtype, device=device,
    )


def from_jax_params(tree, device="cpu") -> dict:
    """The JAX package's parameter tree (leaves as numpy arrays, QTensor
    fields as numpy arrays) -> this package's parameters on `device`.

    Quantized leaves are recognized by their fields (qs/scales/mins/shape/
    qtype), so nothing of the JAX package is imported here.  Layer-stacked
    leaves keep their leading layer axis; every leaf keeps its dtype.
    """
    def tensor(a) -> torch.Tensor:
        a = np.array(a)  # a writable copy (jax exports read-only views)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as jax exports it
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        return torch.from_numpy(a)

    def leaf(v):
        if hasattr(v, "qs") and hasattr(v, "qtype"):
            qt = QTensor(
                qs=tensor(v.qs), scales=tensor(v.scales),
                mins=None if v.mins is None else tensor(v.mins),
                shape=tuple(v.shape), qtype=GGMLType(int(v.qtype)),
            )
            return qt.map(lambda t: t.to(device))
        return tensor(v).to(device)

    def walk(d):
        return {k: walk(v) if isinstance(v, dict) else leaf(v)
                for k, v in d.items()}

    return walk(tree)
