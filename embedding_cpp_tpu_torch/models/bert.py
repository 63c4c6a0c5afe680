"""Batched, masked BERT encoder forward pass in PyTorch (T5, ModernBERT,
DeBERTa and nomic-bert configs dispatch to models/t5.py,
models/modernbert.py, models/deberta.py and models/nomic.py from the entry
points), the cross-encoder score path with its classification head, and
the token-level surfaces over any family's final states: ColBERT's
projection and MaxSim (`project_token_states`, `maxsim_scores`) and
SPLADE's sparse vectors from the MLM head (`bert_sparse_batch`).

The BERT path of the JAX package's `models/bert.py`, which also serves the
families that share BERT's graph: RoBERTa and XLM-R (positions numbered
from `pos_offset`), DistilBERT (no token-type table), ELECTRA (ELECTRA-
small's narrow embeddings projected up after their LayerNorm), MPNet (a
T5-bucketed relative position bias [H, S, S] shared by every layer, added
after the scaled scores) and ALBERT (factorized embeddings, one shared
layer applied n_layer times).  On dicts of tensors:
matmuls run in the activation dtype (bf16 for throughput, f32 for parity)
with f32 accumulation, while LayerNorm, softmax, pooling and the L2 norm
accumulate in f32.  Every layer's six projections go through `linear`
(quantized weights: the fused dequant-matmul kernel), and attention goes
through the projection-layout kernel: its segment-masked form for packed
rows, its key-bias form for plain padded batches, at every sequence length,
with MPNet's position bias (K4) or without (K2/K3).  While a profiler
records, the embeddings run in the range `op.embed` and pooling, the
output head, the row gather and the output encoding in `op.pool`
(`utils/metrics.op_range`; the linears, norms and attention in theirs).
"""
from __future__ import annotations

import functools
import inspect
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import (
    MASK_BIAS,
    MAX_SEQ,
    flash_attention_bse,
    flash_attention_packed_bse,
)
from ..ops.dispatch import check_impl, kernel_impls
from ..ops.linear import layer_norm, linear
from ..ops.qtensor import QTensor, gather_rows
from ..parallel.group import current_tp
from ..utils.metrics import in_op_range
from .config import BertConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_OUTPUT_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                  "bfloat16": torch.bfloat16, "int8": None}


@dataclass(frozen=True)
class ComputeOptions:
    """Activation dtype ("float32" | "bfloat16"); the encoding of the
    returned embeddings: "float32", "float16" / "bfloat16" (cast on the
    device, half the bytes to fetch; pooling and the L2 norm still run in
    f32), or "int8" — per-vector int8 codes with their f32 scale packed in
    one uint8 array (`pack_output_i8`), a quarter of the bytes; and which
    version of the quantized matmul and the residual + LayerNorm pass
    (`q4_impl`) and of the attention (`attn_impl`) the forward runs: "auto"
    (the kernel on CUDA tensors, the plain version on the CPU), "kernel" or
    "plain" (ops/dispatch.py)."""

    dtype: str = "float32"
    output_dtype: str = "float32"
    q4_impl: str = "auto"
    attn_impl: str = "auto"

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype {self.dtype!r} not in {sorted(_DTYPES)}")
        if self.output_dtype not in _OUTPUT_DTYPES:
            raise ValueError(f"output_dtype {self.output_dtype!r} not in "
                             f"{sorted(_OUTPUT_DTYPES)}")
        check_impl("q4_impl", self.q4_impl)
        check_impl("attn_impl", self.attn_impl)

    @property
    def tdtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


@in_op_range("op.embed")
def embed_tokens(params: dict, ids: torch.Tensor, config: BertConfig,
                 opts: ComputeOptions, positions: torch.Tensor | None = None,
                 type_ids: torch.Tensor | None = None) -> torch.Tensor:
    """word[ids] + token_type[0] (or token_type[type_ids], the segments of
    a cross-encoder pair) + position[off + 0..S-1] (or off + the
    per-segment `positions` of packed rows; no position term where the
    family has no absolute table), then the embedding LayerNorm, then
    ELECTRA's projection to n_embd where the tables are factorized."""
    emb = params["embeddings"]
    s = ids.shape[-1]
    off = config.pos_offset
    word = emb["word"]
    if isinstance(word, QTensor):
        x = gather_rows(word, ids, dtype=torch.float32)
    else:
        x = word[ids].to(torch.float32)
    if "token_type" in emb:
        tt = emb["token_type"]
        x = x + (tt[0] if type_ids is None else tt[type_ids]).to(torch.float32)
    if config.abs_positions:
        pe = emb["position"]
        x = x + (pe[off : off + s] if positions is None else pe[positions + off]).to(
            torch.float32)
    x = layer_norm(x, emb["ln_scale"], emb["ln_bias"], config.layer_norm_eps, opts.tdtype)
    if "emb_proj_w" in emb:
        # a dense matmul, as the JAX package runs it (outside its kernels)
        x = linear(x, emb["emb_proj_w"], emb["emb_proj_b"])
    return x


def t5_relative_bucket(rel: np.ndarray, num_buckets: int = 32,
                       max_distance: int = 128) -> np.ndarray:
    """T5's bidirectional relative-position bucket of rel = k_pos - q_pos
    (HF MPNetEncoder.relative_position_bucket / T5Attention's): the sign
    picks a half, then exact buckets near zero and log-spaced ones out to
    max_distance.  In numpy float32, as the JAX package folds it on the
    host: one ulp of the log at a boundary would move a bucket."""
    half = num_buckets // 2
    n = -rel
    ret = (n < 0).astype(np.int32) * half
    n = np.abs(n)
    max_exact = half // 2
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1).astype(np.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (half - max_exact)
    ).astype(np.int32)
    val_if_large = np.minimum(val_if_large, half - 1)
    return ret + np.where(n < max_exact, n.astype(np.int32), val_if_large)


@functools.lru_cache(maxsize=32)
def _bucket_index(s: int, num_buckets: int, max_distance: int, device) -> torch.Tensor:
    """The [S, S] bucket matrix of positions 0..S-1 on `device`, made once
    per (S, buckets, max_distance, device)."""
    pos = np.arange(s)
    bucket = t5_relative_bucket(pos[None, :] - pos[:, None], num_buckets, max_distance)
    return torch.from_numpy(bucket.astype(np.int64)).to(device)


def rel_attn_bias(table: torch.Tensor, s: int, max_distance: int = 128) -> torch.Tensor:
    """The shared relative position bias of a row of S positions: table
    [buckets, H] gathered at the bucket matrix -> contiguous [H, S, S] f32,
    the position-bias operand of the projection-layout kernel (K4).  It is
    batch-invariant and serves packed rows too: within a segment the
    restart positions are consecutive, so k_pos - q_pos is the row offset
    k - q, and pairs across segments are masked."""
    bucket = _bucket_index(s, int(table.shape[0]), int(max_distance), table.device)
    return table.to(torch.float32)[bucket].permute(2, 0, 1).contiguous()


def _pos_bias(params: dict, s: int) -> torch.Tensor | None:
    """MPNet's [H, S, S] bias, built once per forward (None without a
    table).  HF MPNetEncoder.compute_position_bias fixes max_distance at
    128, as the JAX package does."""
    table = params.get("rel_attn_bias")
    return None if table is None else rel_attn_bias(table, s)


def local_heads(pos_bias: torch.Tensor | None, h: int) -> torch.Tensor | None:
    """A per-head position bias [H, S, S] cut to the h heads of the running
    tp slot, [rank*h, (rank+1)*h) (the column-parallel q/k/v hold those
    heads); a head-invariant [1, S, S] bias, or one of h heads, unchanged."""
    if pos_bias is None or pos_bias.shape[0] in (1, h):
        return pos_bias
    tp = current_tp()
    r = 0 if tp is None else tp.rank
    return pos_bias[r * h:(r + 1) * h]


def _attention(x: torch.Tensor, lp: dict, mask_bias: torch.Tensor,
               config: BertConfig, seg: torch.Tensor | None = None,
               pos_bias: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) [+ pos_bias]) v over the projection layout,
    masked by the key bias, or block-diagonal by segment for packed rows.
    The head count comes from the projection's width: a tp slot holds
    n_head / tp of them."""
    q = linear(x, lp["q_w"], lp["q_b"])
    k = linear(x, lp["k_w"], lp["k_b"])
    v = linear(x, lp["v_w"], lp["v_b"])
    h = q.shape[-1] // config.head_dim
    pos_bias = local_heads(pos_bias, h)
    if seg is not None:
        return flash_attention_packed_bse(q, k, v, seg, h, pos_bias)
    return flash_attention_bse(q, k, v, mask_bias, h, pos_bias)


def encoder_layer(x: torch.Tensor, lp: dict, mask_bias: torch.Tensor,
                  config: BertConfig, seg: torch.Tensor | None = None,
                  pos_bias: torch.Tensor | None = None) -> torch.Tensor:
    """One transformer block: attention + add&norm, GELU FFN + add&norm."""
    att = _attention(x, lp, mask_bias, config, seg=seg, pos_bias=pos_bias)
    eps = config.layer_norm_eps
    x = linear(att, lp["o_w"], lp["o_b"], residual=x, row_parallel=True,
               ln=(lp["ln_att_scale"], lp["ln_att_bias"], eps))
    h = linear(x, lp["ffn_up_w"], lp["ffn_up_b"],
               activation="gelu_tanh" if config.gelu == "tanh" else "gelu_erf")
    return linear(h, lp["ffn_down_w"], lp["ffn_down_b"], residual=x, row_parallel=True,
                  ln=(lp["ln_out_scale"], lp["ln_out_bias"], eps))


def _run_layers(x: torch.Tensor, layers: dict, config: BertConfig, mask_bias,
                seg=None, pos_bias=None) -> torch.Tensor:
    """The layer stack; ALBERT's one shared layer (a stack of one) applied
    n_layer times."""
    for i in range(config.n_layer):
        j = 0 if config.shared_layers else i
        lp = {k: v[j] for k, v in layers.items()}
        x = encoder_layer(x, lp, mask_bias, config, seg=seg, pos_bias=pos_bias)
    return x


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=1e-12)


@in_op_range("op.pool")
def pool_normalize(x: torch.Tensor, mask: torch.Tensor, pooling: str = "mean",
                   normalize: bool = True) -> torch.Tensor:
    """Masked pooling over tokens (mean / cls / max) + optional L2 norm."""
    xf = x.to(torch.float32)
    m = mask.to(torch.float32)[..., None]
    if pooling == "mean":
        pooled = torch.sum(xf * m, dim=-2) / torch.clamp(torch.sum(m, dim=-2), min=1.0)
    elif pooling == "cls":
        pooled = xf[..., 0, :]
    elif pooling == "max":
        pooled = torch.amax(torch.where(m > 0, xf, -torch.inf), dim=-2)
        pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
    else:
        raise ValueError(f"unknown pooling {pooling!r}")
    return _l2_normalize(pooled) if normalize else pooled


@in_op_range("op.pool")
def pool_normalize_packed(x: torch.Tensor, seg: torch.Tensor, pos: torch.Tensor,
                          n_seg: int, pooling: str = "mean",
                          normalize: bool = True) -> torch.Tensor:
    """Per-segment pooling over packed rows: [B, S, E] -> [B, n_seg, E].
    Empty segment slots come out as zero vectors."""
    b, s, e = x.shape
    xf = x.to(torch.float32)
    gids = torch.arange(n_seg, dtype=seg.dtype, device=seg.device)
    onehot = (seg[:, :, None] == gids[None, None, :]).to(torch.float32)
    if pooling == "mean":
        sums = torch.einsum("bsg,bse->bge", onehot, xf)
        counts = torch.sum(onehot, dim=1)[..., None]
        pooled = sums / torch.clamp(counts, min=1.0)
    elif pooling == "cls":
        sel = onehot * (pos == 0).to(torch.float32)[:, :, None]
        pooled = torch.einsum("bsg,bse->bge", sel, xf)
    elif pooling == "max":
        rows = torch.arange(b, dtype=seg.dtype, device=seg.device)[:, None]
        flat = torch.where(seg >= 0, seg + n_seg * rows, b * n_seg).reshape(-1)
        acc = torch.full((b * n_seg + 1, e), -torch.inf, device=x.device)
        acc = acc.scatter_reduce(0, flat.long()[:, None].expand(-1, e),
                                 xf.reshape(b * s, e), "amax")
        pooled = acc[: b * n_seg].reshape(b, n_seg, e)
        pooled = torch.where(torch.isfinite(pooled), pooled, 0.0)
    else:
        raise ValueError(f"unknown pooling {pooling!r}")
    return _l2_normalize(pooled) if normalize else pooled


@in_op_range("op.pool")
def _output_head(pooled: torch.Tensor, params: dict, config: BertConfig) -> torch.Tensor:
    """Optional sentence-transformers Dense projection (f32), then the L2
    norm when the config asks for it."""
    dense = params.get("dense")
    y = pooled
    if dense is not None:
        y = pooled @ dense["w"] + dense["b"]
        if config.dense_activation == "tanh":
            y = torch.tanh(y)
    return _l2_normalize(y) if config.normalize else y


def quantize_output_i8(out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8: codes = round(x / scale), scale =
    amax / 127.  Returns (int8 codes [..., E], f32 scales [...])."""
    amax = torch.amax(torch.abs(out), dim=-1)
    scale = (amax / 127.0).to(torch.float32)
    q = torch.round(out / torch.clamp(scale, min=1e-20)[..., None])
    return q.to(torch.int8), scale


def pack_output_i8(out: torch.Tensor) -> torch.Tensor:
    """Codes and scale in ONE uint8 array [..., E+4]: the codes, then the
    f32 scale's 4 little-endian bytes — one device->host fetch."""
    q, scale = quantize_output_i8(out)
    sb = scale.contiguous()[..., None].view(torch.uint8)
    return torch.cat([q.view(torch.uint8), sb], dim=-1)


def unpack_output_i8(packed) -> np.ndarray:
    """Host-side decode of pack_output_i8: numpy [..., E+4] u8 -> f32 [..., E]."""
    packed = np.ascontiguousarray(packed)
    q = packed[..., :-4].view(np.int8)
    scale = np.ascontiguousarray(packed[..., -4:]).view(np.float32)[..., 0]
    return q.astype(np.float32) * scale[..., None]


@in_op_range("op.pool")
def _cast_output(out: torch.Tensor, opts: ComputeOptions,
                 gather_idx: torch.Tensor | None = None) -> torch.Tensor:
    """The output encoding (packed int8, or a cast to the output dtype) of
    the vectors [..., E], of their flat rows `gather_idx` when given."""
    if gather_idx is not None:
        out = out.reshape(-1, out.shape[-1])[gather_idx]
    if opts.output_dtype == "int8":
        return pack_output_i8(out)
    return out.to(_OUTPUT_DTYPES[opts.output_dtype])


def fetch_output(out: torch.Tensor) -> np.ndarray:
    """Device result -> host f32 numpy: int8 codes decoded, f16 / bf16
    values upcast exactly (numpy has no bfloat16: the cast runs in torch
    on the host)."""
    host = out.cpu()
    if host.dtype == torch.uint8:
        return unpack_output_i8(host.numpy())
    return host.float().numpy()


def _with_kernel_impls(fn):
    """Run the forward `fn` with the kernel choices of its `opts`
    argument (`dispatch.kernel_impls`): every kernel wrapper it reaches,
    in every family's model code and the heads, runs as they say."""
    sig = inspect.signature(fn)
    default = sig.parameters["opts"].default

    @functools.wraps(fn)
    def run(*args, **kw):
        opts = sig.bind_partial(*args, **kw).arguments.get("opts", default)
        if opts is inspect.Parameter.empty:
            opts = ComputeOptions()
        with kernel_impls(opts.q4_impl, opts.attn_impl):
            return fn(*args, **kw)

    return run


@_with_kernel_impls
def bert_embed_batch(params: dict, ids: torch.Tensor, mask: torch.Tensor,
                     config: BertConfig, opts: ComputeOptions = ComputeOptions(),
                     gather_idx: torch.Tensor | None = None,
                     token_states: bool = False) -> torch.Tensor:
    """Token ids [B, S] + validity mask [B, S] -> embeddings [B, n_embd]
    (rows `gather_idx` only, when given), in the output encoding; with
    `token_states`, the final hidden states [B, S, E] f32 of every family
    (HF last_hidden_state: no pooling, head, gather or encoding)."""
    kw = dict(gather_idx=gather_idx, token_states=token_states)
    if config.arch == "modernbert":
        from .modernbert import modernbert_embed_batch

        return modernbert_embed_batch(params, ids, mask, config, opts, **kw)
    if config.arch == "t5":
        from .t5 import t5_embed_batch

        return t5_embed_batch(params, ids, mask, config, opts, **kw)
    if config.arch == "deberta":
        from .deberta import deberta_embed_batch

        return deberta_embed_batch(params, ids, mask, config, opts, **kw)
    if config.arch == "nomic-bert":
        from .nomic import nomic_embed_batch

        return nomic_embed_batch(params, ids, mask, config, opts, **kw)
    x = embed_tokens(params, ids, config, opts)
    mask_bias = torch.where(mask.to(torch.bool), 0.0, MASK_BIAS).to(torch.float32)
    x = _run_layers(x, params["layers"], config, mask_bias,
                    pos_bias=_pos_bias(params, ids.shape[-1]))
    if token_states:
        return x.to(torch.float32)
    pooled = pool_normalize(x, mask, config.pooling, normalize=False)
    out = _output_head(pooled, params, config)
    return _cast_output(out, opts, gather_idx)


def check_pack_seq(config: BertConfig, s: int) -> None:
    """Raises ValueError when no kernel of `config`'s family serves packed
    rows of `s` tokens (the Engine asks once, when it is built, not in the
    middle of a forward).  ModernBERT and nomic-bert serve every length
    (past 1024 tokens the long-row kernel's segment modes)."""
    if config.arch in ("modernbert", "nomic-bert"):
        return
    from ..ops.deberta_attention import MAX_SEQ as DEBERTA_MAX_SEQ

    limit = DEBERTA_MAX_SEQ if config.arch == "deberta" else MAX_SEQ
    if s > limit:
        raise ValueError(f"{config.arch} packed rows of {s} tokens are not served: "
                         f"its attention kernel stops at {limit}")


@_with_kernel_impls
def bert_embed_packed(params: dict, ids: torch.Tensor, seg: torch.Tensor,
                      pos: torch.Tensor, config: BertConfig,
                      opts: ComputeOptions = ComputeOptions(), *, n_seg: int,
                      gather_idx: torch.Tensor | None = None,
                      max_seg_len: int | None = None) -> torch.Tensor:
    """Sequence-packed forward: ids/seg/pos [B, S] (seg -1 on padding, pos
    the within-segment position) -> [B, n_seg, n_embd], or the flat slots
    `gather_idx` of B*n_seg, in the output encoding.  `max_seg_len` bounds
    the longest segment; the rows of 1024 tokens or more of nomic-bert and
    of ModernBERT's global layers use it (the windowed segment kernel)."""
    if config.arch == "modernbert":
        from .modernbert import modernbert_embed_packed

        return modernbert_embed_packed(params, ids, seg, pos, config, opts,
                                       n_seg=n_seg, gather_idx=gather_idx,
                                       max_seg_len=max_seg_len)
    if config.arch == "t5":
        from .t5 import t5_embed_packed

        return t5_embed_packed(params, ids, seg, pos, config, opts, n_seg=n_seg,
                               gather_idx=gather_idx)
    if config.arch == "deberta":
        from .deberta import deberta_embed_packed

        return deberta_embed_packed(params, ids, seg, pos, config, opts,
                                    n_seg=n_seg, gather_idx=gather_idx)
    if config.arch == "nomic-bert":
        from .nomic import nomic_embed_packed

        return nomic_embed_packed(params, ids, seg, pos, config, opts, n_seg=n_seg,
                                  gather_idx=gather_idx, max_seg_len=max_seg_len)
    x = embed_tokens(params, ids, config, opts, positions=pos)
    x = _run_layers(x, params["layers"], config, None, seg=seg,
                    pos_bias=_pos_bias(params, ids.shape[-1]))
    pooled = pool_normalize_packed(x, seg, pos, n_seg, config.pooling, normalize=False)
    out = _output_head(pooled, params, config)
    return _cast_output(out, opts, gather_idx)


def classifier_head(h: torch.Tensor, head: dict, activation: str) -> torch.Tensor:
    """logits = out(act(dense(h))) in f32, the shape every HF
    *ForSequenceClassification head reduces to; `activation` is "tanh" |
    "relu" | "gelu" (erf)."""
    y = h @ head["dense_w"] + head["dense_b"]
    if activation == "tanh":
        y = torch.tanh(y)
    elif activation == "relu":
        y = torch.relu(y)
    else:
        y = F.gelu(y)
    return y @ head["out_w"] + head["out_b"]


@_with_kernel_impls
def bert_score_batch(params: dict, ids: torch.Tensor, mask: torch.Tensor,
                     config: BertConfig, opts: ComputeOptions = ComputeOptions(),
                     type_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Cross-encoder forward: pair ids [B, S] (+ segment type ids [B, S])
    -> [B, n_labels] f32 logits: the masked encoder, then the
    classification head on the CLS state (ModernBERT: its PredictionHead
    on the pooled state, no type ids)."""
    if config.arch == "modernbert":
        from .modernbert import modernbert_score_batch

        return modernbert_score_batch(params, ids, mask, config, opts)
    if config.arch == "deberta":
        from .deberta import deberta_score_batch

        return deberta_score_batch(params, ids, mask, config, opts, type_ids=type_ids)
    if config.arch == "nomic-bert":
        # no nomic-bert classification checkpoint exists; BERT's score path
        # lacks RoPE, so it refuses instead of computing the wrong thing
        raise ValueError("nomic-bert classification heads are not supported")
    if config.arch == "t5":
        # monoT5-style rerankers score with the decoder, not a head
        raise ValueError("t5 encoders have no classification head")
    if "head" not in params:
        raise ValueError("model has no classification head (n_labels == 0)")
    x = embed_tokens(params, ids, config, opts, type_ids=type_ids)
    mask_bias = torch.where(mask.to(torch.bool), 0.0, MASK_BIAS).to(torch.float32)
    x = _run_layers(x, params["layers"], config, mask_bias,
                    pos_bias=_pos_bias(params, ids.shape[-1]))
    return classifier_head(x[:, 0, :].to(torch.float32), params["head"],
                           config.head_activation)


def project_token_states(params: dict, x: torch.Tensor) -> torch.Tensor:
    """ColBERT's per-token projection where the checkpoint has one: [..., E]
    -> [..., colbert_dim] f32 (a dense f32 matmul, as the JAX package
    leaves it to XLA); the states unchanged otherwise."""
    cb = params.get("colbert")
    if cb is None:
        return x
    return torch.matmul(x.to(torch.float32), cb["w"])


@_with_kernel_impls
def maxsim_scores(params: dict, q_states: torch.Tensor, q_mask: torch.Tensor,
                  d_ids: torch.Tensor, d_mask: torch.Tensor, config: BertConfig,
                  opts: ComputeOptions = ComputeOptions(),
                  d_keep: torch.Tensor | None = None) -> torch.Tensor:
    """Late-interaction MaxSim: query token states [Sq, E'] (+ which of
    them score, q_mask [Sq]) against the documents d_ids [B, S] (attention
    mask d_mask) -> [B] f32: the sum over scoring query tokens of the max
    over the documents' scoring tokens (`d_keep`, default d_mask: ColBERT's
    punctuation skiplist) of the cosine of the projected token vectors."""
    d = project_token_states(params, bert_embed_batch(params, d_ids, d_mask, config, opts,
                                                      token_states=True))
    sim = torch.einsum("qe,bse->bqs", _l2_normalize(q_states.to(torch.float32)),
                       _l2_normalize(d))
    keep = d_mask if d_keep is None else d_keep
    sim = torch.where(keep[:, None, :] > 0, sim, -torch.inf)
    best = torch.where(q_mask[None, :] > 0, torch.amax(sim, dim=-1), 0.0)  # [B, Sq]
    return torch.sum(best, dim=-1)


SPARSE_TILE_BUDGET = 128 << 20  # f32 bytes of one [B, chunk, V] logits tile


def sparse_chunk(s: int, b: int, n_vocab: int, budget: int = SPARSE_TILE_BUDGET,
                 cap: int = 64) -> int:
    """The tokens of one step of the sparse head's running max: the largest
    divisor of s, at most `cap`, whose [b, chunk, n_vocab] f32 logits fit
    `budget` bytes (1 at least: the caller bounds b)."""
    cap = min(cap, s, max(1, budget // max(1, b * n_vocab * 4)))
    return next(c for c in range(cap, 0, -1) if s % c == 0)


def pack_sparse_topk(idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Top-k entries in one int32 array [..., 2k]: the ids, then the f32
    weights' bits (one device-to-host fetch)."""
    return torch.cat([idx.to(torch.int32), val.to(torch.float32).view(torch.int32)], dim=-1)


def unpack_sparse_topk(packed) -> tuple[np.ndarray, np.ndarray]:
    """Host-side decode of pack_sparse_topk: [..., 2k] 32-bit -> (int32 ids
    [..., k], f32 weights [..., k])."""
    packed = np.ascontiguousarray(packed)
    k = packed.shape[-1] // 2
    return packed[..., :k].view(np.int32), packed[..., k:].view(np.float32)


@_with_kernel_impls
def bert_sparse_batch(params: dict, ids: torch.Tensor, mask: torch.Tensor,
                      config: BertConfig, opts: ComputeOptions, k: int,
                      gather_idx: torch.Tensor | None = None,
                      budget: int = SPARSE_TILE_BUDGET) -> torch.Tensor:
    """SPLADE: token ids [B, S] -> the top-k of each row's |V|-wide sparse
    vector, packed [B (or M), 2k] (`pack_sparse_topk`).  The final states
    go through the MLM transform in f32 (dense + bias, GELU, LayerNorm to
    the activation dtype), then the decoder, the tied word table, through
    `linear` (K1 or K8 as the route says) with the |V| bias; the vector is
    the max over real tokens of log1p(relu(logits)) in f32.  The max runs
    over token chunks of `sparse_chunk(budget)`, so the [B, S, V] logits
    never exist whole; a max is exact in any chunk order."""
    mlm = params.get("mlm")
    if mlm is None:
        raise ValueError("model has no MLM head (not a SPLADE checkpoint)")
    h = bert_embed_batch(params, ids, mask, config, opts, token_states=True)
    b, s, _ = h.shape
    t = h @ mlm["dense_w"] + mlm["dense_b"]
    t = F.gelu(t, approximate="tanh" if config.gelu == "tanh" else "none")
    t = layer_norm(t, mlm["ln_scale"], mlm["ln_bias"], config.layer_norm_eps, opts.tdtype)
    maskf = mask.to(torch.float32)
    sparse = torch.zeros((b, config.n_vocab), dtype=torch.float32, device=h.device)
    cs = sparse_chunk(s, b, config.n_vocab, budget)
    for c0 in range(0, s, cs):
        logits = linear(t[:, c0:c0 + cs], mlm["decoder_w"], mlm["bias"])  # [B, cs, V]
        w = torch.log1p(torch.relu(logits.to(torch.float32))) * maskf[:, c0:c0 + cs, None]
        sparse = torch.maximum(sparse, torch.amax(w, dim=1))
    if gather_idx is not None:
        sparse = sparse[gather_idx]
    val, idx = torch.topk(sparse, k)
    return pack_sparse_topk(idx, val)
