"""The embedding engine: model + tokenizer + batched forward on a device.

The encode and rerank paths of the JAX package's `runtime/engine.py`:
tokenize -> plan (pack short sentences many to a row, bucket the rest by
length) -> launch every batch -> fetch once -> scatter back to input order;
cross-encoder pairs frame as [CLS] a [SEP] b [SEP] (RoBERTa, XLM-R and
MPNet: <s> a </s></s> b </s>) and run through the length buckets to one
logit per pair (`score_pairs`, `rerank`; T5 encoders have no head), and T5
frames a text as its ids + </s>, with no CLS.  `encode`
takes named or literal prompt prefixes, Matryoshka `dimensions` and
`truncate=False`; `encode_queries` / `encode_documents` apply the model's
query and document prompts, `encode_with_counts` also returns the token
counts.  The token-level surfaces: `encode_token_states` (every family's
final states), ColBERT late interaction (`maxsim`, `maxsim_tokens`,
`maxsim_rerank`, with the checkpoint's [Q]/[D] framing, [MASK] query
augmentation and punctuation skiplist) and SPLADE sparse vectors
(`encode_sparse`, `sparse_tokens`); they refuse a list past the context
and batch as `token_plan` says.  `embed_tokens_device` and
`token_states_device` leave their results on the device, for the
retrieval indexes to ingest.  The reference's bert.h surface rides
beside them: `tokenize`,
`n_max_tokens`, `id_to_token` and `decode`; every `embed_tokens` call
adds its sentences, tokens, batches and padded token slots to `stats` and
to the process's metrics (`utils/metrics.GLOBAL`, the server's TPES
frame).  Each phase of a call is a span there (`timers_s` /
`timer_counts`), and a profiler range while a profiler records:
`encode` (the whole `encode_with_counts`) over `tokenize`, then `eval`
over `plan` (packing, buckets, id checks), `launch` (every batch's forward
enqueued) and `fetch` (the join and the one host copy), then `finish` (the
scatter to input order and the stats; again for `dimensions`' cut).  The
engine runs on the GPU unless the caller passes
`device="cpu"`; with no device given and no GPU present it raises instead
of falling back.  `mesh=` (parallel/mesh.py) runs every forward over a
[dp, tp] mesh instead: the weights are split Megatron-style over tp, each
batch's rows over dp (parallel/sharding.py), and the outputs come back in
order; on a multi-process mesh every process must make the same calls
(parallel/distributed.py).
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import replace
from typing import Sequence

import numpy as np
import torch

from ..gguf.constants import Keys
from ..gguf.reader import GGUFReader
from ..models.bert import (
    SPARSE_TILE_BUDGET,
    ComputeOptions,
    bert_embed_batch,
    bert_embed_packed,
    bert_score_batch,
    bert_sparse_batch,
    check_pack_seq,
    maxsim_scores,
    project_token_states,
    fetch_output,
    unpack_sparse_topk,
)
from ..models.config import BertConfig
from ..models.params import load_params, params_to, random_params
from ..tokenizer import (
    SpecialIds,
    frame_ids,
    frame_pair_ids,
    load_tokenizer,
)
from ..tokenizer.base import _strip_pad
from ..utils.metrics import GLOBAL as metrics
from .batching import (
    DEFAULT_BATCH_BUCKETS,
    DEFAULT_PACK_SEQ,
    DEFAULT_SEQ_BUCKETS,
    PackedBatch,
    PackedSegBatch,
    bucket_for,
    pack_batches,
    pack_segments,
)

# the device top-k widths of the sparse head, the JAX Engine's: a client's
# k runs at the next one and is cut on the host, so both packages keep the
# same terms where weights tie at the cut
SPARSE_K_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def resolve_device(device=None) -> torch.device:
    """`device`, or the GPU when none is given; raises when none is given
    and no GPU is present."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def truncate_normalize(vecs: np.ndarray, dimensions: int) -> np.ndarray:
    """Matryoshka reduction: the first `dimensions` components of each row,
    L2-normalized again (the OpenAI embeddings API's `dimensions`)."""
    n_embd = vecs.shape[-1]
    if not isinstance(dimensions, int) or isinstance(dimensions, bool):
        raise ValueError("dimensions must be an integer")
    if not 1 <= dimensions <= n_embd:
        raise ValueError(f"dimensions must be in 1..{n_embd}")
    if dimensions == n_embd:
        return vecs
    v = np.ascontiguousarray(vecs[..., :dimensions], dtype=np.float32)
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def long_seq_buckets(n_ctx: int, seq_buckets: Sequence[int] = DEFAULT_SEQ_BUCKETS
                     ) -> tuple[int, ...]:
    """The length buckets up to n_ctx (n_ctx alone where none fits).  The
    default buckets extend in powers of two past 512 for long-context
    encoders (ModernBERT: ..., 512, 1024, 2048, 4096, 8192), so long texts
    batch at their length instead of being cut to the top default bucket; a
    caller's buckets are kept as given."""
    buckets = tuple(b for b in seq_buckets if b <= n_ctx) or (n_ctx,)
    b = buckets[-1]
    while seq_buckets is DEFAULT_SEQ_BUCKETS and b < n_ctx:
        b = min(b * 2, n_ctx)
        buckets += (b,)
    return buckets


def segment_bound(pb: PackedSegBatch) -> int | None:
    """The bound on a packed batch's longest segment that its forward may
    window by: the next power of two >= it (at least 32), for rows of 1024
    tokens or more only (the windowed segment kernel starts there)."""
    if pb.ids.shape[1] < 1024:
        return None
    return 1 << max(5, (max(pb.max_len, 1) - 1).bit_length())


def _check_ids(arrays: Sequence[np.ndarray], n: int, what: str) -> None:
    """Refuse ids outside 0..n-1 before anything launches: on the card an
    out-of-range row gather fires a device-side assert, which loses the
    process's CUDA context for every later call."""
    for a in arrays:
        if a.size and (a.min() < 0 or a.max() >= n):
            bad = int(a[(a < 0) | (a >= n)][0])
            raise ValueError(f"{what} {bad} outside 0..{n - 1}")


class Engine:
    """Text -> L2-normalized embedding vectors."""

    def __init__(
        self,
        params: dict,
        config: BertConfig,
        tokenizer=None,
        special_ids: SpecialIds | None = None,
        *,
        opts: ComputeOptions | None = None,
        device=None,
        seq_buckets: Sequence[int] = DEFAULT_SEQ_BUCKETS,
        batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
        packing: str = "auto",
        pack_seq: int | None = None,
        prompts: dict[str, str] | None = None,
        default_prompt_name: str = "",
        mesh=None,
    ):
        self.mesh = mesh
        self.device = mesh.device(0, 0) if mesh is not None else resolve_device(device)
        self.config = config
        self.opts = opts or ComputeOptions()
        if self.device.type == "cpu" and "kernel" in (self.opts.q4_impl, self.opts.attn_impl):
            raise ValueError(f"q4_impl / attn_impl 'kernel' on the CPU: no kernel runs there "
                             f"(opts {self.opts})")
        self.tokenizer = tokenizer
        # named prompt prefixes ("search_query: ", ...), resolved once per
        # encode call (resolve_prompt); embed_tokens never applies them
        self.prompts = dict(prompts or {})
        if default_prompt_name and default_prompt_name not in self.prompts:
            raise ValueError(f"default_prompt_name {default_prompt_name!r} is not in "
                             f"prompts {sorted(self.prompts)}")
        self.default_prompt_name = default_prompt_name or ""
        self.special_ids = special_ids or SpecialIds(cls=101, sep=102, pad=0, unk=100)
        self.seq_buckets = long_seq_buckets(config.n_ctx, seq_buckets)
        self.batch_buckets = tuple(batch_buckets)
        if mesh is not None:
            # every dispatched batch must split evenly over dp
            self.batch_buckets = tuple(b for b in self.batch_buckets
                                       if b % mesh.dp == 0) or (mesh.dp,)
        # per-dispatch token budget: longer sequence buckets get fewer rows
        # (8192-token rows batch 128 at a time, not 2048); from the caller's
        # top row bucket, so a larger one is reachable, and never below the
        # default's
        self.max_batch_tokens = max(max(batch_buckets), DEFAULT_BATCH_BUCKETS[-1]) * 512
        if packing not in ("auto", "always", "never"):
            raise ValueError(f"packing must be auto/always/never, got {packing!r}")
        self.packing = packing
        # packed rows past 1024 tokens take the segment kernels (K6, and mode
        # 3 on ModernBERT's local layers)
        self.pack_seq = min(pack_seq or DEFAULT_PACK_SEQ, config.n_ctx)
        self.pack_segs = max(8, self.pack_seq // 8)
        if packing != "never":
            check_pack_seq(config, self.pack_seq)
        # serializes planning + launches across threads (the server's
        # executor threads share one engine)
        self._lock = threading.Lock()
        self.stats = {"sentences": 0, "tokens": 0, "batches": 0, "eval_time": 0.0}
        self._sharded = None
        if mesh is not None:
            from ..parallel.sharding import shard_params

            self._sharded = shard_params(params, config, mesh)
            # slot (0, 0)'s weights: what the engine reads of them (tables'
            # shapes) is the same on every slot
            self.params = self._sharded[0, 0]
        else:
            self.params = params_to(params, self.device)

    # --- constructors -------------------------------------------------------
    @classmethod
    def from_gguf(cls, path: str, *, weight_mode: str = "auto",
                  opts: ComputeOptions | None = None, device=None,
                  tokenizer_backend: str = "auto", mesh=None, **kw) -> "Engine":
        """weight_mode "auto" keeps quantized weights packed for the fused
        dequant-matmul kernel; "dequant" stores them dense in the activation
        dtype (models/params.py).  tokenizer_backend is `load_tokenizer`'s:
        "auto" takes the native engines where they load the json.  With a
        `mesh` the weights load on the host and go to its slots."""
        device = torch.device("cpu") if mesh is not None else resolve_device(device)
        opts = opts or ComputeOptions()
        with GGUFReader(path) as r:
            params, config = load_params(r, weight_mode=weight_mode, dense_dtype=opts.tdtype,
                                         device=device)
            blob = r.kv.get(Keys.TOKENIZER_JSON_BLOB)
            tokenizer = load_tokenizer(blob, tokenizer_backend) if blob else None
            special = SpecialIds.from_gguf_kv(r.kv)
            prompts = r.kv.get(Keys.PROMPTS)
            if prompts and "prompts" not in kw:
                kw["prompts"] = json.loads(prompts)
                # a caller's default wins over the file's
                kw.setdefault("default_prompt_name", str(r.kv.get(Keys.DEFAULT_PROMPT, "")))
        return cls(params, config, tokenizer, special, opts=opts, device=device, mesh=mesh,
                   **kw)

    @classmethod
    def from_hf_dir(cls, model_dir: str, *, ftype: str = "f32", **kw) -> "Engine":
        """A local HF checkpoint directory, converted to a temporary GGUF of
        `ftype` and loaded from it (`from_gguf`'s keywords)."""
        import tempfile

        from ..models.convert import convert_hf_dir

        with tempfile.NamedTemporaryFile(suffix=".gguf") as f:
            convert_hf_dir(model_dir, f.name, ftype)
            return cls.from_gguf(f.name, **kw)

    @classmethod
    def from_legacy_bin(cls, path: str, **kw) -> "Engine":
        """A legacy pre-GGUF ggml-model*.bin (magic 'ggml'), upgraded to a
        temporary GGUF of its own dtype and loaded from it, so every later
        step is `from_gguf`'s."""
        import tempfile

        from ..gguf.legacy import upgrade_legacy_bin

        with tempfile.NamedTemporaryFile(suffix=".gguf") as f:
            upgrade_legacy_bin(path, f.name)
            return cls.from_gguf(f.name, **kw)

    @classmethod
    def synthetic(cls, config: BertConfig, ftype="f32", *, seed: int = 0,
                  opts: ComputeOptions | None = None, device=None, mesh=None,
                  **kw) -> "Engine":
        """Random-weight engine with the synthetic WordPiece vocab (needs
        n_vocab >= 242; smaller vocabs get no tokenizer)."""
        from ..tokenizer.testvocab import build_tokenizer_json

        device = torch.device("cpu") if mesh is not None else resolve_device(device)
        opts = opts or ComputeOptions()
        params = random_params(config, ftype, seed=seed, dense_dtype=opts.tdtype,
                               device=device)
        tokenizer = special = None
        try:
            blob = build_tokenizer_json(config.n_vocab)
        except ValueError:  # vocab too small for the synthetic word list
            pass
        else:
            tokenizer = load_tokenizer(blob)
            special = SpecialIds(cls=2, sep=3, pad=0, unk=1)
        return cls(params, config, tokenizer, special, opts=opts, device=device, mesh=mesh,
                   **kw)

    # --- tokenize -----------------------------------------------------------
    def tokenize(self, text: str) -> list[int]:
        """Framed token ids ([CLS] .. [SEP]; T5: .. </s>) of one text, the
        reference's bert_tokenize."""
        return self.tokenize_batch([text])[0]

    def tokenize_batch(self, texts: Sequence[str], *,
                       truncate: bool = True) -> list[list[int]]:
        """Tokenize + frame each text ([CLS] .. [SEP]; T5 .. </s>; cut at
        n_ctx).
        truncate=False raises instead, naming the first text whose framed
        ids pass the context."""
        if self.tokenizer is None:
            raise RuntimeError("engine has no tokenizer (model without blob kv)")
        with metrics.timer("tokenize"):
            raw = self.tokenizer.encode_batch(list(texts))
            # T5 frames ids + [</s>], with no CLS
            add_cls = self.config.arch != "t5"
            if not truncate:
                cap = self.config.n_ctx
                for i, ids in enumerate(raw):
                    need = len(_strip_pad(ids, self.special_ids.pad)) + 1 + add_cls
                    if need > cap:
                        raise ValueError(f"input {i} is {need} tokens framed, over the "
                                         f"model's {cap}-token context (set truncate=true "
                                         "to cut, or split the text)")
            return [frame_ids(ids, self.special_ids, self.config.n_ctx, add_cls=add_cls)
                    for ids in raw]

    # --- forward ------------------------------------------------------------
    def _pack_plan(self, token_lists: Sequence[Sequence[int]]) -> list[int]:
        """Indices of sentences to route through the sequence-packed path
        (the rest go through plain length-bucketed batching)."""
        if self.packing == "never":
            return []
        packable = [i for i, t in enumerate(token_lists) if len(t) <= self.pack_seq]
        if self.packing == "always":
            return packable
        # auto: packing pays off when many short sentences would otherwise
        # spread over several dispatches; long sentences already fill rows
        short = [i for i in packable if len(token_lists[i]) <= self.pack_seq // 4]
        return short if len(short) >= 32 else []

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @property
    def _dp(self) -> int:
        return self.mesh.dp if self.mesh is not None else 1

    def _run(self, fn, rows: Sequence, **kw) -> torch.Tensor:
        """fn(params, *rows, **kw) on the engine's device, or over the mesh:
        `rows` (numpy or tensors) split over dp, the outputs back in row
        order on the engine's device (parallel/sharding.py)."""
        if self._sharded is None:
            return fn(self.params, *(self._tensor(r) if isinstance(r, np.ndarray) else r
                                     for r in rows), **kw)
        return self._sharded.run(fn, rows, kw)

    def _embed_batch(self, ids: np.ndarray, mask: np.ndarray, opts: ComputeOptions,
                     n_real: int | None = None) -> torch.Tensor:
        """The vectors of a plain batch's first `n_real` rows (all by
        default), gathered on the device: on the engine's device, or over
        the mesh (`ShardedForward.gather`, every row on every process)."""
        n_real = len(ids) if n_real is None else n_real
        if self._sharded is None:
            gidx = self._tensor(np.arange(n_real)) if n_real < len(ids) else None
            return bert_embed_batch(self.params, self._tensor(ids), self._tensor(mask),
                                    self.config, opts, gather_idx=gidx)
        from ..parallel.sharding import ShardedForward

        return ShardedForward(self.config, opts).gather(self._sharded, ids, mask,
                                                        np.arange(n_real))

    def _embed_packed(self, pb: PackedSegBatch, opts: ComputeOptions) -> torch.Tensor:
        """The vectors of a packed batch's real sentences (its flat slots),
        gathered on the device: padding never leaves it."""
        gidx = pb.slots.astype(np.int64)
        kw = dict(n_seg=pb.n_seg, max_seg_len=segment_bound(pb))
        if self._sharded is None:
            return bert_embed_packed(self.params, self._tensor(pb.ids), self._tensor(pb.seg),
                                     self._tensor(pb.pos), self.config, opts,
                                     gather_idx=self._tensor(gidx), **kw)
        from ..parallel.sharding import make_packed_forward

        return make_packed_forward(self.mesh, self.config, opts)(
            self._sharded, pb.ids, pb.seg, pb.pos, gidx, **kw)

    def _dispatch(self, token_lists: Sequence[Sequence[int]],
                  opts: ComputeOptions | None = None) -> list:
        """Plan and launch every batch; returns [(batch, device_result)].
        `opts` overrides the engine's (embed_tokens_device: f32 output).
        Caller holds self._lock."""
        opts = opts or self.opts
        n = len(token_lists)
        with metrics.timer("plan"):
            pack_idx = self._pack_plan(token_lists)
            pack_set = set(pack_idx)
            rest = [i for i in range(n) if i not in pack_set]
            packed_batches = (
                pack_segments([token_lists[i] for i in pack_idx], pack_idx,
                              self.special_ids.pad, seq_len=self.pack_seq,
                              n_seg=self.pack_segs, row_multiple=self._dp)
                if pack_idx else []
            )
            batches = pack_batches(
                [token_lists[i] for i in rest], self.special_ids.pad,
                seq_buckets=self.seq_buckets, batch_buckets=self.batch_buckets,
                max_seq=self.config.n_ctx, max_tokens=self.max_batch_tokens,
            )
            for batch in batches:
                batch.positions = [rest[i] for i in batch.positions]
            _check_ids([b.ids for b in (*packed_batches, *batches)], self.config.n_vocab,
                       "token id")
        metrics.inc("padded_slots", sum(b.ids.size for b in (*packed_batches, *batches)))
        pending = []
        with metrics.timer("launch"), torch.inference_mode():
            for pb in packed_batches:
                pending.append((pb, self._embed_packed(pb, opts)))
            for batch in batches:
                pending.append((batch, self._embed_batch(batch.ids, batch.mask, opts,
                                                         len(batch.positions))))
        return pending

    def embed_tokens(self, token_lists: Sequence[Sequence[int]]) -> np.ndarray:
        """Token-id lists -> [n, n_embd] f32.  Every batch is launched
        before the first fetch, and the results cross to the host once;
        the fetch waits outside the lock, so another caller's launches
        queue behind this call's work meanwhile."""
        out = np.empty((len(token_lists), self.n_embd), dtype=np.float32)
        t0 = time.perf_counter()
        with metrics.timer("eval"), contextlib.ExitStack() as fetch:
            with self._lock:
                pending = self._dispatch(token_lists)
                # the fetch span runs on past the lock, to the host copy's end
                fetch.enter_context(metrics.timer("fetch"))
                joined = torch.cat([v for _, v in pending], dim=0) if pending else None
            host = fetch_output(joined) if joined is not None else None
        with metrics.timer("finish"):
            off = 0
            for batch, vecs in pending:
                rows = batch.orig if isinstance(batch, PackedSegBatch) else batch.positions
                out[rows] = host[off : off + len(rows)]
                off += vecs.shape[0]
            self._count_stats(token_lists, len(pending), t0)
        return out

    def embed_tokens_device(self, token_lists: Sequence[Sequence[int]]) -> list:
        """`embed_tokens` whose vectors stay on the device: [(positions,
        [n, n_embd] f32 device vectors)] per launched batch, the rows of the
        real sentences only.  An int8-output engine runs its float32-output
        forward here (the codes exist only for the host transfer); the
        on-device VectorIndex ingests through this."""
        if self.opts.output_dtype == "int8" and self.mesh is not None:
            # as the JAX Engine, whose mesh forwards are built once with the
            # engine's output encoding
            raise ValueError("embed_tokens_device on a mesh needs a float output_dtype "
                             "(int8 results are packed for host transfer)")
        t0 = time.perf_counter()
        out = []
        opts = replace(self.opts, output_dtype="float32")
        with self._lock, metrics.timer("eval"):
            pending = self._dispatch(token_lists, opts)
        with metrics.timer("finish"):
            for batch, vecs in pending:
                rows = batch.orig if isinstance(batch, PackedSegBatch) else batch.positions
                out.append((np.asarray(rows, np.int64), vecs[: len(rows)]))
            self._count_stats(token_lists, len(out), t0)
        return out

    def _count_stats(self, token_lists, n_batches: int, t0: float) -> None:
        """Add one call's sentences, tokens, batches and seconds to `stats`
        and to the process's metrics."""
        n = len(token_lists)
        n_tokens = int(sum(len(t) for t in token_lists))
        with self._lock:
            self.stats["eval_time"] += time.perf_counter() - t0
            self.stats["sentences"] += n
            self.stats["tokens"] += n_tokens
            self.stats["batches"] += n_batches
        metrics.inc("sentences", n)
        metrics.inc("tokens", n_tokens)
        metrics.inc("batches", n_batches)

    def resolve_prompt(self, prompt_name: str | None = None,
                       prompt: str | None = None) -> str:
        """The prefix an encode call prepends (sentence-transformers
        semantics): a literal `prompt` wins; `prompt_name` names one of the
        model's prompts; None takes the default prompt; "" none."""
        if prompt is not None:
            if not isinstance(prompt, str):
                raise ValueError("prompt must be a string")
            return prompt
        if prompt_name is None:
            prompt_name = self.default_prompt_name
        if prompt_name == "":
            return ""
        if not isinstance(prompt_name, str) or prompt_name not in self.prompts:
            raise ValueError(f"unknown prompt_name {prompt_name!r} "
                             f"(model prompts: {sorted(self.prompts)})")
        return self.prompts[prompt_name]

    def encode(self, texts: str | Sequence[str], *, dimensions: int | None = None,
               prompt_name: str | None = None, prompt: str | None = None,
               truncate: bool = True) -> np.ndarray:
        """Texts -> [n, n_embd] L2-normalized f32 embeddings; the prompt
        prefix (`resolve_prompt`) goes before every text, `dimensions`
        keeps that many leading components, normalized again, and
        truncate=False raises on a text past the context instead of
        cutting it."""
        return self.encode_with_counts(texts, dimensions=dimensions, prompt_name=prompt_name,
                                       prompt=prompt, truncate=truncate)[0]

    def query_prompt_prefix(self) -> str:
        """The prefix for search queries: prompt "query" when the model
        declares one (sentence-transformers' encode_query), else the
        default prompt, else ""."""
        return self.resolve_prompt("query" if "query" in self.prompts else None)

    def document_prompt_prefix(self) -> str:
        """The prefix for corpus documents: the first of "document" /
        "passage" the model declares (sentence-transformers'
        encode_document), else the default prompt, else ""."""
        return self.resolve_prompt(
            next((n for n in ("document", "passage") if n in self.prompts), None))

    def encode_queries(self, texts: str | Sequence[str], **kw) -> np.ndarray:
        """encode() with the model's query prefix (query_prompt_prefix)."""
        return self.encode(texts, prompt=self.query_prompt_prefix(), **kw)

    def encode_documents(self, texts: str | Sequence[str], **kw) -> np.ndarray:
        """encode() with the model's document prefix (document_prompt_prefix)."""
        return self.encode(texts, prompt=self.document_prompt_prefix(), **kw)

    def encode_with_counts(self, texts: str | Sequence[str], *, dimensions: int | None = None,
                           prompt_name: str | None = None, prompt: str | None = None,
                           truncate: bool = True) -> tuple[np.ndarray, list[int]]:
        """encode() plus each text's framed token count ([CLS] and [SEP]
        and the prompt's tokens included), from the tokenization that fed
        the forward: what a usage report counts."""
        with metrics.timer("encode"):
            if isinstance(texts, str):
                texts = [texts]
            prefix = self.resolve_prompt(prompt_name, prompt)
            if prefix:
                texts = [prefix + t for t in texts]
            ids = self.tokenize_batch(texts, truncate=truncate)
            out = self.embed_tokens(ids)
            if dimensions is not None:
                with metrics.timer("finish"):
                    out = truncate_normalize(out, dimensions)
            return out, [len(t) for t in ids]

    # --- cross-encoder scoring ----------------------------------------------
    def tokenize_pairs(self, pairs: Sequence[tuple[str, str]]
                       ) -> tuple[list[list[int]], list[list[int]]]:
        """[(text_a, text_b), ...] -> (framed [CLS] a [SEP] b [SEP] id
        lists, parallel token-type id lists); RoBERTa, XLM-R and MPNet
        frame <s> a </s></s> b </s> with one segment."""
        if self.tokenizer is None:
            raise RuntimeError("engine has no tokenizer (model without blob kv)")
        with metrics.timer("tokenize"):
            raw = self.tokenizer.encode_batch([t for pair in pairs for t in pair])
            double_sep = self.config.arch in ("roberta", "mpnet")
            framed = [frame_pair_ids(raw[i], raw[i + 1], self.special_ids, self.config.n_ctx,
                                     double_sep=double_sep)
                      for i in range(0, len(raw), 2)]
            return [f[0] for f in framed], [f[1] for f in framed]

    def score_plan(self, token_lists: Sequence[Sequence[int]]) -> list:
        """The batches `score_token_pairs` launches for the lists: length
        buckets of real rows only (eager PyTorch compiles nothing per
        shape, so a row padded up to a row bucket would only add work)."""
        return pack_batches(
            token_lists, self.special_ids.pad, seq_buckets=self.seq_buckets,
            batch_buckets=self.batch_buckets, max_seq=self.config.n_ctx,
            max_tokens=self.max_batch_tokens, pad_rows=False,
        )

    def score_token_pairs(self, token_lists: Sequence[Sequence[int]],
                          type_lists: Sequence[Sequence[int]]) -> np.ndarray:
        """Framed pair-id lists (+ parallel type-id lists) -> [n] f32 logits
        ([n, n_labels] for multi-label heads).  Plain length buckets
        (`score_plan`), every batch launched before the one fetch, as
        `embed_tokens` does."""
        if self.config.n_labels == 0:
            raise RuntimeError("model has no classification head (embedding model); "
                               "rerank/score needs a *ForSequenceClassification checkpoint")
        if self.mesh is not None and self.mesh.multiprocess:
            raise RuntimeError("cross-encoder scoring on a multi-host mesh is not supported")
        out = np.empty((len(token_lists), self.config.n_labels), np.float32)
        with contextlib.ExitStack() as fetch:
            with self._lock:
                with metrics.timer("plan"):
                    batches = self.score_plan(token_lists)
                    type_arrays = []
                    for batch in batches:
                        types = np.zeros_like(batch.ids)
                        for row, idx in enumerate(batch.positions):
                            t = list(type_lists[idx])[: types.shape[1]]
                            types[row, : len(t)] = t
                        type_arrays.append(types)
                    _check_ids([b.ids for b in batches], self.config.n_vocab, "token id")
                    type_table = self.params["embeddings"].get("token_type")
                    if type_table is not None:
                        _check_ids(type_arrays, type_table.shape[0], "token type id")
                pending = []
                with metrics.timer("launch"), torch.inference_mode():
                    for batch, types in zip(batches, type_arrays):
                        logits = self._run(
                            lambda p, ids, mask, types: bert_score_batch(
                                p, ids, mask, self.config, self.opts, type_ids=types),
                            (batch.ids, batch.mask, types))
                        pending.append((batch, logits))
                if not pending:
                    return out[:, 0] if self.config.n_labels == 1 else out
                fetch.enter_context(metrics.timer("fetch"))
                joined = torch.cat([v for _, v in pending], dim=0)
            host = joined.cpu().numpy()
        with metrics.timer("finish"):
            off = 0
            for batch, _ in pending:
                out[batch.positions] = host[off: off + len(batch.positions)]
                off += len(batch.positions)
        return out[:, 0] if self.config.n_labels == 1 else out

    def score_pairs(self, pairs: Sequence[tuple[str, str]], *,
                    activation: str | None = None) -> np.ndarray:
        """(text_a, text_b) pairs -> relevance scores: raw logits, or
        activation="sigmoid" (sentence-transformers CrossEncoder's default
        for single-label heads)."""
        if activation not in (None, "sigmoid"):
            raise ValueError(f"unknown activation {activation!r}")
        scores = self.score_token_pairs(*self.tokenize_pairs(pairs))
        return 1.0 / (1.0 + np.exp(-scores)) if activation == "sigmoid" else scores

    def rerank(self, query: str, documents: Sequence[str], *, top_n: int | None = None,
               activation: str | None = "sigmoid") -> list[dict]:
        """Documents ranked by cross-encoder relevance to the query:
        [{"index": i, "relevance_score": s}, ...], descending, cut to top_n."""
        if self.config.n_labels > 1:
            raise RuntimeError(f"rerank needs a single-label head (n_labels="
                               f"{self.config.n_labels}); use score_pairs for multi-label")
        scores = self.score_pairs([(query, d) for d in documents], activation=activation)
        order = np.argsort(-scores, kind="stable")
        if top_n is not None:
            order = order[:top_n]
        return [{"index": int(i), "relevance_score": float(scores[i])} for i in order]

    # --- token states, ColBERT and SPLADE --------------------------------------
    def _check_context(self, token_lists: Sequence[Sequence[int]]) -> None:
        """Refuse a list longer than the context, as the JAX Engine's token
        surfaces do (embed_tokens cuts such a list instead), or than the top
        length bucket, which custom buckets may put below the context."""
        for i, ids in enumerate(token_lists):
            if len(ids) > self.config.n_ctx:
                raise ValueError(f"token list {i} has {len(ids)} ids, over the model's "
                                 f"{self.config.n_ctx}-token context")
            if len(ids) > self.seq_buckets[-1]:
                raise ValueError(f"token list {i} has {len(ids)} ids, over the top length "
                                 f"bucket {self.seq_buckets[-1]} (seq_buckets "
                                 f"{self.seq_buckets})")

    def _length_dependent(self) -> bool:
        """Whether a row's states depend on the length it is padded to:
        nomic's dynamic-NTK RoPE base grows with S past rope_max_trained."""
        c = self.config
        return c.arch == "nomic-bert" and c.rope_scaling_factor > 0 and c.rope_max_trained > 0

    def token_plan(self, token_lists: Sequence[Sequence[int]], *,
                   max_rows: int | None = None) -> list[PackedBatch]:
        """The batches the token surfaces (token states, MaxSim documents,
        SPLADE) launch for the lists: real rows only, at most `max_rows` a
        batch.  Where states depend on the padded length (`_length_dependent`)
        the lists go as the JAX Engine's `_padded_chunks` sends them: the
        top row bucket's worth a chunk, in input order, padded to the length
        bucket of the chunk's longest list (launched in row slices within the
        token budget, which moves no row's S).  Elsewhere they go by length
        bucket, which gives the same states."""
        self._check_context(token_lists)
        buckets = tuple(b for b in self.batch_buckets if b <= (max_rows or self.batch_buckets[-1]))
        if not self._length_dependent():
            return pack_batches(
                token_lists, self.special_ids.pad, seq_buckets=self.seq_buckets,
                batch_buckets=buckets, max_seq=self.config.n_ctx,
                max_tokens=self.max_batch_tokens, pad_rows=False)
        out = []
        for lo in range(0, len(token_lists), buckets[-1]):
            chunk = token_lists[lo: lo + buckets[-1]]
            s = bucket_for(max(len(t) for t in chunk), self.seq_buckets)
            step = max(1, self.max_batch_tokens // s)
            for a in range(0, len(chunk), step):
                rows = chunk[a: a + step]
                ids = np.full((len(rows), s), self.special_ids.pad, np.int32)
                mask = np.zeros((len(rows), s), np.int32)
                for r, t in enumerate(rows):
                    ids[r, : len(t)] = t
                    mask[r, : len(t)] = 1
                out.append(PackedBatch(ids, mask, list(range(lo + a, lo + a + len(rows)))))
        return out

    def _token_batches(self, token_lists: Sequence[Sequence[int]], forward, *,
                       max_rows: int | None = None) -> list:
        """Launch `forward(ids, mask, batch)` over `token_plan(token_lists)`
        under the lock; returns [(batch, device result)], fetched by the
        caller outside it."""
        with self._lock:
            with metrics.timer("plan"):
                batches = self.token_plan(token_lists, max_rows=max_rows)
                _check_ids([b.ids for b in batches], self.config.n_vocab, "token id")
            with metrics.timer("launch"), torch.inference_mode():
                return [(b, forward(self._tensor(b.ids), self._tensor(b.mask), b))
                        for b in batches]

    def _token_states(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """[B, S, E] f32 final states, ColBERT-projected where the model has
        the projection.  Refused on a multi-process mesh, whose followers
        replay only embed and sparse calls (parallel/distributed.py)."""
        if self.mesh is not None and self.mesh.multiprocess:
            raise RuntimeError("token states on a multi-host mesh are not supported")
        return self._run(lambda p, ids, mask: project_token_states(p, bert_embed_batch(
            p, ids, mask, self.config, self.opts, token_states=True)), (ids, mask))

    def encode_token_states(self, texts: Sequence[str]) -> list[np.ndarray]:
        """Per-token final hidden states (HF last_hidden_state; ColBERT
        models: projected): one [len_i, E] f32 array per text over its
        framed tokens, padding excluded.  No pooling, prompt, packing or
        transfer encoding."""
        return self.token_states_tokens(self.tokenize_batch(texts))

    def token_states_tokens(self, token_lists: Sequence[Sequence[int]]) -> list[np.ndarray]:
        """Token-id lists -> one [len, E] f32 array of final states each."""
        out: list = [None] * len(token_lists)
        pending = self._token_batches(token_lists,
                                      lambda ids, mask, _: self._token_states(ids, mask))
        for batch, dev in pending:
            host = dev.cpu().numpy()
            for row, i in enumerate(batch.positions):
                out[i] = host[row, : len(token_lists[i])]
        return out

    def token_states_device(self, token_lists: Sequence[Sequence[int]]):
        """`token_states_tokens` whose states stay on the device: yields
        (positions, [B, S, E] f32 device states, mask [B, S] int32 numpy,
        lens) per batch of `token_plan`, each launched as it is taken.  The
        MaxSimIndex ingests through this."""
        with self._lock:
            batches = self.token_plan(token_lists)
            _check_ids([b.ids for b in batches], self.config.n_vocab, "token id")
        for b in batches:
            with self._lock, torch.inference_mode():
                dev = self._token_states(self._tensor(b.ids), self._tensor(b.mask))
            yield b.positions, dev, b.mask, [len(token_lists[i]) for i in b.positions]

    def colbert_skiplist(self) -> frozenset[int]:
        """The document token ids ColBERT leaves out of scoring: the first
        token of each punctuation character (colbert-ai's skiplist); empty
        where the checkpoint sets mask_punctuation off."""
        if not self.config.mask_punctuation:
            return frozenset()
        if getattr(self, "_skiplist", None) is None:
            import string

            encoded = self.tokenizer.encode_batch(list(string.punctuation))
            self._skiplist = frozenset(int(e[0]) for e in encoded if len(e))
        return self._skiplist

    def _colbert_frame(self, texts: Sequence[str], marker: int, maxlen: int) -> list[list[int]]:
        """[CLS] <marker> tokens [SEP], cut to maxlen with [SEP] kept last."""
        if self.config.colbert_dim <= 0:
            raise RuntimeError("not a ColBERT checkpoint (colbert_dim == 0)")
        out = []
        for ids in self.tokenize_batch(list(texts)):
            ids = [ids[0], marker] + list(ids[1:])
            if len(ids) > maxlen:
                ids = ids[: maxlen - 1] + [self.special_ids.sep]
            out.append(ids)
        return out

    def colbert_doc_tokens(self, texts: Sequence[str], cap: int | None = None) -> list[list[int]]:
        """Document framing: [CLS] [D] tokens [SEP], cut to min(cap, n_ctx)
        before the forward (ColBERT's doc_maxlen)."""
        maxlen = min(cap or self.config.n_ctx, self.config.n_ctx)
        return self._colbert_frame(texts, self.config.d_marker_id, maxlen)

    def colbert_query_ids(self, texts: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """Query framing: [CLS] [Q] tokens [SEP] padded with [MASK] to
        query_maxlen -> (ids [B, Lq] int32, attention mask [B, Lq] int32, 0
        on the [MASK] slots: not attended to, but scored)."""
        maxlen = min(self.config.query_maxlen, self.config.n_ctx)
        framed = self._colbert_frame(texts, self.config.q_marker_id, maxlen)
        ids = np.full((len(framed), maxlen), self.config.mask_id, np.int32)
        mask = np.zeros((len(framed), maxlen), np.int32)
        for i, row in enumerate(framed):
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        return ids, mask

    def colbert_query_vectors(self, texts: Sequence[str]) -> list[np.ndarray]:
        """Queries -> one [query_maxlen, colbert_dim] f32 matrix each (every
        slot, [MASK] augmentation included; not normalized)."""
        q_ids, q_attn = self.colbert_query_ids(texts)
        _check_ids([q_ids], self.config.n_vocab, "token id")
        with self._lock, torch.inference_mode():
            dev = self._token_states(self._tensor(q_ids), self._tensor(q_attn))
        host = dev.cpu().numpy()
        return [host[i].copy() for i in range(len(host))]

    def maxsim(self, query: str, documents: Sequence[str]) -> np.ndarray:
        """Late-interaction MaxSim relevance of each document to the query
        over final-state token vectors (`maxsim_scores`), with any family;
        ColBERT checkpoints frame with their markers, augment the query
        with [MASK] to query_maxlen, project, and skip punctuation."""
        if self.config.colbert_dim:
            return self.maxsim_tokens(None, self.colbert_doc_tokens(documents),
                                      _q_frame=self.colbert_query_ids([query]))
        return self.maxsim_tokens(self.tokenize(query), self.tokenize_batch(documents))

    def maxsim_tokens(self, q_tokens: Sequence[int] | None,
                      doc_token_lists: Sequence[Sequence[int]], *,
                      _q_frame: tuple[np.ndarray, np.ndarray] | None = None) -> np.ndarray:
        """Token-id form of `maxsim` -> [n_docs] f32.  `_q_frame` (the
        ColBERT path): the framed query (ids, attention mask) [1, Lq]; every
        slot then scores and the skiplist filters the documents' tokens."""
        colbert = _q_frame is not None
        if colbert:
            q_ids, q_attn = _q_frame
            q_score = np.ones_like(q_attn)
        else:
            if not q_tokens:
                raise ValueError("empty query")
            self._check_context([q_tokens])
            sq = bucket_for(len(q_tokens), self.seq_buckets)
            q_ids = np.zeros((1, sq), np.int32)
            q_ids[0, : len(q_tokens)] = q_tokens
            q_attn = np.zeros((1, sq), np.int32)
            q_attn[0, : len(q_tokens)] = 1
            q_score = q_attn
        _check_ids([q_ids], self.config.n_vocab, "token id")
        skip = torch.tensor(sorted(self.colbert_skiplist() if colbert else ()),
                            dtype=torch.int32, device=self.device)
        with self._lock, torch.inference_mode():
            q_dev = self._token_states(self._tensor(q_ids), self._tensor(q_attn))[0]
        q_mask = self._tensor(q_score[0])

        def forward(ids, mask, _):
            keep = mask if not skip.numel() else mask * ~torch.isin(ids, skip)
            return self._run(
                lambda p, ids, mask, keep, q_states, q_mask: maxsim_scores(
                    p, q_states, q_mask, ids, mask, self.config, self.opts, d_keep=keep),
                (ids, mask, keep), q_states=q_dev, q_mask=q_mask)

        out = np.empty(len(doc_token_lists), np.float32)
        for batch, dev in self._token_batches(doc_token_lists, forward):
            out[batch.positions] = dev.cpu().numpy()
        return out

    def maxsim_rerank(self, query: str, documents: Sequence[str], *,
                      top_n: int | None = None) -> list[dict]:
        """`maxsim` in the rerank shape: [{"index", "relevance_score"}, ...]
        descending, cut to top_n."""
        scores = self.maxsim(query, documents)
        order = np.argsort(-scores, kind="stable")
        if top_n is not None:
            order = order[:top_n]
        return [{"index": int(i), "relevance_score": float(scores[i])} for i in order]

    def encode_sparse(self, texts: Sequence[str], k: int = 256
                      ) -> list[tuple[np.ndarray, np.ndarray]]:
        """SPLADE: one (int32 term ids, f32 weights) pair per text, by
        descending weight, zero weights dropped, at most `k` terms (an
        MLM-head checkpoint; `models.bert.bert_sparse_batch`)."""
        return self.sparse_tokens(self.tokenize_batch(texts), k=k)

    def sparse_tokens(self, token_lists: Sequence[Sequence[int]], k: int = 256
                      ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Token-id lists -> (term ids, weights) per list (`encode_sparse`).
        The device top-k runs at the next width of SPARSE_K_BUCKETS, cut to
        k on the host; a batch holds at most the rows whose 8-token logits
        chunk fits the sparse tile budget."""
        if not self.config.mlm_head:
            raise ValueError("model has no MLM head (not a SPLADE checkpoint)")
        k = min(int(k), self.config.n_vocab)
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        k_run = min(next((kb for kb in SPARSE_K_BUCKETS if kb >= k), k), self.config.n_vocab)
        budget = self._sparse_budget()
        row_cap = max(1, budget // (8 * self.config.n_vocab * 4))

        def forward(ids, mask, _):
            return self._run(lambda p, ids, mask: bert_sparse_batch(
                p, ids, mask, self.config, self.opts, k_run, budget=budget), (ids, mask))

        out: list = [None] * len(token_lists)
        for batch, dev in self._token_batches(token_lists, forward, max_rows=row_cap):
            idx, val = unpack_sparse_topk(dev.cpu().numpy())
            for row, i in enumerate(batch.positions):
                n = int(np.count_nonzero(val[row, :k] > 0.0))
                out[i] = (idx[row, :n].copy(), val[row, :n].copy())
        return out

    def _sparse_budget(self) -> int:
        """Bytes of one f32 logits chunk of the sparse head: SPARSE_TILE_BUDGET
        on the CPU, 1/64 of the card's memory on a GPU (1.25 GB on an 80 GB
        card)."""
        if self.device.type != "cuda":
            return SPARSE_TILE_BUDGET
        return torch.cuda.get_device_properties(self.device).total_memory // 64

    def warmup(self, shapes: Sequence[tuple[int, int]] | None = None) -> None:
        """Run the forward once at each (batch, seq) shape, the smallest
        buckets' by default, under the lock.  On the card it first builds
        every kernel not built yet (ops/_build.py), and the forward starts
        cuBLAS, so no request pays for either."""
        if shapes is None:
            shapes = [(max(self.batch_buckets[0], self._dp), self.seq_buckets[0])]
        if self.device.type == "cuda":
            from ..ops import _build

            _build.build()  # every source not built yet, all nvcc at once
        with self._lock, torch.inference_mode():
            for b, s in shapes:
                ids = np.full((b, s), self.special_ids.pad, dtype=np.int32)
                mask = np.zeros((b, s), dtype=np.int32)
                mask[:, 0] = 1
                fetch_output(self._embed_batch(ids, mask, self.opts))

    # --- introspection (the reference's bert.h:87-90) ------------------------
    @property
    def n_embd(self) -> int:
        """Output embedding width: the Dense head's width when present."""
        return self.config.dense_out or self.config.n_embd

    @property
    def n_max_tokens(self) -> int:
        return self.config.n_ctx

    def id_to_token(self, token_id: int) -> str:
        """The token of an id; "" for an unknown id or without a tokenizer."""
        if self.tokenizer is None:
            return ""
        return self.tokenizer.id_to_token(token_id)

    def decode(self, ids: Sequence[int]) -> str:
        """Token ids -> text, by the tokenizer's decoder."""
        if self.tokenizer is None:
            raise RuntimeError("engine has no tokenizer (model without blob kv)")
        return self.tokenizer.decode(ids)
