"""Embedding TCP server over the port's Engine.

The wire protocol of the JAX package's `runtime/server.py`, on one port:

1. **ggml-compat raw mode**: on connect the server sends `n_embd` as a
   little-endian int32; each client message is raw UTF-8 text (one read,
   at most 32 KiB, is one message) and each reply is `n_embd` raw f32.
2. **Framed requests**, each starting with a 4-byte magic; a request that
   fails gets the error frame `u32 0xFFFFFFFF | u32 len | message` and the
   connection stays usable:
   - b"TPE2" encode: `u32 count | count * (u32 len | utf8 bytes)` ->
     `u32 count | count * n_embd * f32`;
   - b"\x01TP8" int8 encode: the TPE2 request -> `u32 count | count * f32
     scale | count * n_embd * i8` (vec = codes * scale);
   - b"TPES" stats -> `u32 len | JSON` (the metrics snapshot plus a
     "server" block); b"TPEH" health -> `u32 2 | "ok"`;
   - the reference's bert.h surface (the C client `native/capi/tpuembed.h`):
     b"\x01TPM" meta -> `u32 len | JSON {n_embd, n_max_tokens, name}`;
     b"\x01TPT" tokenize: texts -> `u32 n | n * (u32 k | k * i32)`;
     b"\x01TPI" eval: `u32 n | n * (u32 k | k * i32)` -> `u32 n | n *
     n_embd * f32` (an id outside 0..n_vocab-1 gets the error frame before
     anything launches, where the reference's gather clamps it);
     b"\x01TPV" vocab: `u32 id` -> `u32 len | utf8 token`
     (an unknown id gives an empty token);
   - b"\x01TPR" rerank (a model with a classification head): `u32 top_n (0 =
     all) | u32 len | query utf8 | u32 n | n * (u32 len | utf8 doc)` ->
     `u32 m | m * i32 index | m * f32 sigmoid score`, descending;
   - b"\x01TPX" MaxSim rerank (late interaction, any model; ColBERT
     checkpoints with their framing): the rerank layout -> the same reply
     with raw MaxSim scores;
   - b"\x01TPW" sparse encode (a SPLADE checkpoint): `u32 k | u32 count |
     count * (u32 len | utf8)` -> `u32 count | count * (u32 n | n * i32 term
     id | n * f32 weight)`, at most k terms each, by descending weight;
   - the on-device indexes, each built by its first index frame and
     shared by every connection: b"\x01TPB" (vector index), b"\x01TPY"
     (sparse, a SPLADE checkpoint), b"\x01TPF" (hybrid: the same documents
     into both, under one lock, the sparse encode first so that a failure
     leaves both unchanged) and b"\x01TPJ" (MaxSim): texts -> `u32 total`
     indexed; their searches b"\x01TPS", b"\x01TPZ", b"\x01TPG" (the two
     rankings fused by reciprocal rank) and b"\x01TPK": `u32 k | texts` ->
     `u32 n | u32 k | n * k * i32 id | n * k * f32 score` (id -1 and score
     -inf past the corpus; RRF scores for hybrid, 0.0 past its candidates);
     a search before its index gets the error frame.
   A head that starts with b"\x01" but is no magic desynchronizes the
   stream: it gets the error frame and the connection closes.

Encode requests from all connections merge into device batches through
one continuous batcher (a short micro-batching window); the other
requests run on executor threads, reranks, MaxSim, sparse, index and
search requests under the same pending budget.  `--http-port` serves the
HTTP/JSON surface (`runtime/http_server.py`) over the same batcher, and a
repeated `-m NAME=PATH` serves more models there, routed by a request's
"model" field.

    python -m embedding_cpp_tpu_torch.runtime.server -m m.gguf --port 8080 \
        [--http-port 8081 [-m other=o.gguf ...]] [--device cpu]
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import struct
import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..utils.metrics import GLOBAL as metrics

MAGIC = b"TPE2"
MAGIC_STATS = b"TPES"
MAGIC_HEALTH = b"TPEH"
MAGIC_TOKENIZE = b"\x01TPT"
MAGIC_EVAL = b"\x01TPI"
MAGIC_META = b"\x01TPM"
MAGIC_VOCAB = b"\x01TPV"
MAGIC_ENCODE_I8 = b"\x01TP8"
MAGIC_RERANK = b"\x01TPR"
MAGIC_SPARSE = b"\x01TPW"
MAGIC_MAXSIM = b"\x01TPX"
MAGIC_INDEX = b"\x01TPB"
MAGIC_SEARCH = b"\x01TPS"
MAGIC_SPARSE_INDEX = b"\x01TPY"
MAGIC_SPARSE_SEARCH = b"\x01TPZ"
MAGIC_HYBRID_INDEX = b"\x01TPF"
MAGIC_HYBRID_SEARCH = b"\x01TPG"
MAGIC_MAXSIM_INDEX = b"\x01TPJ"
MAGIC_MAXSIM_SEARCH = b"\x01TPK"
_INDEX_FRAMES = {MAGIC_INDEX: "index_texts", MAGIC_SPARSE_INDEX: "sparse_index_texts",
                 MAGIC_HYBRID_INDEX: "hybrid_index_texts",
                 MAGIC_MAXSIM_INDEX: "maxsim_index_texts"}
_SEARCH_FRAMES = {MAGIC_SEARCH: "search_texts", MAGIC_SPARSE_SEARCH: "sparse_search_texts",
                  MAGIC_HYBRID_SEARCH: "hybrid_search_texts",
                  MAGIC_MAXSIM_SEARCH: "maxsim_search_texts"}
_MAGICS = (MAGIC, MAGIC_STATS, MAGIC_HEALTH, MAGIC_TOKENIZE, MAGIC_EVAL, MAGIC_META,
           MAGIC_VOCAB, MAGIC_ENCODE_I8, MAGIC_RERANK, MAGIC_SPARSE, MAGIC_MAXSIM,
           *_INDEX_FRAMES, *_SEARCH_FRAMES)
RAW_CHUNK = 1 << 15  # the ggml-compat message cap
# caps on what one frame may ask the server to read or allocate
MAX_ITEMS = 1 << 16  # texts or id lists per request
MAX_TEXT_BYTES = 16 << 20  # per text
MAX_REQUEST_BYTES = 64 << 20  # aggregate text payload per request
MAX_IDS = 1 << 20  # per id list
MAX_REQUEST_IDS = 1 << 22  # aggregate ids per request
MAX_TOPK = 1 << 12  # search k
MAX_SPARSE_K = 4096  # sparse top-k width


class ProtocolError(Exception):
    pass


class OverloadedError(RuntimeError):
    """Backpressure: the batcher's pending-sentence budget is exhausted."""


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ProtocolError(f"malformed frame: {what}")


@dataclass
class ServerStats:
    """The server block of the TPES reply: connection, request, batch and
    error counts, and latency percentiles over the last LAT_WINDOW
    requests."""
    connections: int = 0
    requests: int = 0
    sentences: int = 0
    batches: int = 0
    errors: int = 0
    rejected: int = 0  # admission-control refusals
    latencies: list = field(default_factory=list, repr=False)
    _lat_idx: int = 0
    LAT_WINDOW = 1024

    def record_latency(self, seconds: float) -> None:
        if len(self.latencies) < self.LAT_WINDOW:
            self.latencies.append(seconds)
        else:
            self.latencies[self._lat_idx] = seconds
            self._lat_idx = (self._lat_idx + 1) % self.LAT_WINDOW

    def as_dict(self) -> dict:
        d = {k: v for k, v in self.__dict__.items()
             if not k.startswith("_") and k != "latencies"}
        if self.latencies:
            lat = np.sort(np.asarray(self.latencies))
            d["latency_ms"] = {
                "p50": round(float(lat[len(lat) // 2]) * 1e3, 2),
                "p95": round(float(lat[int(len(lat) * 0.95)]) * 1e3, 2),
                "p99": round(float(lat[min(int(len(lat) * 0.99), len(lat) - 1)]) * 1e3, 2),
                "window": len(lat),
            }
        return d


class ContinuousBatcher:
    """Merge pending encode requests across connections into device batches.

    Its spans (the process's metrics, `timers_s` / `timer_counts`):
    `queue_wait` per request, from its enqueue to `_run` taking it;
    `batch_form` per merged batch, from its first request taken to its task
    created (the merge window and the wait for a pipeline slot);
    `executor_wait` per batch, from its hand-off to the executor to the
    start of `encode_with_counts` on the worker thread.  None of them opens
    a profiler range: each crosses awaits, where other tasks run on the
    loop's thread, or threads."""

    def __init__(self, engine, max_batch: int = 256, window_ms: float = 2.0,
                 max_pending: int = 16384):
        self.engine = engine
        self.max_batch = max_batch
        self.window = window_ms / 1000.0
        self.max_pending = max_pending
        self._pending = 0
        self.queue: asyncio.Queue = asyncio.Queue()
        self.stats = ServerStats()
        self._task: asyncio.Task | None = None
        # the on-device indexes, built by their first index frame
        self.index = None
        self.sparse_index = None
        self.maxsim_index = None
        self._index_init_lock = threading.Lock()
        # spans both adds of a hybrid frame: two of them must not interleave
        # into different document ids in the two indexes
        self._hybrid_lock = threading.Lock()

    def _built(self, attr: str, make):
        """The index in `attr`, built by `make()` on first use (once, when
        two first index frames race on executor threads)."""
        if getattr(self, attr) is None:
            with self._index_init_lock:
                if getattr(self, attr) is None:
                    setattr(self, attr, make())
        return getattr(self, attr)

    def _mesh(self):
        return getattr(self.engine, "mesh", None)

    def _index(self, attr: str, cls, leader):
        """The index in `attr`, over the engine's mesh; on a multi-process
        mesh the leader's (`leader`), whose device ops the followers replay."""
        mesh = self._mesh()
        if mesh is not None and mesh.multiprocess:
            return self._built(attr, lambda: leader(self.engine))
        return self._built(attr, lambda: cls(self.engine, mesh=mesh))

    def _sparse(self):
        from ..parallel import distributed as dist
        from .sparse_search import SparseIndex

        return self._index("sparse_index", SparseIndex, dist.make_leader_sparse_index)

    def index_texts(self, texts: list[str]) -> int:
        from ..parallel import distributed as dist
        from .search import VectorIndex

        return self._index("index", VectorIndex, dist.make_leader_index).add(texts)

    def search_texts(self, texts: list[str], k: int):
        if self.index is None:
            raise RuntimeError("no index built (send an index frame first)")
        return self.index.search(texts, k)

    def sparse_index_texts(self, texts: list[str]) -> int:
        return self._sparse().add(texts)

    def sparse_search_texts(self, texts: list[str], k: int, candidates: int | None = None):
        """`candidates` asks for the two-stage mode, which only the device
        backend has: the host backend searches exactly instead."""
        if self.sparse_index is None:
            raise RuntimeError("no sparse index built (send a sparse index frame first)")
        if not self.sparse_index.device or self.sparse_index.mesh is not None:
            candidates = None  # the two-stage mode is one device's
        return self.sparse_index.search(texts, k, candidates=candidates)

    def maxsim_index_texts(self, texts: list[str]) -> int:
        from .maxsim_search import MaxSimIndex

        return self._built("maxsim_index",
                           lambda: MaxSimIndex(self.engine, mesh=self._mesh())).add(texts)

    def maxsim_search_texts(self, texts: list[str], k: int, candidates: int | None = None):
        if self.maxsim_index is None:
            raise RuntimeError("no MaxSim index built (send a MaxSim index frame first)")
        return self.maxsim_index.search(texts, k, candidates=candidates)

    def hybrid_index_texts(self, texts: list[str]) -> int:
        """The same documents into the dense and the sparse index (hybrid
        search needs equal ids in both).  The sparse encode, which can fail
        (a model without an MLM head), runs before either index changes,
        and the sparse append, which cannot, runs last."""
        with self._hybrid_lock:
            sparse = self._sparse()
            if self.index is not None and len(self.index) != len(sparse):
                raise RuntimeError(f"hybrid corpus desync: dense {len(self.index)} != sparse "
                                   f"{len(sparse)} docs (mixed /v1/index|/v1/sparse_index and "
                                   "/v1/hybrid_index calls?)")
            pairs = sparse.engine.encode_sparse(texts, k=sparse.k_encode)
            total = self.index_texts(texts)
            sparse.add_vectors(pairs)
            return total

    def hybrid_search_texts(self, texts: list[str], k: int):
        """Dense and sparse retrieval of k each, fused by reciprocal rank
        (`rrf_fuse`) to the top k."""
        from .sparse_search import rrf_fuse

        if self.index is None or self.sparse_index is None:
            raise RuntimeError("hybrid search needs both indexes (POST /v1/hybrid_index "
                               "first)")
        if len(self.index) != len(self.sparse_index):
            raise RuntimeError(f"hybrid corpus desync: dense {len(self.index)} != sparse "
                               f"{len(self.sparse_index)} docs")
        d_idx, _ = self.index.search(texts, k)
        s_idx, _ = self.sparse_index.search(texts, k)
        return rrf_fuse([d_idx, s_idx], k)

    async def start(self) -> None:
        self._task = asyncio.create_task(self._run())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    def try_reserve(self, n: int) -> None:
        """Admission control: reserve `n` sentences against the pending
        budget (encode requests and reranks on executor threads alike), or
        raise OverloadedError.  Call from the event loop only, and
        `release` in a finally."""
        if n > self.max_pending:
            self.stats.rejected += 1
            raise OverloadedError(
                f"request too large: {n} sentences exceed the pending cap "
                f"{self.max_pending}; split the request"
            )
        if self._pending + n > self.max_pending:
            self.stats.rejected += 1
            raise OverloadedError(
                f"server overloaded: {self._pending} sentences pending "
                f"(cap {self.max_pending})"
            )
        self._pending += n

    def release(self, n: int) -> None:
        self._pending -= n

    async def encode(self, texts: list[str], prefix: str | None = None) -> np.ndarray:
        return (await self.encode_with_counts(texts, prefix))[0]

    async def encode_with_counts(self, texts: list[str], prefix: str | None = None,
                                 truncate: bool = True) -> tuple[np.ndarray, list[int]]:
        """encode() and each text's token count, from the tokenization that
        fed the forward (the HTTP usage field).  `prefix` is this request's
        prompt prefix (None: the engine's default prompt), put before the
        texts here because one merged batch can carry requests with
        different prompts.  truncate=False tokenizes the texts first, to
        refuse one past the context as this request's error before it
        joins a shared batch."""
        if prefix is None:
            prefix = self.engine.resolve_prompt()
        if prefix:
            texts = [prefix + t for t in texts]
        if not truncate:
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: self.engine.tokenize_batch(texts, truncate=False))
        n = len(texts)
        self.try_reserve(n)
        try:
            fut = asyncio.get_running_loop().create_future()
            await self.queue.put((texts, fut, time.perf_counter()))
            return await fut
        finally:
            self.release(n)

    async def admitted(self, n: int, fn):
        """`fn()` (a rerank, MaxSim, sparse, index or search call) on an
        executor thread, its `n` texts admitted against the pending
        budget."""
        self.try_reserve(n)
        try:
            return await asyncio.get_running_loop().run_in_executor(None, fn)
        finally:
            self.release(n)

    async def _run(self) -> None:
        # pipeline depth 2: batch N+1 is planned while batch N computes
        sem = asyncio.Semaphore(2)
        inflight: set[asyncio.Task] = set()
        loop = asyncio.get_running_loop()
        try:
            while True:
                texts, fut, t_put = await self.queue.get()
                t_first = time.perf_counter()
                metrics.add_time("queue_wait", t_first - t_put)
                jobs = [(texts, fut)]
                total = len(texts)
                deadline = loop.time() + self.window
                while total < self.max_batch:
                    timeout = deadline - loop.time()
                    if timeout <= 0:
                        break
                    try:
                        t, f, t_put = await asyncio.wait_for(self.queue.get(), timeout)
                    except asyncio.TimeoutError:
                        break
                    metrics.add_time("queue_wait", time.perf_counter() - t_put)
                    jobs.append((t, f))
                    total += len(t)
                await sem.acquire()
                task = asyncio.create_task(self._run_batch(jobs, sem))
                metrics.add_time("batch_form", time.perf_counter() - t_first)
                inflight.add(task)
                task.add_done_callback(inflight.discard)
        finally:
            for task in inflight:
                task.cancel()

    async def _run_batch(self, jobs, sem: asyncio.Semaphore) -> None:
        flat = [text for texts, _ in jobs for text in texts]

        def encode(t_handed: float):
            metrics.add_time("executor_wait", time.perf_counter() - t_handed)
            # the prompts went on at enqueue time: prompt="" adds none here
            return self.engine.encode_with_counts(flat, prompt="")

        try:
            vecs, counts = await asyncio.get_running_loop().run_in_executor(
                None, encode, time.perf_counter())
            off = 0
            for texts, fut in jobs:
                if not fut.cancelled():
                    fut.set_result((vecs[off : off + len(texts)], counts[off : off + len(texts)]))
                off += len(texts)
            self.stats.batches += 1
            self.stats.sentences += len(flat)
        except Exception as e:  # every waiter of the batch gets the error
            self.stats.errors += 1
            for _, fut in jobs:
                if not fut.cancelled():
                    fut.set_exception(e)
        finally:
            sem.release()


async def _read_head(reader: asyncio.StreamReader) -> bytes:
    """Accumulate the 4-byte frame head across TCP segments while the bytes
    so far can still start a magic; return early when they cannot (raw
    mode is then served without waiting for a 4th byte)."""
    head = b""
    while len(head) < 4:
        chunk = await reader.read(4 - len(head))
        if not chunk:
            return head
        head += chunk
        if not any(m.startswith(head) for m in _MAGICS):
            return head
    return head


async def _read_u32(reader: asyncio.StreamReader) -> int:
    return struct.unpack("<I", await reader.readexactly(4))[0]


async def _read_utf8(reader: asyncio.StreamReader, n: int) -> str:
    """n bytes of UTF-8; bytes that do not decode fail the frame mid-read,
    where the stream cannot be resynchronized."""
    try:
        return (await reader.readexactly(n)).decode("utf-8")
    except UnicodeDecodeError as e:
        raise ProtocolError(f"malformed frame: text is not UTF-8 ({e.reason})") from None


async def _read_texts(reader: asyncio.StreamReader) -> list[str]:
    count = await _read_u32(reader)
    _check(count <= MAX_ITEMS, f"count {count}")
    texts, total = [], 0
    for _ in range(count):
        ln = await _read_u32(reader)
        _check(ln <= MAX_TEXT_BYTES, f"text length {ln}")
        total += ln
        _check(total <= MAX_REQUEST_BYTES, f"request payload {total}")
        texts.append(await _read_utf8(reader, ln))
    return texts


async def _read_query_texts(reader: asyncio.StreamReader) -> tuple[int, str, list[str]]:
    """The rerank layout: u32 top_n | u32 len | query | texts."""
    top_n = await _read_u32(reader)
    _check(top_n <= MAX_ITEMS, f"top_n {top_n}")
    qlen = await _read_u32(reader)
    _check(0 < qlen <= MAX_TEXT_BYTES, f"query length {qlen}")
    query = await _read_utf8(reader, qlen)
    return top_n, query, await _read_texts(reader)


async def _read_ids(reader: asyncio.StreamReader) -> list[list[int]]:
    """The eval layout: u32 n | n * (u32 k | k * i32)."""
    count = await _read_u32(reader)
    _check(count <= MAX_ITEMS, f"count {count}")
    id_lists, total = [], 0
    for _ in range(count):
        k = await _read_u32(reader)
        _check(k <= MAX_IDS, f"id count {k}")
        total += k
        _check(total <= MAX_REQUEST_IDS, f"request ids {total}")
        id_lists.append(np.frombuffer(await reader.readexactly(4 * k), np.int32).tolist())
    return id_lists


def _ranked_reply(writer: asyncio.StreamWriter, ranked: list[dict]) -> None:
    """`u32 m | m * i32 index | m * f32 score`."""
    writer.write(struct.pack("<I", len(ranked)))
    writer.write(np.asarray([r["index"] for r in ranked], np.int32).tobytes())
    writer.write(np.asarray([r["relevance_score"] for r in ranked], np.float32).tobytes())


def _quantize_i8(vecs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-vector symmetric int8 for the wire: (codes, scales), vec ~=
    codes * scale."""
    amax = np.max(np.abs(vecs), axis=-1)
    scale = (amax / 127.0).astype(np.float32)
    q = np.round(vecs / np.maximum(scale, 1e-20)[:, None]).astype(np.int8)
    return q, scale


def _error_frame(writer: asyncio.StreamWriter, e: Exception) -> None:
    msg = f"{type(e).__name__}: {e}".encode("utf-8")[:4096]
    writer.write(struct.pack("<I", 0xFFFFFFFF) + struct.pack("<I", len(msg)) + msg)


def _json_frame(writer: asyncio.StreamWriter, obj: dict) -> None:
    payload = json.dumps(obj).encode("utf-8")
    writer.write(struct.pack("<I", len(payload)) + payload)


async def _serve_frame(head: bytes, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter, batcher: ContinuousBatcher,
                       n_embd: int) -> None:
    """Read one framed request (`head` is its magic) and write its reply.
    A failure after the request was read raises, for the error frame;
    a ProtocolError means the stream cannot be read further."""
    engine = batcher.engine
    loop = asyncio.get_running_loop()
    if head in (MAGIC, MAGIC_ENCODE_I8):
        texts = await _read_texts(reader)
        vecs = np.asarray(await batcher.encode(texts), np.float32)
        writer.write(struct.pack("<I", len(vecs)))
        if head == MAGIC_ENCODE_I8:
            q, scale = _quantize_i8(vecs)
            writer.write(scale.tobytes() + q.tobytes())
        else:
            writer.write(np.ascontiguousarray(vecs).tobytes())
    elif head == MAGIC_STATS:
        snap = metrics.snapshot()
        snap["server"] = batcher.stats.as_dict()
        _json_frame(writer, snap)
    elif head == MAGIC_HEALTH:
        writer.write(struct.pack("<I", 2) + b"ok")
    elif head == MAGIC_META:
        _json_frame(writer, {"n_embd": n_embd, "n_max_tokens": engine.n_max_tokens,
                             "name": engine.config.name})
    elif head == MAGIC_VOCAB:
        tok = engine.id_to_token(await _read_u32(reader)).encode("utf-8")
        writer.write(struct.pack("<I", len(tok)) + tok)
    elif head == MAGIC_TOKENIZE:
        texts = await _read_texts(reader)
        id_lists = await loop.run_in_executor(None, engine.tokenize_batch, texts)
        writer.write(struct.pack("<I", len(id_lists)))
        for ids in id_lists:
            writer.write(struct.pack("<I", len(ids)) + np.asarray(ids, np.int32).tobytes())
    elif head == MAGIC_EVAL:
        id_lists = await _read_ids(reader)
        vecs = await loop.run_in_executor(None, engine.embed_tokens, id_lists)
        writer.write(struct.pack("<I", len(vecs)))
        writer.write(np.ascontiguousarray(vecs, np.float32).tobytes())
    elif head in (MAGIC_RERANK, MAGIC_MAXSIM):
        top_n, query, docs = await _read_query_texts(reader)
        if not docs:
            raise ValueError("no documents")
        rank = engine.rerank if head == MAGIC_RERANK else engine.maxsim_rerank
        ranked = await batcher.admitted(len(docs), lambda: rank(query, docs,
                                                                 top_n=top_n or None))
        _ranked_reply(writer, ranked)
    elif head == MAGIC_SPARSE:
        k = await _read_u32(reader)
        _check(0 < k <= MAX_SPARSE_K, f"sparse k {k}")
        texts = await _read_texts(reader)
        pairs = await batcher.admitted(len(texts), lambda: engine.encode_sparse(texts, k=k))
        writer.write(struct.pack("<I", len(pairs)))
        for idx, val in pairs:
            writer.write(struct.pack("<I", len(idx)) + np.ascontiguousarray(idx, np.int32).tobytes()
                         + np.ascontiguousarray(val, np.float32).tobytes())
    elif head in _INDEX_FRAMES:
        texts = await _read_texts(reader)
        fn = getattr(batcher, _INDEX_FRAMES[head])
        total = await batcher.admitted(len(texts), lambda: fn(texts))
        writer.write(struct.pack("<I", total))
    else:
        k = await _read_u32(reader)
        _check(0 < k <= MAX_TOPK, f"top-k {k}")
        texts = await _read_texts(reader)
        fn = getattr(batcher, _SEARCH_FRAMES[head])
        idx, scores = await batcher.admitted(len(texts), lambda: fn(texts, k))
        writer.write(struct.pack("<II", *idx.shape))
        writer.write(np.ascontiguousarray(idx, np.int32).tobytes())
        writer.write(np.ascontiguousarray(scores, np.float32).tobytes())


async def handle_client(reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                        batcher: ContinuousBatcher, n_embd: int) -> None:
    batcher.stats.connections += 1
    try:
        writer.write(struct.pack("<i", n_embd))  # handshake
        await writer.drain()
        while True:
            head = await _read_head(reader)
            if not head:
                break
            t_req = time.perf_counter()
            if head in _MAGICS:
                try:
                    await _serve_frame(head, reader, writer, batcher, n_embd)
                except (ProtocolError, asyncio.IncompleteReadError, ConnectionError):
                    raise
                except Exception as e:  # request-level failure, connection stays
                    batcher.stats.errors += 1
                    _error_frame(writer, e)
            elif head.startswith(b"\x01"):
                # a control byte never starts ggml-compat text: an unknown frame
                raise ProtocolError(f"unknown frame magic {head!r}")
            else:
                # raw mode: one read == one message; the unframed protocol has
                # no error representation, so a failure drops the connection
                rest = await reader.read(RAW_CHUNK - len(head))
                text = (head + rest).decode("utf-8", errors="replace")
                try:
                    vecs = await batcher.encode([text])
                except Exception as e:
                    batcher.stats.errors += 1
                    print(f"raw-mode request failed: {e!r}", file=sys.stderr)
                    break
                writer.write(np.ascontiguousarray(vecs[0], np.float32).tobytes())
            batcher.stats.requests += 1
            batcher.stats.record_latency(time.perf_counter() - t_req)
            await writer.drain()
    except ProtocolError as e:
        # the stream is desynchronized: report once, then drop the connection
        batcher.stats.errors += 1
        _error_frame(writer, e)
        try:
            await writer.drain()
        except ConnectionError:
            pass
    except (asyncio.IncompleteReadError, ConnectionError):
        pass
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except ConnectionError:
            pass


async def serve(engine, host: str = "0.0.0.0", port: int = 8080,
                max_batch: int = 256, window_ms: float = 2.0,
                max_pending: int = 16384, http_port: int | None = None,
                extra_engines: dict | None = None, model_name: str | None = None) -> None:
    """Serve TCP on `port` and, with `http_port`, the HTTP/JSON surface
    (`runtime/http_server.py`) over the same batcher, so requests of both
    merge into shared device batches.  `extra_engines` ({name: Engine})
    serves more models over HTTP, each with its own batcher, routed by a
    request's "model" field; TCP always speaks to `engine`.  `model_name`
    is the name `engine` is served under (default: its config's name)."""
    batcher = ContinuousBatcher(engine, max_batch, window_ms, max_pending=max_pending)
    await batcher.start()
    registry: dict = {}
    for name, eng in (extra_engines or {}).items():
        registry[name] = ContinuousBatcher(eng, max_batch, window_ms, max_pending=max_pending)
        await registry[name].start()
    servers = [await asyncio.start_server(
        lambda r, w: handle_client(r, w, batcher, engine.n_embd), host, port
    )]
    if http_port is not None:
        from .http_server import handle_http, served_name

        name = model_name or served_name(engine)
        servers.append(await asyncio.start_server(
            lambda r, w: handle_http(r, w, batcher, name, registry=registry), host, http_port
        ))
        print(f"http server listening on {host}:{http_port} (POST /v1/embeddings)",
              file=sys.stderr)
    print(f"server listening on {host}:{port} (n_embd={engine.n_embd})",
          file=sys.stderr)
    try:
        async with contextlib.AsyncExitStack() as stack:
            for srv in servers:
                await stack.enter_async_context(srv)
            await asyncio.gather(*(srv.serve_forever() for srv in servers))
    finally:
        await batcher.stop()
        for b in registry.values():
            await b.stop()


def _mesh_from_args(p, args):
    """The serving mesh of --dp / --tp (None for one device): over this
    process's cards (`distributed.local_devices`: on a multi-process run,
    its own share of them), or slots on the one --device named."""
    from ..parallel import distributed as dist
    from ..parallel.mesh import make_mesh

    procs = dist.process_count()
    if not (args.dp or args.tp > 1 or procs > 1):
        return None
    if args.device is not None:
        # slots on the one device named, as many as the mesh asks
        local = ((args.dp or procs) // procs or 1) * args.tp
        devices = [args.device] * local
    else:
        devices = dist.local_devices()
    n_dev = len(devices) * procs
    if args.tp > n_dev:
        p.error(f"--tp {args.tp} exceeds the {n_dev} available device(s)")
    dp = args.dp or (n_dev // args.tp)
    if dp < 1 or dp * args.tp > n_dev:
        p.error(f"mesh dp={dp} x tp={args.tp} needs {dp * args.tp} "
                f"devices, have {n_dev}")
    return make_mesh(dp=dp, tp=args.tp, devices=devices[: dp // procs * args.tp])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-m", "--model", required=True, action="append",
                   help="GGUF path, or NAME=PATH; repeat to serve several models (the "
                        "first is the default and the only one on TCP; HTTP requests "
                        "route by their 'model' field)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the "
                        "plain PyTorch versions of the kernels); with --dp / --tp "
                        "every mesh slot on it")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--output-dtype", choices=["float32", "float16", "bfloat16", "int8"],
                   default="int8",
                   help="embedding transfer encoding off the device (replies stay f32)")
    p.add_argument("--packing", choices=["auto", "always", "never"], default="auto",
                   help="pack short sentences many to a row (auto), every text "
                        "that fits a row (always) or none (never)")
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("--window-ms", type=float, default=2.0)
    p.add_argument("--max-pending", type=int, default=16384)
    p.add_argument("--http-port", type=int, default=None,
                   help="also serve HTTP/JSON (OpenAI-compatible POST /v1/embeddings "
                        "and the other /v1 routes) on this port, over the same batcher")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel mesh size (0 = single device)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh size (Megatron sharding)")
    from ..parallel import distributed as dist

    dist.add_args(p)
    args = p.parse_args(argv)
    specs = []
    for item in args.model:
        name, sep, path = item.partition("=")
        specs.append((name, path) if sep else (None, item))
    if len(specs) > 1 and args.http_port is None:
        p.error("serving several models requires --http-port "
                "(extra models are HTTP-routed by their 'model' field)")
    if args.coordinator is not None and len(specs) > 1:
        p.error("multi-model serving is single-process only")
    # multi-process: join the process group before any device work
    multiprocess = dist.init_from_args(
        args, devices=None if args.device is None else [args.device])
    mesh = _mesh_from_args(p, args)

    from ..models.bert import ComputeOptions
    from .engine import Engine

    def load(path, mesh=None):
        engine = Engine.from_gguf(
            path, device=args.device, packing=args.packing, mesh=mesh,
            opts=ComputeOptions(dtype=args.dtype, output_dtype=args.output_dtype),
        )
        engine.warmup()  # the kernels' build and the first forward, before listening
        return engine

    engine = load(specs[0][1], mesh)  # every process warms identically (lockstep)
    extra = {}
    for name, path in specs[1:]:
        eng = load(path)
        extra[name or eng.config.name or path] = eng
    if multiprocess:
        try:
            if dist.process_index() == 0:
                # the leader owns the sockets and broadcasts every device
                # dispatch first; SIGTERM unwinds (it does not kill), so the
                # finally releases the followers from their broadcast
                import signal

                def _terminate(signum, frame):
                    raise SystemExit(0)

                signal.signal(signal.SIGTERM, _terminate)
                dist.make_leader(engine)
                try:
                    asyncio.run(serve(engine, args.host, args.port, args.max_batch,
                                      args.window_ms, max_pending=args.max_pending,
                                      http_port=args.http_port))
                finally:
                    dist.broadcast_stop()
            else:
                print(f"follower process {dist.process_index()} of "
                      f"{dist.process_count()} ready", file=sys.stderr, flush=True)
                dist.follower_loop(engine)
        finally:
            dist.shutdown()
        return
    asyncio.run(serve(engine, args.host, args.port, args.max_batch,
                      args.window_ms, max_pending=args.max_pending,
                      http_port=args.http_port, extra_engines=extra,
                      model_name=specs[0][0]))


if __name__ == "__main__":
    # run the package's module, not this `__main__` copy of it: the HTTP
    # surface imports OverloadedError from `runtime.server`, and a second
    # class of that name would turn its 429s into 500s
    from embedding_cpp_tpu_torch.runtime.server import main as _main

    _main()
