"""HTTP/1.1 JSON surface over the continuous batcher: the OpenAI-style
`POST /v1/embeddings` and the other routes of the JAX package's
`runtime/http_server.py`, with the same payloads, status codes and error
texts.  A small asyncio server with no dependency beyond the standard
library; it shares the TCP server's batcher, so requests of both merge
into the same device batches.

    POST /v1/embeddings   {"input": "text" | ["texts"...],
                           "encoding_format": "float" (default) | "base64",
                           "dimensions": N (keep the first N components,
                           normalized again),
                           "prompt_name": name | "prompt": "prefix " (absent:
                           the model's default prompt),
                           "truncate": true (default; false: 400 on an input
                           past the context)}
      -> {"object": "list", "data": [{"object": "embedding", "index": i,
          "embedding": [...] | "<base64 of the f32 bytes>"}], "model": ...,
          "usage": {"prompt_tokens": n, "total_tokens": n}}
    POST /v1/tokenize     {"input": ...} -> {"ids": [[...]], "tokens": [[...]]}
    POST /v1/token_embeddings {"input": ...}
      -> {"data": [{"index": i, "embeddings": [[...] per token]}]}
    POST /v1/index        {"input": [...]} -> {"total": N} (the vector index,
                          documents take the model's document prompt)
    POST /v1/search       {"input": [...], "k": 10}
      -> {"results": [[{"index": id, "score": s}, ...], ...]}
    POST /v1/rerank       {"query": "...", "documents": [...], "top_n": N,
                           "return_documents": false}
      -> {"results": [{"index": i, "relevance_score": s}, ...]} (a model
                          with a one-logit classification head)
    POST /v1/maxsim       the rerank payload and reply, late-interaction
                          MaxSim over token states (any model)
    POST /v1/maxsim_index, /v1/maxsim_search ({"candidates": C} optional)
    POST /v1/sparse_embeddings {"input": ..., "k": 256, "return_tokens": false}
      -> {"data": [{"index": i, "indices": [...], "values": [...]}]} (an
                          MLM-head model: SPLADE)
    POST /v1/sparse_index, /v1/sparse_search ({"candidates": C} optional)
    POST /v1/hybrid_index (the dense and the sparse index at once),
         /v1/hybrid_search (the two rankings fused by reciprocal rank)
    GET  /healthz -> "ok";  GET /metrics -> the TPES snapshot;
    GET  /v1/models -> the models served

A request's "model" field routes it to that model's batcher; a name that
is not served is a 404.  A search past the corpus drops its id -1 slots,
so a row may hold fewer than k results.

    python -m embedding_cpp_tpu_torch.runtime.http_server -m m.gguf --port 8081
or beside the TCP server: `runtime.server -m m.gguf --http-port 8081`.
"""
from __future__ import annotations

import argparse
import asyncio
import base64
import json
import sys
import time

import numpy as np

from ..utils import jsonfmt
from .engine import truncate_normalize
# the TCP server's caps, shared so that the two surfaces cannot drift apart
from .server import MAX_ITEMS, MAX_REQUEST_BYTES, MAX_TOPK, ContinuousBatcher, OverloadedError

MAX_HEADER = 64 << 10  # request head bytes


def served_name(engine) -> str:
    return getattr(getattr(engine, "config", None), "name", "") or "embedding-model"


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


_STATUS_TEXT = {200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
                413: "Payload Too Large", 429: "Too Many Requests",
                500: "Internal Server Error"}


def _response(status: int, body: bytes, content_type: str = "application/json",
              keep_alive: bool = True) -> bytes:
    head = (f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'OK')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n"
            "\r\n")
    return head.encode("ascii") + body


def _json_response(status: int, obj) -> bytes:
    return _response(status, json.dumps(obj).encode("utf-8"))


def _error_response(status: int, message: str, keep_alive: bool = True) -> bytes:
    kind = "invalid_request_error" if status < 500 else "server_error"
    return _response(status, json.dumps({"error": {"message": message, "type": kind}})
                     .encode("utf-8"), keep_alive=keep_alive)


async def _read_request(reader: asyncio.StreamReader):
    """-> (method, path, headers, body), or None at a clean end of stream."""
    try:
        request_line = await reader.readline()
    except (asyncio.LimitOverrunError, ValueError):
        raise HttpError(400, "request line too long")
    if not request_line:
        return None
    parts = request_line.decode("latin-1").strip().split()
    if len(parts) != 3:
        raise HttpError(400, "malformed request line")
    method, path, _version = parts
    headers: dict[str, str] = {}
    total = 0
    while True:
        try:
            line = await reader.readline()
        except (asyncio.LimitOverrunError, ValueError):
            raise HttpError(400, "header line too long")
        total += len(line)
        if total > MAX_HEADER:
            raise HttpError(400, "headers too large")
        if line in (b"\r\n", b"\n", b""):
            break
        if b":" in line:
            k, _, v = line.decode("latin-1").partition(":")
            k = k.strip().lower()
            if k == "content-length" and k in headers:
                # two lengths: a proxy reading the first and this server the
                # last would split requests differently (request smuggling)
                raise HttpError(400, "duplicate content-length header")
            headers[k] = v.strip()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        raise HttpError(400, "chunked transfer encoding not supported")
    try:
        length = int(headers.get("content-length", "0") or "0")
    except ValueError:
        raise HttpError(400, "malformed content-length")
    if length < 0:
        raise HttpError(400, "malformed content-length")
    if length > MAX_REQUEST_BYTES:
        raise HttpError(413, f"body too large ({length} bytes)")
    body = await reader.readexactly(length) if length else b""
    return method, path, headers, body


def _payload(body: bytes) -> dict:
    try:
        payload = json.loads(body or b"{}")
    except json.JSONDecodeError as e:
        raise HttpError(400, f"invalid JSON: {e}")
    if not isinstance(payload, dict):
        raise HttpError(400, "body must be a JSON object")
    return payload


def _parse_embed_request(body: bytes) -> tuple[list[str], str, dict]:
    """-> (texts, encoding_format, payload), under the TCP frames' item
    cap."""
    payload = _payload(body)
    texts = payload.get("input")
    if isinstance(texts, str):
        texts = [texts]
    if not isinstance(texts, list) or not texts or not all(isinstance(t, str) for t in texts):
        raise HttpError(400, "'input' must be a string or list of strings")
    if len(texts) > MAX_ITEMS:
        raise HttpError(413, f"too many inputs ({len(texts)} > {MAX_ITEMS})")
    fmt = payload.get("encoding_format", "float")
    if fmt not in ("float", "base64"):
        raise HttpError(400, "encoding_format must be 'float' or 'base64'")
    return texts, fmt, payload


def _parse_dimensions(payload: dict, n_embd: int) -> int | None:
    dims = payload.get("dimensions")
    if dims is None:
        return None
    if not isinstance(dims, int) or isinstance(dims, bool) or not 1 <= dims <= n_embd:
        raise HttpError(400, f"dimensions must be an integer in 1..{n_embd}")
    return dims


def _parse_rerank_request(body: bytes) -> tuple[str, list[str], int | None, dict]:
    """/v1/rerank's and /v1/maxsim's payload -> (query, documents, top_n,
    payload)."""
    payload = _payload(body)
    query, docs = payload.get("query"), payload.get("documents")
    if not isinstance(query, str) or not query:
        raise HttpError(400, "'query' must be a string")
    if not isinstance(docs, list) or not docs or not all(isinstance(d, str) for d in docs):
        raise HttpError(400, "'documents' must be a list of strings")
    if len(docs) > MAX_ITEMS:
        raise HttpError(413, f"too many documents ({len(docs)} > {MAX_ITEMS})")
    top_n = payload.get("top_n")
    if top_n is not None and (not isinstance(top_n, int) or isinstance(top_n, bool)
                              or top_n < 1):
        raise HttpError(400, "top_n must be a positive integer")
    return query, docs, top_n, payload


def _parse_k(payload: dict, default: int = 10, cap: int = MAX_TOPK) -> int:
    k = payload.get("k", default)
    if not isinstance(k, int) or isinstance(k, bool) or not 0 < k <= cap:
        raise HttpError(400, f"k must be an integer in 1..{cap}")
    return k


def _parse_candidates(payload: dict) -> int | None:
    cand = payload.get("candidates")
    if cand is not None and (isinstance(cand, bool) or not isinstance(cand, int) or cand < 1):
        raise HttpError(400, "candidates must be a positive int")
    return cand


def _no_field(payload: dict, field: str, path: str) -> None:
    if field in payload:
        raise HttpError(400, f"{field} is not supported on {path}")


def _results(idx, scores) -> list:
    """Search rows as [{"index", "score"}], the id -1 slots (past the
    corpus; their -inf is no JSON number) left out."""
    return [[{"index": int(i), "score": float(sc)} for i, sc in zip(row_i, row_s) if i >= 0]
            for row_i, row_s in zip(idx, scores)]


class _Request:
    """One request's routing: `pick` resolves the "model" field to a
    batcher, which then counts the request's errors and latency."""

    def __init__(self, batcher, model_name: str, registry: dict):
        self.batcher, self.model_name, self.registry = batcher, model_name, registry
        self.used = batcher

    def pick(self, payload: dict) -> tuple:
        """-> (batcher, model name).  A name not served is a 404 even with
        one model: serving the default instead would hand a client
        embeddings of another model."""
        want = payload.get("model")
        if want is None or want == self.model_name:
            b, name = self.batcher, self.model_name
        elif want in self.registry:
            b, name = self.registry[want], want
        else:
            known = ", ".join(sorted({self.model_name, *self.registry}))
            raise HttpError(404, f"unknown model {want!r} (serving: {known})")
        self.used = b
        return b, name


async def _admitted(b, n: int, fn, client_errors: tuple = ()):
    """`b.admitted(n, fn)`: over the pending budget is a 429, and an
    exception of `client_errors` from `fn` a 400."""
    try:
        return await b.admitted(n, fn)
    except OverloadedError as e:  # before client_errors: it is a RuntimeError
        raise HttpError(429, str(e))
    except client_errors as e:
        raise HttpError(400, str(e))


def _needs_mlm_head(b, name: str, what: str) -> None:
    if not b.engine.config.mlm_head:
        raise HttpError(400, f"model {name!r} has no MLM head ({what})")


_SPLADE = "not a SPLADE sparse encoder"


async def _tokenize(req: _Request, body: bytes) -> bytes:
    texts, _, payload = _parse_embed_request(body)
    b, _ = req.pick(payload)
    id_lists = await _admitted(b, len(texts), lambda: b.engine.tokenize_batch(texts))
    return _json_response(200, {
        "object": "tokenize",
        "ids": [[int(i) for i in ids] for ids in id_lists],
        "tokens": [[b.engine.id_to_token(int(i)) for i in ids] for ids in id_lists],
    })


async def _token_embeddings(req: _Request, body: bytes) -> bytes:
    texts, _, payload = _parse_embed_request(body)
    _no_field(payload, "dimensions", "/v1/token_embeddings")
    b, name = req.pick(payload)
    states = await _admitted(b, len(texts), lambda: b.engine.encode_token_states(texts))
    return _json_response(200, {
        "object": "token_embeddings",
        "data": [{"index": i, "object": "token_embedding", "embeddings": s.tolist()}
                 for i, s in enumerate(states)],
        "model": name,
    })


async def _sparse_embeddings(req: _Request, body: bytes) -> bytes:
    texts, _, payload = _parse_embed_request(body)
    _no_field(payload, "dimensions", "/v1/sparse_embeddings")
    k = _parse_k(payload, default=256, cap=4096)
    want_tokens = payload.get("return_tokens", False)
    if not isinstance(want_tokens, bool):
        raise HttpError(400, "return_tokens must be boolean")
    b, name = req.pick(payload)
    _needs_mlm_head(b, name, _SPLADE)
    pairs = await _admitted(b, len(texts), lambda: b.engine.encode_sparse(texts, k=k))
    data = []
    for i, (idx, val) in enumerate(pairs):
        row = {"object": "sparse_embedding", "index": i, "indices": [int(j) for j in idx],
               "values": [float(v) for v in val]}
        if want_tokens:
            row["tokens"] = [b.engine.id_to_token(int(j)) for j in idx]
        data.append(row)
    return _json_response(200, {"object": "list", "data": data, "model": name})


def _index_route(kind: str, method: str, *, mlm: str | None = None, no_dims: str = "",
                 client_errors: tuple = (RuntimeError,)):
    """POST {"input": texts} -> {"object": kind, "total": N} through the
    batcher's `method`; `no_dims` (the route's path) refuses "dimensions"."""
    async def route(req: _Request, body: bytes) -> bytes:
        texts, _, payload = _parse_embed_request(body)
        if no_dims:  # the index keeps whole vectors: cut ones would skew searches
            _no_field(payload, "dimensions", no_dims)
        b, name = req.pick(payload)
        if mlm:
            _needs_mlm_head(b, name, mlm)
        fn = getattr(b, method)
        total = await _admitted(b, len(texts), lambda: fn(texts), client_errors)
        return _json_response(200, {"object": kind, "total": total})
    return route


def _search_route(kind: str, method: str, *, index: str | None = None,
                  missing: str = "", candidates: bool = False, no_dims: str = "",
                  client_errors: tuple = ()):
    """POST {"input": queries, "k": 10} -> {"object": kind, "results"}
    through the batcher's `method`; a 400 first while the batcher's
    `index` is empty."""
    async def route(req: _Request, body: bytes) -> bytes:
        texts, _, payload = _parse_embed_request(body)
        if no_dims:
            _no_field(payload, "dimensions", no_dims)
        k = _parse_k(payload)
        b, _ = req.pick(payload)
        if index and (getattr(b, index) is None or len(getattr(b, index)) == 0):
            raise HttpError(400, missing)
        args = (texts, k, _parse_candidates(payload)) if candidates else (texts, k)
        fn = getattr(b, method)
        idx, scores = await _admitted(b, len(texts), lambda: fn(*args), client_errors)
        return _json_response(200, {"object": kind, "results": _results(idx, scores)})
    return route


def _rank_route(kind: str):
    """/v1/rerank (a one-logit cross-encoder) and /v1/maxsim (any model):
    {"query", "documents", "top_n"} -> ranked results."""
    async def route(req: _Request, body: bytes) -> bytes:
        query, docs, top_n, payload = _parse_rerank_request(body)
        b, name = req.pick(payload)
        if kind == "rerank":
            n_labels = b.engine.config.n_labels
            if n_labels == 0:
                raise HttpError(400, f"model {name!r} has no classification head "
                                     "(embedding model); /v1/rerank needs a reranker")
            if n_labels != 1:
                raise HttpError(400, f"model {name!r} has a {n_labels}-label head; "
                                     "/v1/rerank needs a single-label reranker")
            rank = b.engine.rerank
        else:
            rank = b.engine.maxsim_rerank
        ranked = await _admitted(b, len(docs), lambda: rank(query, docs, top_n=top_n))
        if payload.get("return_documents"):
            for r in ranked:
                r["document"] = {"text": docs[r["index"]]}
        return _json_response(200, {"object": kind, "model": name, "results": ranked})
    return route


async def _embeddings(req: _Request, body: bytes) -> bytes:
    texts, fmt, payload = _parse_embed_request(body)
    b, name = req.pick(payload)
    dims = _parse_dimensions(payload, b.engine.n_embd)
    try:
        prefix = b.engine.resolve_prompt(payload.get("prompt_name"), payload.get("prompt"))
    except ValueError as e:
        raise HttpError(400, str(e))
    truncate = payload.get("truncate", True)
    if not isinstance(truncate, bool):
        raise HttpError(400, "truncate must be a boolean")
    try:
        vecs, counts = await b.encode_with_counts(texts, prefix, truncate)
    except ValueError as e:  # truncate=false and an input past the context
        raise HttpError(400, str(e))
    except OverloadedError as e:
        raise HttpError(429, str(e))
    vecs = np.ascontiguousarray(vecs, np.float32)
    if dims is not None:
        vecs = truncate_normalize(vecs, dims)
    if fmt == "base64":
        data_json = json.dumps(
            [{"object": "embedding", "index": i,
              "embedding": base64.b64encode(v.tobytes()).decode("ascii")}
             for i, v in enumerate(vecs)], separators=(",", ":")).encode("utf-8")
    elif len(vecs) >= 64:  # a big batch renders off the event loop
        data_json = await asyncio.get_running_loop().run_in_executor(
            None, jsonfmt.embedding_data_json, vecs)
    else:
        data_json = jsonfmt.embedding_data_json(vecs)
    n_tokens = int(sum(counts))  # from the tokenization that fed the forward
    return _response(200, (
        b'{"object":"list","data":' + data_json
        + b',"model":' + json.dumps(name).encode("utf-8")
        + b',"usage":{"prompt_tokens":%d,"total_tokens":%d}}' % (n_tokens, n_tokens)))


_POST_ROUTES = {
    "/v1/embeddings": _embeddings,
    "/v1/tokenize": _tokenize,
    "/v1/token_embeddings": _token_embeddings,
    "/v1/sparse_embeddings": _sparse_embeddings,
    "/v1/index": _index_route("index", "index_texts", no_dims="/v1/index",
                              client_errors=()),
    "/v1/search": _search_route("search", "search_texts", index="index",
                                missing="no index built (POST /v1/index first)",
                                no_dims="/v1/search"),
    "/v1/sparse_index": _index_route("sparse_index", "sparse_index_texts", mlm=_SPLADE),
    "/v1/sparse_search": _search_route(
        "sparse_search", "sparse_search_texts", index="sparse_index", candidates=True,
        missing="no sparse index built (POST /v1/sparse_index first)"),
    "/v1/hybrid_index": _index_route("hybrid_index", "hybrid_index_texts",
                                     mlm="hybrid search needs a SPLADE sparse encoder"),
    "/v1/hybrid_search": _search_route("hybrid_search", "hybrid_search_texts",
                                       client_errors=(RuntimeError,)),
    "/v1/maxsim_index": _index_route("maxsim_index", "maxsim_index_texts"),
    "/v1/maxsim_search": _search_route(
        "maxsim_search", "maxsim_search_texts", index="maxsim_index", candidates=True,
        missing="no MaxSim index built (POST /v1/maxsim_index first)"),
    "/v1/maxsim": _rank_route("maxsim"),
    "/v1/rerank": _rank_route("rerank"),
}


def _metrics(req: _Request) -> bytes:
    from ..utils.metrics import GLOBAL as metrics

    snap = metrics.snapshot()
    snap["server"] = req.batcher.stats.as_dict()
    if req.registry:
        snap["models"] = {name: b.stats.as_dict() for name, b in req.registry.items()}
    return _json_response(200, snap)


async def _route(req: _Request, method: str, path: str, body: bytes) -> bytes:
    if path == "/healthz":
        return _response(200, b"ok", "text/plain")
    if path == "/metrics":
        return _metrics(req)
    if path == "/v1/models":
        names = sorted({req.model_name, *req.registry})
        return _json_response(200, {"object": "list",
                                    "data": [{"id": n, "object": "model"} for n in names]})
    route = _POST_ROUTES.get(path)
    if route is None:
        raise HttpError(404, f"no route for {path}")
    if method != "POST":
        raise HttpError(405, "POST required")
    out = await route(req, body)
    req.used.stats.requests += 1
    return out


async def handle_http(reader: asyncio.StreamReader, writer: asyncio.StreamWriter, batcher,
                      model_name: str, registry: dict | None = None) -> None:
    """Serve one connection's requests until it closes.  `registry` maps
    more model names to their batchers (`pick`)."""
    registry = registry or {}
    batcher.stats.connections += 1
    try:
        while True:
            try:
                request = await _read_request(reader)
            except HttpError as e:  # the stream cannot be read on: close it
                writer.write(_error_response(e.status, str(e), keep_alive=False))
                await writer.drain()
                break
            except (asyncio.IncompleteReadError, ConnectionResetError):
                break
            if request is None:
                break
            method, path, headers, body = request
            t_req = time.perf_counter()
            req = _Request(batcher, model_name, registry)
            try:
                out = await _route(req, method, path, body)
            except HttpError as e:
                out = _error_response(e.status, str(e))
                if e.status >= 500:
                    req.used.stats.errors += 1
            except Exception as e:  # an engine failure: a 500, the connection lives
                req.used.stats.errors += 1
                out = _error_response(500, f"{type(e).__name__}: {e}")
            client_done = headers.get("connection", "").lower() == "close"
            if client_done:  # the Connection header comes before the body
                out = out.replace(b"keep-alive", b"close", 1)
            req.used.stats.record_latency(time.perf_counter() - t_req)
            try:
                writer.write(out)
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                break  # the client left mid-response
            if client_done:
                break
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except Exception:
            pass


async def serve_http(engine, host: str = "0.0.0.0", port: int = 8081, batcher=None,
                     max_batch: int = 256, window_ms: float = 2.0) -> None:
    """Serve HTTP alone; pass a batcher to share it with a TCP server
    (`runtime.server --http-port` does that)."""
    own_batcher = batcher is None
    if own_batcher:
        batcher = ContinuousBatcher(engine, max_batch, window_ms)
        await batcher.start()
    server = await asyncio.start_server(
        lambda r, w: handle_http(r, w, batcher, served_name(engine)), host, port)
    print(f"http server listening on {host}:{port} (POST /v1/embeddings)", file=sys.stderr)
    try:
        async with server:
            await server.serve_forever()
    finally:
        if own_batcher:
            await batcher.stop()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-m", "--model", required=True, help="GGUF model path")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8081)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the plain PyTorch "
                        "versions of the kernels)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--output-dtype", choices=["float32", "float16", "bfloat16", "int8"],
                   default="int8",
                   help="embedding transfer encoding off the device (replies stay f32)")
    p.add_argument("--packing", choices=["auto", "always", "never"], default="auto")
    args = p.parse_args(argv)

    from ..models.bert import ComputeOptions
    from .engine import Engine

    engine = Engine.from_gguf(
        args.model, device=args.device, packing=args.packing,
        opts=ComputeOptions(dtype=args.dtype, output_dtype=args.output_dtype))
    engine.warmup()
    asyncio.run(serve_http(engine, args.host, args.port))


if __name__ == "__main__":
    # the package's module, not this `__main__` copy: exception classes must
    # be the ones `runtime.server` raises
    from embedding_cpp_tpu_torch.runtime.http_server import main as _main

    _main()
