"""The port's HTTP surface (`runtime/http_server.py`) on CPU engines.

A port server and a JAX server serve the same tiny f32 GGUFs (the default
model `tiny-test`, a one-logit cross-encoder as "reranker" and a SPLADE
model as "splade"), TCP and HTTP each.  Held against the JAX server:
/v1/embeddings (float and base64, `dimensions`, a literal prompt,
`truncate`), /v1/tokenize, /v1/rerank, /v1/index + /v1/search and every
error status and message (f32 values within 2e-5, rankings equal).  The
other routes are held against the port's own Engine and index calls.
Also: /healthz, /metrics, /v1/models, routing by "model" and its 404, one
batcher behind TCP and HTTP, 429 under the pending cap, hostile headers,
keep-alive and `Connection: close`, `serve_http` alone, and the server
CLI's multi-model rule."""
import base64
import contextlib
import http.client
import json
import socket

import numpy as np
import pytest
from torch_native import free_port, jax_native, serving

from embedding_cpp_tpu_torch import Engine
from embedding_cpp_tpu_torch.models import ComputeOptions

ATOL = 2e-5
CORPUS = [f"document {i} about the {w} fox and a lazy dog" for i, w in
          enumerate(("quick", "brown", "red", "slow", "small", "big", "old", "new"))]
TEXTS = ["hello world", "the quick brown fox jumps over the lazy dog", "a", "Café déjà vu!"]


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    from embedding_cpp_tpu_torch.cli.make_test_model import make_test_model

    root = tmp_path_factory.mktemp("gguf")
    out = {}
    for preset in ("tiny", "tiny-reranker", "tiny-splade"):
        out[preset] = str(root / f"{preset}.gguf")
        make_test_model(out[preset], preset, "f32", seed=0)
    return out


def _port_engine(path: str) -> Engine:
    return Engine.from_gguf(path, device="cpu",
                            opts=ComputeOptions(dtype="float32", output_dtype="float32"))


@pytest.fixture(scope="module")
def engines(ggufs):
    return {name: _port_engine(ggufs[preset]) for name, preset in
            (("default", "tiny"), ("reranker", "tiny-reranker"), ("splade", "tiny-splade"))}


@contextlib.contextmanager
def _port_server(engine, extra=None, **kw):
    from embedding_cpp_tpu_torch.runtime.server import serve

    tcp, http_port = free_port(), free_port()
    with serving(lambda: serve(engine, "127.0.0.1", tcp, http_port=http_port,
                               extra_engines=extra, **kw), tcp, http_port):
        yield tcp, http_port


@pytest.fixture(scope="module")
def port_server(engines):
    with _port_server(engines["default"], {"reranker": engines["reranker"],
                                           "splade": engines["splade"]}) as ports:
        yield ports


@pytest.fixture(scope="module")
def jax_server(ggufs):
    from embedding_cpp_tpu.models import ComputeOptions as JOptions
    from embedding_cpp_tpu.runtime.engine import Engine as JEngine
    from embedding_cpp_tpu.runtime.server import serve as jserve

    opts = JOptions(dtype="float32", output_dtype="float32")
    with jax_native("tokenizer"):
        default = JEngine.from_gguf(ggufs["tiny"], opts=opts)
        extra = {"reranker": JEngine.from_gguf(ggufs["tiny-reranker"], opts=opts),
                 "splade": JEngine.from_gguf(ggufs["tiny-splade"], opts=opts)}
    tcp, http_port = free_port(), free_port()
    with serving(lambda: jserve(default, "127.0.0.1", tcp, http_port=http_port,
                                extra_engines=extra), tcp, http_port):
        yield tcp, http_port


def _request(port: int, method: str, path: str, body: bytes | None = None,
             headers: dict | None = None) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body, headers or {})
    r = conn.getresponse()
    raw = r.read()
    conn.close()
    return r.status, raw


def _post(port: int, path: str, payload) -> tuple[int, dict]:
    status, raw = _request(port, "POST", path, json.dumps(payload).encode(),
                           {"Content-Type": "application/json"})
    return status, json.loads(raw)


def _get(port: int, path: str) -> tuple[int, bytes]:
    return _request(port, "GET", path)


def _vectors(body: dict) -> np.ndarray:
    rows = [d["embedding"] for d in body["data"]]
    if rows and isinstance(rows[0], str):
        return np.stack([np.frombuffer(base64.b64decode(r), np.float32) for r in rows])
    return np.array(rows, np.float32)


EMBED_REQUESTS = {
    "float": {"input": TEXTS},
    "base64": {"input": TEXTS, "encoding_format": "base64"},
    "single": {"input": "just one text"},
    "dimensions": {"input": TEXTS, "dimensions": 24},
    "prompt": {"input": TEXTS, "prompt": "query: "},
    "prompt_name_off": {"input": TEXTS, "prompt_name": ""},
    "truncate_false": {"input": TEXTS, "truncate": False},
    "truncate_long": {"input": ["word " * 400]},
    "model": {"input": TEXTS[:2], "model": "tiny-test"},
    "reranker": {"input": TEXTS, "model": "reranker", "encoding_format": "base64"},
}


@pytest.mark.parametrize("case", EMBED_REQUESTS)
def test_embeddings_match_jax(port_server, jax_server, case):
    payload = EMBED_REQUESTS[case]
    st, ours = _post(port_server[1], "/v1/embeddings", payload)
    jst, theirs = _post(jax_server[1], "/v1/embeddings", payload)
    assert st == jst == 200
    assert {k: v for k, v in ours.items() if k != "data"} == {
        k: v for k, v in theirs.items() if k != "data"}
    assert [(d["object"], d["index"]) for d in ours["data"]] == [
        (d["object"], d["index"]) for d in theirs["data"]]
    got, want = _vectors(ours), _vectors(theirs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_embeddings_equal_the_engine(port_server, engines):
    """A 70-text float request (rendered off the event loop) and base64,
    each equal to `engine.encode`; `usage` counts the framed tokens."""
    texts = [f"sentence number {i} of the batch" for i in range(70)]
    want = engines["default"].encode(texts)
    st, body = _post(port_server[1], "/v1/embeddings", {"input": texts})
    assert st == 200
    np.testing.assert_allclose(_vectors(body), want, rtol=0, atol=1e-6)
    n_tokens = sum(len(t) for t in engines["default"].tokenize_batch(texts))
    assert body["usage"] == {"prompt_tokens": n_tokens, "total_tokens": n_tokens}
    st, body = _post(port_server[1], "/v1/embeddings",
                     {"input": texts[:5], "encoding_format": "base64"})
    assert np.array_equal(_vectors(body), engines["default"].encode(texts[:5]))


ERROR_REQUESTS = {
    "empty_input": ("POST", "/v1/embeddings", {"input": []}),
    "int_input": ("POST", "/v1/embeddings", {"input": 42}),
    "mixed_input": ("POST", "/v1/embeddings", {"input": ["a", 3]}),
    "not_object": ("POST", "/v1/embeddings", [1, 2]),
    "bad_json": ("POST", "/v1/embeddings", b"{not json"),
    "format": ("POST", "/v1/embeddings", {"input": "a", "encoding_format": "hex"}),
    "dims_zero": ("POST", "/v1/embeddings", {"input": "a", "dimensions": 0}),
    "dims_big": ("POST", "/v1/embeddings", {"input": "a", "dimensions": 65}),
    "dims_bool": ("POST", "/v1/embeddings", {"input": "a", "dimensions": True}),
    "prompt_name": ("POST", "/v1/embeddings", {"input": "a", "prompt_name": "query"}),
    "prompt_type": ("POST", "/v1/embeddings", {"input": "a", "prompt": 5}),
    "truncate_type": ("POST", "/v1/embeddings", {"input": "a", "truncate": "no"}),
    "too_long": ("POST", "/v1/embeddings", {"input": ["a", "word " * 400],
                                            "truncate": False}),
    "unknown_model": ("POST", "/v1/embeddings", {"input": "a", "model": "nope"}),
    "get_on_post": ("GET", "/v1/embeddings", None),
    "no_route": ("GET", "/nope", None),
    "no_route_post": ("POST", "/v1/nope", {"input": "a"}),
    "tokenize_ids": ("POST", "/v1/tokenize", {"input": [[1, 2]]}),
    "rerank_no_head": ("POST", "/v1/rerank", {"query": "q", "documents": ["a"]}),
    "rerank_no_query": ("POST", "/v1/rerank", {"documents": ["a"], "model": "reranker"}),
    "rerank_docs": ("POST", "/v1/rerank", {"query": "q", "documents": [],
                                           "model": "reranker"}),
    "rerank_top_n": ("POST", "/v1/rerank", {"query": "q", "documents": ["a"], "top_n": 0,
                                            "model": "reranker"}),
    "search_k": ("POST", "/v1/search", {"input": ["q"], "k": "ten"}),
    "search_k_big": ("POST", "/v1/search", {"input": ["q"], "k": 99999}),
    "search_dims": ("POST", "/v1/search", {"input": ["q"], "dimensions": 8}),
    "index_dims": ("POST", "/v1/index", {"input": ["q"], "dimensions": 8}),
    "sparse_no_head": ("POST", "/v1/sparse_embeddings", {"input": "a"}),
    "sparse_k": ("POST", "/v1/sparse_embeddings", {"input": "a", "k": 5000,
                                                   "model": "splade"}),
    "sparse_tokens": ("POST", "/v1/sparse_embeddings", {"input": "a", "model": "splade",
                                                        "return_tokens": 1}),
    "token_dims": ("POST", "/v1/token_embeddings", {"input": "a", "dimensions": 8}),
    "sparse_search_empty": ("POST", "/v1/sparse_search", {"input": ["q"], "model": "splade"}),
    "maxsim_search_empty": ("POST", "/v1/maxsim_search", {"input": ["q"]}),
    "hybrid_search_empty": ("POST", "/v1/hybrid_search", {"input": ["q"]}),
    "hybrid_no_head": ("POST", "/v1/hybrid_index", {"input": ["q"]}),
}


@pytest.mark.parametrize("case", ERROR_REQUESTS)
def test_errors_match_jax(port_server, jax_server, case):
    method, path, payload = ERROR_REQUESTS[case]
    body = payload if isinstance(payload, bytes) or payload is None else json.dumps(
        payload).encode()
    st, raw = _request(port_server[1], method, path, body)
    jst, jraw = _request(jax_server[1], method, path, body)
    assert 400 <= st < 500 and st == jst
    assert json.loads(raw) == json.loads(jraw)


def test_tokenize_matches_jax(port_server, jax_server, engines):
    payload = {"input": TEXTS + ["word " * 400]}
    st, ours = _post(port_server[1], "/v1/tokenize", payload)
    jst, theirs = _post(jax_server[1], "/v1/tokenize", payload)
    assert st == jst == 200 and ours == theirs
    assert ours["ids"] == engines["default"].tokenize_batch(payload["input"])


@pytest.mark.parametrize("extra", [{}, {"top_n": 3}, {"return_documents": True, "top_n": 2}])
def test_rerank_matches_jax(port_server, jax_server, engines, extra):
    payload = {"query": "where is the dog", "documents": CORPUS, "model": "reranker", **extra}
    st, ours = _post(port_server[1], "/v1/rerank", payload)
    jst, theirs = _post(jax_server[1], "/v1/rerank", payload)
    assert st == jst == 200
    assert ours["model"] == theirs["model"] == "reranker"
    assert [r["index"] for r in ours["results"]] == [r["index"] for r in theirs["results"]]
    assert [r.get("document") for r in ours["results"]] == [
        r.get("document") for r in theirs["results"]]
    np.testing.assert_allclose([r["relevance_score"] for r in ours["results"]],
                               [r["relevance_score"] for r in theirs["results"]],
                               rtol=0, atol=ATOL)
    want = engines["reranker"].rerank(payload["query"], CORPUS, top_n=extra.get("top_n"))
    assert [r["index"] for r in ours["results"]] == [r["index"] for r in want]


def test_index_and_search_match_jax(port_server, jax_server, engines):
    """Search before any index is the same 400; then the same ids and
    scores, k past the corpus dropping its empty slots; and the ranking of
    the port's own VectorIndex."""
    from embedding_cpp_tpu_torch.runtime.search import VectorIndex

    for port in (port_server[1], jax_server[1]):
        st, body = _post(port, "/v1/search", {"input": ["q"]})
        assert st == 400 and body["error"]["message"] == "no index built (POST /v1/index first)"
    for port in (port_server[1], jax_server[1]):
        assert _post(port, "/v1/index", {"input": CORPUS[:5]}) == (
            200, {"object": "index", "total": 5})
        assert _post(port, "/v1/index", {"input": CORPUS[5:]})[1]["total"] == len(CORPUS)
    direct = VectorIndex(engines["default"])
    direct.add(CORPUS)
    queries = ["a lazy dog", CORPUS[3], "fox"]
    for k in (3, 100):
        st, ours = _post(port_server[1], "/v1/search", {"input": queries, "k": k})
        jst, theirs = _post(jax_server[1], "/v1/search", {"input": queries, "k": k})
        assert st == jst == 200
        ids, scores = direct.search(queries, k)
        for row, jrow, i_row, s_row in zip(ours["results"], theirs["results"], ids, scores):
            assert [h["index"] for h in row] == [h["index"] for h in jrow] == [
                int(i) for i in i_row if i >= 0]
            np.testing.assert_allclose([h["score"] for h in row], [h["score"] for h in jrow],
                                       rtol=0, atol=ATOL)
            np.testing.assert_allclose([h["score"] for h in row], s_row[: len(row)],
                                       rtol=0, atol=1e-6)


def test_token_embeddings_and_maxsim(port_server, engines):
    eng = engines["default"]
    st, body = _post(port_server[1], "/v1/token_embeddings", {"input": TEXTS})
    assert st == 200 and body["model"] == "tiny-test"
    for d, want in zip(body["data"], eng.encode_token_states(TEXTS)):
        np.testing.assert_allclose(np.array(d["embeddings"], np.float32), want,
                                   rtol=0, atol=1e-6)
    payload = {"query": "the lazy dog", "documents": CORPUS, "top_n": 4,
               "return_documents": True}
    st, body = _post(port_server[1], "/v1/maxsim", payload)
    want = eng.maxsim_rerank(payload["query"], CORPUS, top_n=4)
    assert st == 200 and body["object"] == "maxsim"
    assert [r["index"] for r in body["results"]] == [r["index"] for r in want]
    assert [r["document"]["text"] for r in body["results"]] == [
        CORPUS[r["index"]] for r in want]
    np.testing.assert_allclose([r["relevance_score"] for r in body["results"]],
                               [r["relevance_score"] for r in want], rtol=0, atol=1e-5)


def test_maxsim_index_and_search(port_server, engines):
    from embedding_cpp_tpu_torch.runtime.maxsim_search import MaxSimIndex

    st, body = _post(port_server[1], "/v1/maxsim_index", {"input": CORPUS})
    assert (st, body) == (200, {"object": "maxsim_index", "total": len(CORPUS)})
    direct = MaxSimIndex(engines["default"])
    direct.add(CORPUS)
    queries = ["lazy dog", "red fox"]
    for extra in ({}, {"candidates": 4}):
        st, body = _post(port_server[1], "/v1/maxsim_search",
                         {"input": queries, "k": 3, **extra})
        ids, scores = direct.search(queries, 3, candidates=extra.get("candidates"))
        assert st == 200 and body["object"] == "maxsim_search"
        for row, i_row, s_row in zip(body["results"], ids, scores):
            assert [h["index"] for h in row] == [int(i) for i in i_row]
            np.testing.assert_allclose([h["score"] for h in row], s_row, rtol=0, atol=1e-5)
    st, body = _post(port_server[1], "/v1/maxsim_search", {"input": ["q"], "candidates": 0})
    assert st == 400 and body["error"]["message"] == "candidates must be a positive int"


def test_sparse_routes(port_server, engines):
    """SPLADE vectors and the sparse index (exact and two-stage) on the
    "splade" model, against the direct calls."""
    from embedding_cpp_tpu_torch.runtime.sparse_search import SparseIndex

    splade, port = engines["splade"], port_server[1]
    st, body = _post(port, "/v1/sparse_embeddings",
                     {"input": TEXTS, "k": 16, "model": "splade", "return_tokens": True})
    assert st == 200 and body["model"] == "splade"
    for row, (idx, val) in zip(body["data"], splade.encode_sparse(TEXTS, k=16)):
        assert row["indices"] == [int(i) for i in idx]
        np.testing.assert_allclose(row["values"], val, rtol=0, atol=1e-6)
        assert row["tokens"] == [splade.id_to_token(int(i)) for i in idx]
    queries = ["lazy dog", "quick fox"]
    assert _post(port, "/v1/sparse_index", {"input": CORPUS, "model": "splade"})[1][
        "total"] == len(CORPUS)
    sparse = SparseIndex(splade)
    sparse.add(CORPUS)
    for extra in ({}, {"candidates": 4}):
        st, body = _post(port, "/v1/sparse_search",
                         {"input": queries, "k": 3, "model": "splade", **extra})
        ids, scores = sparse.search(queries, 3, candidates=extra.get("candidates"))
        assert st == 200
        for row, i_row, s_row in zip(body["results"], ids, scores):
            assert [h["index"] for h in row] == [int(i) for i in i_row]
            np.testing.assert_allclose([h["score"] for h in row], s_row, rtol=0, atol=1e-5)


def test_hybrid_index_and_search(engines):
    from embedding_cpp_tpu_torch.runtime.search import VectorIndex
    from embedding_cpp_tpu_torch.runtime.sparse_search import SparseIndex, rrf_fuse

    splade = engines["splade"]
    with _port_server(splade) as (_, port):
        st, body = _post(port, "/v1/hybrid_index", {"input": CORPUS})
        assert (st, body) == (200, {"object": "hybrid_index", "total": len(CORPUS)})
        queries = ["lazy dog", "quick fox"]
        st, body = _post(port, "/v1/hybrid_search", {"input": queries, "k": 4})
    dense, sparse = VectorIndex(splade), SparseIndex(splade)
    dense.add(CORPUS)
    sparse.add(CORPUS)
    ids, scores = rrf_fuse([dense.search(queries, 4)[0], sparse.search(queries, 4)[0]], 4)
    assert st == 200 and body["object"] == "hybrid_search"
    for row, i_row, s_row in zip(body["results"], ids, scores):
        assert [h["index"] for h in row] == [int(i) for i in i_row if i >= 0]
        np.testing.assert_allclose([h["score"] for h in row], s_row[: len(row)], rtol=0,
                                   atol=1e-7)


def test_health_metrics_and_models(port_server, jax_server):
    port = port_server[1]
    assert _get(port, "/healthz") == (200, b"ok")
    st, raw = _get(port, "/metrics")
    snap = json.loads(raw)
    assert st == 200 and "server" in snap and set(snap["models"]) == {"reranker", "splade"}
    st, raw = _get(port, "/v1/models")
    assert st == 200 and json.loads(raw) == json.loads(_get(jax_server[1], "/v1/models")[1])
    assert [m["id"] for m in json.loads(raw)["data"]] == ["reranker", "splade", "tiny-test"]


def test_model_routing(port_server, engines):
    """The "model" field picks the batcher: the splade model's vectors, the
    default's under its own name, and a 404 naming every model served."""
    port = port_server[1]
    for name, eng in (("splade", engines["splade"]), ("tiny-test", engines["default"])):
        st, body = _post(port, "/v1/embeddings", {"input": TEXTS, "model": name})
        assert st == 200 and body["model"] == name
        np.testing.assert_allclose(_vectors(body), eng.encode(TEXTS), rtol=0, atol=1e-6)
    st, body = _post(port, "/v1/embeddings", {"input": "a", "model": "tiny"})
    assert st == 404
    assert body["error"]["message"] == (
        "unknown model 'tiny' (serving: reranker, splade, tiny-test)")


def test_tcp_and_http_share_one_batcher(port_server, engines):
    from embedding_cpp_tpu_torch.runtime.client import EmbeddingClient

    tcp, port = port_server

    def server_block():
        return json.loads(_get(port, "/metrics")[1])["server"]

    before = server_block()
    with EmbeddingClient("127.0.0.1", tcp) as c:
        tcp_vecs = c.embed(TEXTS[:3])
    st, body = _post(port, "/v1/embeddings", {"input": TEXTS[:2]})
    after = server_block()
    assert after["requests"] - before["requests"] == 2
    assert after["sentences"] - before["sentences"] == 5
    assert np.array_equal(_vectors(body), tcp_vecs[:2])
    np.testing.assert_allclose(tcp_vecs, engines["default"].encode(TEXTS[:3]), rtol=0,
                               atol=1e-6)


def test_overload_is_429(engines):
    """Past the pending cap every route answers 429, and the batcher counts
    the refusals."""
    with _port_server(engines["default"], max_pending=2) as (_, port):
        three = {"input": ["a", "b", "c"]}
        for path in ("/v1/embeddings", "/v1/tokenize", "/v1/index", "/v1/token_embeddings"):
            st, body = _post(port, path, three)
            assert st == 429, path
            assert body["error"]["message"].startswith("request too large: 3 sentences")
        st, body = _post(port, "/v1/maxsim", {"query": "q", "documents": ["a", "b", "c"]})
        assert st == 429
        assert _post(port, "/v1/embeddings", {"input": ["a", "b"]})[0] == 200
        assert json.loads(_get(port, "/metrics")[1])["server"]["rejected"] == 5


def _raw(port: int, payload: bytes) -> tuple[bytes, bool]:
    """Send raw bytes; -> (the response, whether the server closed)."""
    s = socket.create_connection(("127.0.0.1", port), 30)
    s.sendall(payload)
    data, closed = b"", False
    s.settimeout(5)
    try:
        while True:
            chunk = s.recv(65536)
            if not chunk:
                closed = True
                break
            data += chunk
            head, _, body = data.partition(b"\r\n\r\n")
            length = [int(line.split(b":")[1]) for line in head.split(b"\r\n")
                      if line.lower().startswith(b"content-length")]
            if length and len(body) >= length[0] and b"keep-alive" in head:
                break
    finally:
        s.close()
    return data, closed


HOSTILE = {
    "bad_length": (b"POST /v1/embeddings HTTP/1.1\r\nContent-Length: abc\r\n\r\n", 400,
                   "malformed content-length"),
    "negative_length": (b"POST /v1/embeddings HTTP/1.1\r\nContent-Length: -5\r\n\r\n", 400,
                        "malformed content-length"),
    "chunked": (b"POST /v1/embeddings HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n", 400,
                "chunked transfer encoding not supported"),
    "huge_body": (b"POST /v1/embeddings HTTP/1.1\r\nContent-Length: 999999999999\r\n\r\n",
                  413, "body too large (999999999999 bytes)"),
    "two_lengths": (b"POST /v1/embeddings HTTP/1.1\r\nContent-Length: 2\r\n"
                    b"Content-Length: 4\r\n\r\n{}", 400, "duplicate content-length header"),
    "request_line": (b"GET /" + b"a" * 70000 + b" HTTP/1.1\r\n\r\n", 400,
                     "request line too long"),
    "malformed_line": (b"GET /healthz\r\n\r\n", 400, "malformed request line"),
    "headers_too_large": (b"GET /healthz HTTP/1.1\r\n" + b"X-A: " + b"b" * 60000 + b"\r\n"
                          + b"X-B: " + b"c" * 10000 + b"\r\n\r\n", 400, "headers too large"),
}


@pytest.mark.parametrize("case", HOSTILE)
def test_hostile_requests_get_an_error_and_close(port_server, jax_server, case):
    payload, status, message = HOSTILE[case]
    for port in (port_server[1], jax_server[1]):
        data, closed = _raw(port, payload)
        head, _, body = data.partition(b"\r\n\r\n")
        assert head.split(b" ", 2)[1] == str(status).encode()
        assert b"Connection: close" in head and closed
        assert json.loads(body)["error"]["message"] == message


def test_keep_alive_and_connection_close(port_server, engines):
    conn = http.client.HTTPConnection("127.0.0.1", port_server[1], timeout=30)
    for i in range(3):
        conn.request("POST", "/v1/embeddings", json.dumps({"input": f"request {i}"}))
        r = conn.getresponse()
        assert r.status == 200 and r.getheader("Connection") == "keep-alive"
        vec = _vectors(json.loads(r.read()))[0]
        np.testing.assert_allclose(vec, engines["default"].encode([f"request {i}"])[0],
                                   rtol=0, atol=1e-6)
    conn.request("GET", "/nope")  # an error keeps the connection
    r = conn.getresponse()
    assert r.status == 404 and r.getheader("Connection") == "keep-alive"
    r.read()
    conn.close()
    data, closed = _raw(port_server[1], b"GET /healthz HTTP/1.1\r\nConnection: close\r\n\r\n")
    assert closed and b"Connection: close" in data and data.endswith(b"ok")


def test_serve_http_alone(engines):
    from embedding_cpp_tpu_torch.runtime.http_server import serve_http

    port = free_port()
    with serving(lambda: serve_http(engines["reranker"], "127.0.0.1", port), port):
        st, body = _post(port, "/v1/rerank", {"query": "dog", "documents": CORPUS[:3]})
        assert st == 200 and body["model"] == "tiny-reranker-test"
        want = engines["reranker"].rerank("dog", CORPUS[:3])
        assert [r["index"] for r in body["results"]] == [r["index"] for r in want]


def test_server_cli_needs_http_port_for_several_models(ggufs, capsys):
    from embedding_cpp_tpu_torch.runtime.server import main

    with pytest.raises(SystemExit):
        main(["-m", ggufs["tiny"], "-m", f"splade={ggufs['tiny-splade']}", "--device", "cpu"])
    assert "serving several models requires --http-port" in capsys.readouterr().err
