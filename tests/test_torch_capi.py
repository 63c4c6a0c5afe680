"""The reference's C client (native/capi/tpuembed.h, the bert.h analog)
against the port's server and the reference's server, through ctypes.

The client library is built on demand from `native/capi/tpuembed_capi.cpp`
with `make -C native`, into this module's temporary directory (so parallel
test workers never race on one output file); the tests skip only where
`make` or `g++` is missing.  Both servers run CPU engines over one tiny f32
GGUF written by the JAX package: `tpe_connect` returns, `tpe_n_max_tokens`,
`tpe_tokenize`, `tpe_eval_batch` (f32 bar) and `tpe_vocab_id_to_token` give
the same results from both, as do `tpe_maxsim` and, on a tiny-splade GGUF,
`tpe_encode_sparse`, and the index calls (`tpe_index` / `tpe_search` and
their sparse, hybrid and MaxSim forms) on fresh servers.
"""
import asyncio
import contextlib
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
ATOL_F32 = 2e-5  # the f32 bar of the engine parity tests
TEXTS = ["hello tokenized world", "the quick brown fox jumps over the lazy dog", "a",
         "Hello, World!  Ünïcödé 中文"]


@pytest.fixture(scope="module")
def capi_lib(tmp_path_factory) -> str:
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no C++ toolchain (make and g++)")
    build = tmp_path_factory.mktemp("capi-build")
    lib = build / "libtpuembed_capi.so"
    r = subprocess.run(["make", "-C", str(ROOT / "native"), f"BUILD={build}", str(lib)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        pytest.fail(f"native build failed:\n{r.stdout}\n{r.stderr}")
    return str(lib)


@contextlib.contextmanager
def _serve(serve, engine):
    """`serve(engine, host, port)` on its own event-loop thread; yields the
    port once it accepts connections."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    loop = asyncio.new_event_loop()
    holder = {}

    def main():
        asyncio.set_event_loop(loop)
        holder["task"] = loop.create_task(serve(engine, "127.0.0.1", port))
        try:
            loop.run_until_complete(holder["task"])
        except asyncio.CancelledError:
            pass
        finally:
            loop.close()

    t = threading.Thread(target=main, daemon=True)
    t.start()
    for _ in range(200):
        try:
            socket.create_connection(("127.0.0.1", port), 0.2).close()
            break
        except OSError:
            time.sleep(0.05)
    try:
        yield port
    finally:
        loop.call_soon_threadsafe(holder["task"].cancel)
        t.join(timeout=10)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """{"port": (engine, port), "reference": (engine, port)}."""
    from embedding_cpp_tpu.cli.make_test_model import make_test_model
    from embedding_cpp_tpu.runtime.engine import Engine as JEngine
    from embedding_cpp_tpu_torch import Engine

    path = str(tmp_path_factory.mktemp("gguf") / "tiny-f32.gguf")
    make_test_model(path, "tiny", "f32", seed=0)
    with _both_servers(Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)) as out:
        yield out


@contextlib.contextmanager
def _both_servers(ours, theirs):
    from embedding_cpp_tpu.runtime.server import serve as serve_reference
    from embedding_cpp_tpu_torch.runtime.server import serve as serve_port

    with _serve(serve_port, ours) as p1, _serve(serve_reference, theirs) as p2:
        yield {"port": (ours, p1), "reference": (theirs, p2)}


@contextlib.contextmanager
def _fresh(servers):
    """New servers over the same engines: their indexes start empty."""
    with _both_servers(servers["port"][0], servers["reference"][0]) as out:
        yield out


def _client(lib: str, port: int):
    sys.path.insert(0, str(ROOT))
    from examples.sample_dylib import TpuEmbedModel

    return TpuEmbedModel(host="127.0.0.1", port=port, lib_path=lib)


@pytest.fixture(scope="module")
def replies(capi_lib, servers):
    """Each server's answers to the bert.h calls, through one context."""
    out = {}
    for side, (engine, port) in servers.items():
        model = _client(capi_lib, port)
        try:
            ids = [model.tokenize(t) for t in TEXTS]
            out[side] = {
                "n_embd": model.n_embd,
                "n_max_tokens": model.n_max_tokens,
                "ids": ids,
                "eval": model.eval_tokens(ids + [[2, 3]]),
                "vocab": [model.id_to_token(i) for i in (0, 1, 2, 3, 150, 999, 5000)],
                "encode": model.encode(TEXTS),
            }
        finally:
            model.close()
    return out


@pytest.mark.parametrize("side", ["port", "reference"])
def test_connect_returns(capi_lib, servers, side):
    engine, port = servers[side]
    model = _client(capi_lib, port)
    try:
        assert model.n_embd == engine.n_embd == 64
        assert model.n_max_tokens == engine.n_max_tokens == 128
    finally:
        model.close()


def test_n_max_tokens_tokenize_vocab_are_equal(replies, servers):
    ours, theirs = replies["port"], replies["reference"]
    for key in ("n_embd", "n_max_tokens", "ids", "vocab"):
        assert ours[key] == theirs[key], key
    engine, _ = servers["port"]
    assert ours["ids"] == [engine.tokenize(t) for t in TEXTS]
    assert ours["vocab"][-1] == ""  # an unknown id: the empty token


def test_eval_batch_and_encode_meet_the_f32_bar(replies, servers):
    ours, theirs = replies["port"], replies["reference"]
    np.testing.assert_allclose(ours["eval"], theirs["eval"], rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(ours["encode"], theirs["encode"], rtol=0, atol=ATOL_F32)
    engine, _ = servers["port"]
    np.testing.assert_allclose(ours["eval"][:len(TEXTS)], engine.encode(TEXTS),
                               rtol=0, atol=1e-6)


DOCS = ["a document", "another one", "the quick brown fox", "a document", "hello world"]
QUERIES = ["a document", "a fox"]
# each index call, and each search call after the index call it needs;
# sparse and hybrid on the tiny-splade servers
INDEX_CALLS = {
    "index": ("index", None, "servers"),
    "search": ("search", "index", "servers"),
    "sparse_index": ("sparse_index", None, "splade_servers"),
    "sparse_search": ("sparse_search", "sparse_index", "splade_servers"),
    "hybrid_index": ("hybrid_index", None, "splade_servers"),
    "hybrid_search": ("hybrid_search", "hybrid_index", "splade_servers"),
    "maxsim_index": ("maxsim_index", None, "servers"),
    "maxsim_search": ("maxsim_search", "maxsim_index", "servers"),
}


@pytest.mark.parametrize("call", sorted(INDEX_CALLS))
def test_index_call_is_equal_from_both_servers(capi_lib, request, call):
    """tpe_index / tpe_search and the sparse, hybrid and MaxSim calls: a
    search before its index fails with the server's message, then the
    index totals and the search ids (k past the corpus: -1 there) are
    equal from both servers, the scores at the f32 bar; the context still
    encodes after the error.  Each call runs on fresh servers."""
    fn, index_fn, fixture = INDEX_CALLS[call]
    got = {}
    with _fresh(request.getfixturevalue(fixture)) as fresh:
        for side, (engine, port) in fresh.items():
            model = _client(capi_lib, port)
            try:
                if index_fn is None:
                    got[side] = [getattr(model, fn)(DOCS), getattr(model, fn)(DOCS[:2])]
                    continue
                with pytest.raises(RuntimeError, match="RuntimeError: .*(no .*index built|both)"):
                    getattr(model, fn)(QUERIES, 3)
                np.testing.assert_allclose(model.encode(TEXTS[:2]), engine.encode(TEXTS[:2]),
                                           rtol=0, atol=1e-6)
                getattr(model, index_fn)(DOCS)
                got[side] = [getattr(model, fn)(QUERIES, k) for k in (3, 8)]
            finally:
                model.close()
    if index_fn is None:
        assert got["port"] == got["reference"] == [5, 7]
        return
    for (idx, scores), (idx_ref, scores_ref), k in zip(got["port"], got["reference"], (3, 8)):
        assert idx.shape == (2, k)
        np.testing.assert_array_equal(idx, idx_ref)
        np.testing.assert_allclose(scores, scores_ref, rtol=0, atol=ATOL_F32)
    if fn != "hybrid_search":
        assert (got["port"][1][0][:, 5:] == -1).all()


@pytest.mark.parametrize("top_n", [None, 1])
def test_maxsim_is_equal_from_both_servers(capi_lib, servers, top_n):
    """tpe_maxsim (late interaction over the tiny model's token states)."""
    got = {}
    for side, (_, port) in servers.items():
        model = _client(capi_lib, port)
        try:
            got[side] = model.maxsim("a query about the fox", TEXTS, top_n=top_n)
        finally:
            model.close()
    (idx, scores), (idx_ref, scores_ref) = got["port"], got["reference"]
    assert idx.tolist() == idx_ref.tolist() and len(idx) == (top_n or len(TEXTS))
    np.testing.assert_allclose(scores, scores_ref, rtol=0, atol=ATOL_F32)
    engine, _ = servers["port"]
    want = engine.maxsim_rerank("a query about the fox", TEXTS, top_n=top_n)
    assert idx.tolist() == [r["index"] for r in want]


@pytest.fixture(scope="module")
def splade_servers(tmp_path_factory):
    from embedding_cpp_tpu.cli.make_test_model import make_test_model
    from embedding_cpp_tpu.runtime.engine import Engine as JEngine
    from embedding_cpp_tpu_torch import Engine

    path = str(tmp_path_factory.mktemp("gguf") / "tiny-splade.gguf")
    make_test_model(path, "tiny-splade", "f32", seed=0)
    with _both_servers(Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)) as out:
        yield out


@pytest.mark.parametrize("k", [8, 64])
def test_encode_sparse_is_equal_from_both_servers(capi_lib, splade_servers, k):
    """tpe_encode_sparse on a tiny-splade model: the same term sets and
    weights from both servers (top-k orders ties freely), equal to
    Engine.encode_sparse."""
    got = {}
    for side, (_, port) in splade_servers.items():
        model = _client(capi_lib, port)
        try:
            got[side] = model.encode_sparse(TEXTS, k=k)
        finally:
            model.close()
    engine, _ = splade_servers["port"]
    for (gi, gv), (ri, rv), (wi, _) in zip(got["port"], got["reference"],
                                           engine.encode_sparse(TEXTS, k=k)):
        assert 0 < len(gi) <= k and set(gi.tolist()) == set(ri.tolist())
        g = dict(zip(gi.tolist(), gv.tolist()))
        np.testing.assert_allclose([g[i] for i in ri.tolist()], rv, rtol=0, atol=ATOL_F32)
        np.testing.assert_array_equal(gi, wi)


def test_encode_sparse_on_a_dense_model_errors_and_the_context_still_encodes(capi_lib,
                                                                            servers):
    engine, port = servers["port"]
    model = _client(capi_lib, port)
    try:
        with pytest.raises(RuntimeError, match="no MLM head"):
            model.encode_sparse(DOCS, 16)
        np.testing.assert_allclose(model.encode(TEXTS[:2]), engine.encode(TEXTS[:2]),
                                   rtol=0, atol=1e-6)
    finally:
        model.close()


@pytest.mark.parametrize("bad", [-1, 1 << 20], ids=["negative", "past-the-vocab"])
def test_eval_batch_with_an_id_outside_the_vocab_errors_and_the_context_still_encodes(
        capi_lib, servers, bad):
    engine, port = servers["port"]
    model = _client(capi_lib, port)
    try:
        with pytest.raises(RuntimeError, match="outside 0.."):
            model.eval_tokens([[2, 5, 3], [2, bad, 3]])
        np.testing.assert_allclose(model.encode(TEXTS[:2]), engine.encode(TEXTS[:2]),
                                   rtol=0, atol=1e-6)
    finally:
        model.close()
