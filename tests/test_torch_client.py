"""The port's `EmbeddingClient` (`runtime/client.py`) against the port's
server over tiny f32 GGUFs: every method's reply equals the direct Engine
or index call, and equals the reply of the JAX package's client from the
same server (a one-logit cross-encoder served on one port, a SPLADE model
on another)."""
import contextlib

import numpy as np
import pytest
from torch_native import free_port, serving

from embedding_cpp_tpu.runtime.client import EmbeddingClient as JClient
from embedding_cpp_tpu_torch import Engine
from embedding_cpp_tpu_torch.models import ComputeOptions
from embedding_cpp_tpu_torch.runtime.client import EmbeddingClient

CORPUS = [f"document {i} about the {w} fox and a lazy dog" for i, w in
          enumerate(("quick", "brown", "red", "slow", "small", "big", "old", "new"))]
TEXTS = ["hello world", "the quick brown fox jumps over the lazy dog", "a", "Café déjà vu!"]
QUERIES = ["lazy dog", "red fox", "nothing"]


@contextlib.contextmanager
def _served(engine):
    from embedding_cpp_tpu_torch.runtime.server import serve

    port = free_port()
    with serving(lambda: serve(engine, "127.0.0.1", port), port):
        yield port


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """name -> (engine, TCP port) for the reranker and the SPLADE model."""
    from embedding_cpp_tpu_torch.cli.make_test_model import make_test_model

    out, stack = {}, contextlib.ExitStack()
    with stack:
        for name, preset in (("reranker", "tiny-reranker"), ("splade", "tiny-splade")):
            path = str(tmp_path_factory.mktemp("gguf") / f"{preset}.gguf")
            make_test_model(path, preset, "f32", seed=0)
            eng = Engine.from_gguf(path, device="cpu", opts=ComputeOptions(dtype="float32"))
            out[name] = (eng, stack.enter_context(_served(eng)))
        yield out


@pytest.fixture
def clients(served, request):
    eng, port = served[request.param]
    with EmbeddingClient("127.0.0.1", port) as ours, JClient("127.0.0.1", port) as theirs:
        yield eng, ours, theirs


def _same(a, b) -> None:
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("clients", ["reranker"], indirect=True)
def test_embed_rerank_and_health(clients):
    eng, ours, theirs = clients
    assert ours.n_embd == theirs.n_embd == eng.n_embd
    got = ours.embed(TEXTS)
    np.testing.assert_allclose(got, eng.encode(TEXTS), rtol=0, atol=1e-6)
    _same(got, theirs.embed(TEXTS))
    i8 = ours.embed(TEXTS, wire="int8")
    _same(i8, theirs.embed(TEXTS, wire="int8"))
    assert np.min(np.sum(i8 * got, -1) / np.linalg.norm(i8, axis=-1)) > 0.999
    raw = ours.embed_raw("hello world")
    np.testing.assert_allclose(raw, eng.encode(["hello world"])[0], rtol=0, atol=1e-6)
    _same(raw, theirs.embed_raw("hello world"))
    idx, scores = ours.rerank("where is the dog", CORPUS, top_n=5)
    want = eng.rerank("where is the dog", CORPUS, top_n=5)
    assert idx.tolist() == [r["index"] for r in want]
    np.testing.assert_allclose(scores, [r["relevance_score"] for r in want], rtol=0, atol=1e-6)
    _same((idx, scores), theirs.rerank("where is the dog", CORPUS, top_n=5))
    m_idx, m_scores = ours.maxsim("lazy dog", CORPUS)
    want = eng.maxsim_rerank("lazy dog", CORPUS)
    assert m_idx.tolist() == [r["index"] for r in want]
    np.testing.assert_allclose(m_scores, [r["relevance_score"] for r in want], rtol=0,
                               atol=1e-5)
    _same((m_idx, m_scores), theirs.maxsim("lazy dog", CORPUS))
    assert ours.health() and theirs.health()
    stats = ours.stats()
    assert stats["server"]["requests"] > 0 and stats.keys() == theirs.stats().keys()
    with pytest.raises(ValueError):
        ours.embed(TEXTS, wire="f16")


@pytest.mark.parametrize("clients", ["reranker"], indirect=True)
def test_index_and_search(clients):
    from embedding_cpp_tpu_torch.runtime.search import VectorIndex

    eng, ours, theirs = clients
    with pytest.raises(RuntimeError, match="no index built"):
        ours.search(QUERIES)
    assert ours.index(CORPUS[:5]) == 5
    assert theirs.index(CORPUS[5:]) == len(CORPUS)
    direct = VectorIndex(eng)
    direct.add(CORPUS)
    for k in (3, 20):
        got = ours.search(QUERIES, k=k)
        want = direct.search(QUERIES, k)
        assert np.array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
        _same(got, theirs.search(QUERIES, k=k))


@pytest.mark.parametrize("clients", ["splade"], indirect=True)
def test_sparse_hybrid_and_maxsim_indexes(clients):
    from embedding_cpp_tpu_torch.runtime.maxsim_search import MaxSimIndex
    from embedding_cpp_tpu_torch.runtime.search import VectorIndex
    from embedding_cpp_tpu_torch.runtime.sparse_search import SparseIndex, rrf_fuse

    eng, ours, theirs = clients
    got = ours.encode_sparse(TEXTS, k=16)
    for (idx, val), (w_idx, w_val) in zip(got, eng.encode_sparse(TEXTS, k=16)):
        assert idx.tolist() == [int(i) for i in w_idx]
        np.testing.assert_allclose(val, w_val, rtol=0, atol=1e-6)
    _same(got, theirs.encode_sparse(TEXTS, k=16))
    assert ours.hybrid_index(CORPUS[:4]) == 4
    assert theirs.hybrid_index(CORPUS[4:]) == len(CORPUS)
    dense, sparse = VectorIndex(eng), SparseIndex(eng)
    dense.add(CORPUS)
    sparse.add(CORPUS)
    s_got = ours.sparse_search(QUERIES, k=4)
    s_want = sparse.search(QUERIES, 4)
    assert np.array_equal(s_got[0], s_want[0])
    np.testing.assert_allclose(s_got[1], s_want[1], rtol=0, atol=1e-5)
    _same(s_got, theirs.sparse_search(QUERIES, k=4))
    h_got = ours.hybrid_search(QUERIES, k=4)
    h_want = rrf_fuse([dense.search(QUERIES, 4)[0], sparse.search(QUERIES, 4)[0]], 4)
    assert np.array_equal(h_got[0], h_want[0])
    np.testing.assert_allclose(h_got[1], h_want[1], rtol=0, atol=1e-7)
    _same(h_got, theirs.hybrid_search(QUERIES, k=4))
    assert ours.sparse_index(["one more document"]) == len(CORPUS) + 1
    with pytest.raises(RuntimeError, match="hybrid corpus desync"):
        ours.hybrid_search(QUERIES)
    assert ours.maxsim_index(CORPUS) == len(CORPUS)
    direct = MaxSimIndex(eng)
    direct.add(CORPUS)
    m_got = ours.maxsim_search(QUERIES, k=3)
    m_want = direct.search(QUERIES, 3)
    assert np.array_equal(m_got[0], m_want[0])
    np.testing.assert_allclose(m_got[1], m_want[1], rtol=0, atol=1e-5)
    _same(m_got, theirs.maxsim_search(QUERIES, k=3))


@pytest.mark.parametrize("clients", ["reranker"], indirect=True)
def test_refusals_raise_with_the_message(clients):
    """A frame the server refuses raises RuntimeError in both clients, and
    the connection stays usable."""
    eng, ours, theirs = clients
    for client in (ours, theirs):
        with pytest.raises(RuntimeError, match="MLM head|mlm_head|sparse"):
            client.encode_sparse(["x"])
        np.testing.assert_allclose(client.embed(["still here"]),
                                   eng.encode(["still here"]), rtol=0, atol=1e-6)
