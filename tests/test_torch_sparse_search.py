"""The port's sparse index and reciprocal-rank fusion
(`runtime/sparse_search.py`) against the JAX package's.

Both backends: the device backend's torch code on the CPU (`device="cpu"`)
against the reference's device index, and the numpy host backend against
the reference's host index.  Ids equal, including the order of equal
scores (duplicate documents across k); scores within 1e-5 relative.  The
two-stage candidates mode at several C (equal to exact at C >= n; the
reference's `approx_max_k` on the CPU is the exact top-k there), the
padded-COO width, empty documents, query terms past the vocabulary, the
refusals, `.npz` files across the packages both ways, the engine-backed
index on a tiny-splade GGUF, and `rrf_fuse` bit for bit on random rankings
with -1 slots.
"""
import numpy as np
import pytest
import torch

from embedding_cpp_tpu.cli.make_test_model import make_test_model
from embedding_cpp_tpu.runtime import sparse_search as jsparse
from embedding_cpp_tpu.runtime.engine import Engine as JEngine
from embedding_cpp_tpu_torch import Engine
from embedding_cpp_tpu_torch.runtime.sparse_search import SparseIndex, rrf_fuse

RTOL = 1e-5


def _pairs(rng, n, v=4096, lo=10, hi=120, decay=0.0):
    out = []
    for _ in range(n):
        nnz = int(rng.integers(lo, hi))
        idx = rng.choice(v, size=nnz, replace=False).astype(np.int32)
        val = rng.random(nnz).astype(np.float32)
        if decay:  # SPLADE-like: the mass in a few heavy terms
            val = np.sort(val)[::-1] * np.exp(-decay * np.arange(nnz, dtype=np.float32))
        out.append((idx, np.ascontiguousarray(val, np.float32)))
    return out


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(3)
    docs = _pairs(rng, 300)
    docs[50] = docs[200] = docs[7]  # three equal documents
    queries = _pairs(rng, 5, lo=4, hi=30)
    queries[0] = docs[7]
    return docs, queries


def _both(docs, backend, **kw):
    ours = SparseIndex(device="cpu" if backend == "device" else False, **kw)
    theirs = jsparse.SparseIndex(device=backend == "device", **kw)
    assert ours.add_vectors(docs) == theirs.add_vectors(docs) == len(docs)
    return ours, theirs


def _same(got, ref):
    (ids, scores), (ids_ref, scores_ref) = got, ref
    np.testing.assert_array_equal(ids, ids_ref)
    assert ids.dtype == np.int32 and scores.dtype == np.float32
    fin = np.isfinite(scores_ref)
    np.testing.assert_array_equal(np.isfinite(scores), fin)
    np.testing.assert_allclose(scores[fin], scores_ref[fin], rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("k", [1, 2, 7, 400])
def test_search_matches_jax(corpus, backend, k):
    """k 2 cuts between the equal documents 7, 50, 200 (query 0 is one of
    them): the device backend keeps the lower ids, the host backend the
    reference's host order (numpy's argpartition); k 400 pads past the
    corpus."""
    docs, queries = corpus
    ours, theirs = _both(docs, backend)
    got = ours.search_vectors(queries, k=k)
    _same(got, theirs.search_vectors(queries, k=k))
    top = got[0][0, :min(k, 3)].tolist()
    if backend == "device":
        assert top == [7, 50, 200][:k]
    else:
        assert set(top) <= {7, 50, 200} and len(set(top)) == len(top)
    if k == 400:
        assert np.all(got[0][:, 300:] == -1) and np.all(np.isneginf(got[1][:, 300:]))


def test_device_backend_equals_host_backend_and_brute_force():
    rng = np.random.default_rng(4)
    docs, queries = _pairs(rng, 300), _pairs(rng, 5, lo=4, hi=30)
    dev, host = SparseIndex(device="cpu"), SparseIndex(device=False)
    dev.add_vectors(docs)
    host.add_vectors(docs)
    (di, ds), (hi, hs) = dev.search_vectors(queries, k=9), host.search_vectors(queries, k=9)
    np.testing.assert_array_equal(di, hi)
    np.testing.assert_allclose(ds, hs, rtol=RTOL)
    dense = np.zeros((len(docs), 4096), np.float32)
    for i, (idx, val) in enumerate(docs):
        dense[i, idx] = val
    for q, (idx, val) in enumerate(queries):
        want = dense[:, idx] @ val
        np.testing.assert_allclose(ds[q], np.sort(want)[::-1][:9], rtol=RTOL)


@pytest.mark.parametrize("c", [8, 64, 300, 1000])
def test_candidates_mode_matches_jax(corpus, c):
    docs, queries = corpus
    ours, theirs = _both(docs, "device")
    got = ours.search_vectors(queries, k=7, candidates=c)
    _same(got, theirs.search_vectors(queries, k=7, candidates=c))
    if c >= len(docs):
        _same(got, ours.search_vectors(queries, k=7))


@pytest.mark.parametrize("prefix", [1, 4, 16])
def test_candidates_on_impact_sorted_rows_match_jax(prefix):
    """SPLADE-like weights, whose mass sits in each impact-sorted row's
    first terms: the stage-1 prefix only decides which documents are
    scored again, and every returned score is the exact dot product."""
    rng = np.random.default_rng(17)
    docs, queries = _pairs(rng, 300, v=2048, lo=10, hi=60, decay=0.3), \
        _pairs(rng, 5, v=2048, lo=4, hi=20, decay=0.3)
    ours, theirs = _both(docs, "device")
    ids, scores = ours.search_vectors(queries, k=7, candidates=64, prefix=prefix)
    _same((ids, scores), theirs.search_vectors(queries, k=7, candidates=64, prefix=prefix))
    dense = np.zeros((len(docs), 2048), np.float32)
    for i, (idx, val) in enumerate(docs):
        dense[i, idx] = val
    for q, (idx, val) in enumerate(queries):
        np.testing.assert_allclose(scores[q], dense[ids[q]][:, idx] @ val, rtol=RTOL)


def test_candidates_need_the_device_backend(corpus):
    docs, queries = corpus
    ours, theirs = _both(docs, "host")
    for index in (ours, theirs):
        with pytest.raises(ValueError, match="device index"):
            index.search_vectors(queries, k=3, candidates=16)


def test_nnz_width_keeps_the_heaviest_terms():
    idx = np.arange(10, dtype=np.int32)
    val = np.linspace(1.0, 0.1, 10).astype(np.float32)[::-1].copy()
    ours, theirs = _both([(idx, val)], "device", nnz_width=4)
    for q in ([(np.array([0, 1], np.int32), np.ones(2, np.float32))],
              [(np.array([8, 9], np.int32), np.ones(2, np.float32))]):
        _same(ours.search_vectors(q, k=1), theirs.search_vectors(q, k=1))
    assert ours.search_vectors([(np.array([0], np.int32), np.ones(1, np.float32))],
                               k=1)[1][0, 0] == 0.0
    np.testing.assert_array_equal(ours._rows.bufs[0]["idx"][0].numpy(), [9, 8, 7, 6])


@pytest.mark.parametrize("backend", ["device", "host"])
def test_empty_documents_errors_and_terms_past_the_vocabulary(backend):
    ours = SparseIndex(device="cpu" if backend == "device" else False)
    theirs = jsparse.SparseIndex(device=backend == "device")
    q = [(np.array([3], np.int32), np.array([1.0], np.float32))]
    for index in (ours, theirs):
        with pytest.raises(RuntimeError, match="empty index"):
            index.search_vectors(q, k=1)
        with pytest.raises(ValueError, match="negative term id"):
            index.add_vectors([(np.array([-1, 3], np.int32), np.array([1.0, 2.0], np.float32))])
        with pytest.raises(ValueError, match="aligned"):
            index.add_vectors([(np.array([1, 3], np.int32), np.array([1.0], np.float32))])
        index.add_vectors([(np.zeros(0, np.int32), np.zeros(0, np.float32)),
                           (np.array([3], np.int32), np.array([2.0], np.float32))])
        with pytest.raises(ValueError, match="k must be positive"):
            index.search_vectors(q, k=0)
    _same(ours.search_vectors(q, k=2), theirs.search_vectors(q, k=2))
    assert ours.search_vectors(q, k=2)[0].tolist() == [[1, 0]]
    far = [(np.array([3, 999, 5000], np.int32), np.array([1.0, 5.0, 7.0], np.float32))]
    _same(ours.search_vectors(far, k=1), theirs.search_vectors(far, k=1))
    assert ours.search_vectors(far, k=1)[1][0, 0] == 2.0


def test_a_query_term_given_twice_adds_on_the_device_backend(corpus):
    docs, _ = corpus
    ours, theirs = _both(docs, "device")
    idx, val = docs[11]
    q = [(np.concatenate([idx[:5], idx[:2]]), np.concatenate([val[:5], val[:2]]))]
    _same(ours.search_vectors(q, k=5), theirs.search_vectors(q, k=5))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_files_load_across_the_packages(corpus, tmp_path, writer):
    """The CSR triple and n_vocab: a file saved by either package loads in
    the other, with equal results."""
    docs, queries = corpus
    ours, theirs = _both(docs[:40], "device")
    src, dst = (ours, SparseIndex(device="cpu")) if writer == "port" else \
        (theirs, SparseIndex(device="cpu"))
    other = jsparse.SparseIndex(device=True) if writer == "port" else None
    path = str(tmp_path / "sparse.npz")
    src.save(path)
    with np.load(path) as data:
        assert sorted(data.files) == ["indices", "indptr", "n_vocab", "values"]
    if other is not None:
        assert other.load(path) == 40
        _same(other.search_vectors(queries, k=5), ours.search_vectors(queries, k=5))
    else:
        assert dst.load(path) == 40
        _same(dst.search_vectors(queries, k=5), theirs.search_vectors(queries, k=5))
        assert dst.n_vocab == theirs.n_vocab


def test_an_empty_index_saves_and_loads(tmp_path):
    path = str(tmp_path / "empty.npz")
    SparseIndex(device="cpu").save(path)
    assert jsparse.SparseIndex().load(path) == 0
    assert SparseIndex(device=False).load(path) == 0


@pytest.fixture(scope="module")
def splade_pair(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gguf") / "tiny-splade.gguf")
    make_test_model(path, "tiny-splade", "f32", seed=0)
    return Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)


DOCS = ["the dog sat", "hello world", "partly cloudy skies", "hello world", "a cat"]


@pytest.mark.parametrize("candidates", [None, 2, 5])
def test_engine_backed_index_matches_jax(splade_pair, candidates):
    ours, theirs = splade_pair
    a, b = SparseIndex(ours, k_encode=64), jsparse.SparseIndex(theirs, k_encode=64)
    assert a.device and a.torch_device == ours.device and a._rows.bufs[0]["idx"] is None
    assert a.add(DOCS) == b.add(DOCS) == 5
    didx = a._rows.bufs[0]["idx"]
    assert didx.device == ours.device and didx.shape[1] == 64
    got = a.search(["hello world", "sat dog"], k=3, candidates=candidates)
    _same(got, b.search(["hello world", "sat dog"], k=3, candidates=candidates))
    assert got[0][0, :2].tolist() == [1, 3]


def test_engine_backed_index_scores_equal_brute_force(splade_pair):
    ours, _ = splade_pair
    index = SparseIndex(ours, k_encode=64)
    index.add(DOCS)
    ids, scores = index.search(["hello world"], k=5)
    pairs = ours.encode_sparse(DOCS + ["hello world"], k=64)
    dense = np.zeros((6, ours.config.n_vocab), np.float32)
    for i, (idx, val) in enumerate(pairs):
        dense[i, idx] = val
    want = dense[:5] @ dense[5]
    np.testing.assert_allclose(scores[0], want[ids[0]], rtol=RTOL)
    assert np.all(np.diff(scores[0]) <= 0)


def test_a_model_without_mlm_head_or_a_mesh_is_refused(tmp_path):
    path = str(tmp_path / "tiny.gguf")
    make_test_model(path, "tiny", "f32", seed=0)
    with pytest.raises(ValueError, match="no MLM head"):
        SparseIndex(Engine.from_gguf(path, device="cpu"))
    from embedding_cpp_tpu_torch.parallel.mesh import make_mesh

    # a mesh shards the device backend's rows: the host backend refuses one
    with pytest.raises(ValueError, match="mesh sharding requires device=True"):
        SparseIndex(mesh=make_mesh(dp=2, tp=1, devices=["cpu", "cpu"]))
    assert not SparseIndex().device and SparseIndex(device="cpu").torch_device == \
        torch.device("cpu")


@pytest.mark.parametrize("seed", range(5))
def test_rrf_fuse_is_the_references_bit_for_bit(seed):
    """Random rankings of different widths with -1 slots and ties."""
    rng = np.random.default_rng(seed)
    rankings = []
    for width in (5, 8, 3):
        r = np.stack([rng.permutation(12)[:width] for _ in range(4)]).astype(np.int32)
        r[rng.random(r.shape) < 0.2] = -1
        rankings.append(r)
    for k in (1, 4, 20):
        for c in (60.0, 1.0):
            got, ref = rrf_fuse(rankings, k, c), jsparse.rrf_fuse(rankings, k, c)
            assert got[0].tobytes() == ref[0].tobytes() and got[1].tobytes() == ref[1].tobytes()


def test_rrf_fuse_orders_ties_by_id_and_pads():
    a = np.array([[2, 0, 1]], np.int32)
    b = np.array([[0, 2, -1]], np.int32)
    ids, scores = rrf_fuse([a, b], k=4, c=60.0)
    assert ids.tolist() == [[0, 2, 1, -1]] and scores[0, 3] == 0.0
    np.testing.assert_allclose(scores[0, :3], [1 / 61 + 1 / 62] * 2 + [1 / 63], rtol=1e-6)
    for bad, match in ((([a], 0), "k must be positive"), (([], 1), "no rankings"),
                       (([a, np.zeros((2, 3), np.int32)], 1), "query count")):
        with pytest.raises(ValueError, match=match):
            rrf_fuse(*bad)
