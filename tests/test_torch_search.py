"""The port's on-device vector index (`runtime/search.py`) against the JAX
package's `VectorIndex`, both over one tiny f32 GGUF written by the JAX
package (the port on `device="cpu"`).

Ids equal, including the order of equal scores (duplicate documents that
straddle k keep the lower id first, as `lax.top_k` does); scores within
2e-5 for an f32 corpus, and within 1e-5 of the reference's bf16 corpus on
the same vectors (both sum exact bf16 products in f32).  The contracts:
k past the corpus padded with id -1 / score -inf, the shape, empty-index
and MAX_INDEX_ROWS refusals, growth across adds, un-normalized vectors
ranked by cosine, device ingest (also on an int8-output engine and through
packed batches), prompts, `.npz` files loaded across the packages both
ways, and `exact=False`, which the port runs exactly: at these shapes the
reference's `lax.approx_max_k` on the CPU returns the exact top-k too, but
for the order of equal scores.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from embedding_cpp_tpu.cli.make_test_model import make_test_model
from embedding_cpp_tpu.runtime import search as jsearch
from embedding_cpp_tpu.runtime.engine import Engine as JEngine
from embedding_cpp_tpu_torch import Engine
from embedding_cpp_tpu_torch.models import ComputeOptions
from embedding_cpp_tpu_torch.runtime import search as psearch
from embedding_cpp_tpu_torch.runtime.search import MAX_INDEX_ROWS, VectorIndex, select_topk

ATOL = {"float32": 2e-5, "bfloat16": 1e-5}
CORPUS = [f"sentence number {i} about topic {i % 7}" for i in range(40)] + [
    "sentence number 3 about topic 3"] * 3
QUERIES = ["sentence about topic 3", "totally different words here",
           "sentence number 3 about topic 3"]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("gguf") / "tiny-f32.gguf")
    make_test_model(path, "tiny", "f32", seed=0)
    return Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)


def _both(pair, dtype="float32", **kw):
    ours, theirs = pair
    return VectorIndex(ours, dtype=dtype, **kw), jsearch.VectorIndex(theirs, dtype=dtype, **kw)


def _same(got, ref, atol):
    (ids, scores), (ids_ref, scores_ref) = got, ref
    np.testing.assert_array_equal(ids, ids_ref)
    assert ids.dtype == np.int32 and scores.dtype == np.float32
    fin = np.isfinite(scores_ref)
    np.testing.assert_array_equal(np.isfinite(scores), fin)
    np.testing.assert_allclose(scores[fin], scores_ref[fin], rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 5, 43])
def test_text_search_matches_jax(pair, dtype, k):
    """add / search on texts; the three copies of document 3 tie."""
    ours, theirs = _both(pair, dtype)
    assert ours.add(CORPUS) == theirs.add(CORPUS) == len(CORPUS)
    _same(ours.search(QUERIES, k=k), theirs.search(QUERIES, k=k), ATOL[dtype])


def test_text_search_matches_numpy(pair):
    engine = pair[0]
    index = VectorIndex(engine, dtype="float32")
    index.add(CORPUS)
    ids, scores = index.search(QUERIES, k=5)
    sims = engine.encode_queries(QUERIES) @ engine.encode_documents(CORPUS).T
    want = np.argsort(-sims, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_allclose(scores, np.take_along_axis(sims, want, 1), rtol=0, atol=1e-5)


def _vectors(n=60, e=64, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, e)).astype(np.float32)
    return v, rng.normal(size=(5, e)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_duplicates_straddling_k_keep_the_lower_id(pair, dtype, k):
    """Documents 3, 10, 30 and 50 are one vector; a query on it ranks them
    3, 10, 30, 50 and cuts at k wherever k falls among them."""
    v, q = _vectors()
    v[[10, 30, 50]] = v[3]
    q[0] = v[3]
    ours, theirs = _both(pair, dtype)
    ours.add_vectors(v)
    theirs.add_vectors(v)
    got = ours.search_vectors(q, k=k)
    _same(got, theirs.search_vectors(q, k=k), ATOL[dtype])
    assert got[0][0].tolist() == [3, 10, 30, 50][:k]


@pytest.mark.parametrize("k", [1, 10, 60])
def test_bf16_vectors_within_1e5_of_the_reference(pair, k):
    v, q = _vectors(seed=1)
    ours, theirs = _both(pair, "bfloat16")
    ours.add_vectors(v)
    theirs.add_vectors(v)
    _same(ours.search_vectors(q, k=k), theirs.search_vectors(q, k=k), 1e-5)


def test_incremental_add_and_growth(pair):
    """Appends past the corpus buffer keep the earlier rows."""
    ours, theirs = _both(pair)
    for lo in range(0, 43, 9):
        assert ours.add(CORPUS[lo: lo + 9]) == theirs.add(CORPUS[lo: lo + 9])
    v, q = _vectors(n=70)
    assert ours.add_vectors(v) == theirs.add_vectors(v) == 113
    assert ours._rows.bufs[0]["vectors"].shape[0] >= 113 and len(ours) == 113
    _same(ours.search(QUERIES, k=6), theirs.search(QUERIES, k=6), ATOL["float32"])
    _same(ours.search_vectors(q, k=6), theirs.search_vectors(q, k=6), ATOL["float32"])


def test_shape_and_empty_index_refusals(pair):
    ours, theirs = _both(pair)
    for index in (ours, theirs):
        with pytest.raises(ValueError, match="vectors"):
            index.add_vectors(np.zeros((3, 65), np.float32))
        with pytest.raises(ValueError, match="index is empty"):
            index.search(["anything"], k=1)
        assert index.add_vectors(np.zeros((0, 64), np.float32)) == 0


def test_max_index_rows_is_refused_as_the_reference_refuses_it(pair):
    """An add that would pass MAX_INDEX_ROWS raises before anything is
    allocated, in both packages."""
    assert MAX_INDEX_ROWS == jsearch.MAX_INDEX_ROWS == 1 << 24
    ours, theirs = _both(pair)
    v, _ = _vectors(n=2)
    for index in (ours, theirs):
        index.add_vectors(v)
        index._n = MAX_INDEX_ROWS - 1
        with pytest.raises(ValueError, match=f"exceed {MAX_INDEX_ROWS} rows"):
            index.add_vectors(v)
        assert index._n == MAX_INDEX_ROWS - 1
    assert ours._rows.bufs[0]["vectors"].shape[0] == 2


def test_k_past_the_corpus_pads_with_minus_one(pair):
    ours, theirs = _both(pair)
    ours.add(["only one", "and two"])
    theirs.add(["only one", "and two"])
    got = ours.search(["only one"], k=10)
    _same(got, theirs.search(["only one"], k=10), ATOL["float32"])
    ids, scores = got
    assert ids.shape == scores.shape == (1, 10)
    assert set(ids[0, :2]) == {0, 1} and np.all(ids[0, 2:] == -1)
    assert np.all(np.isneginf(scores[0, 2:])) and np.all(np.isfinite(scores[0, :2]))


def test_an_empty_query_batch(pair):
    ours, theirs = _both(pair)
    v, _ = _vectors()
    ours.add_vectors(v)
    theirs.add_vectors(v)
    got = ours.search_vectors(np.zeros((0, 64), np.float32), k=3)
    assert got[0].shape == got[1].shape == (0, 3)
    _same(got, theirs.search_vectors(np.zeros((0, 64), np.float32), k=3), 0)


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_npz_files_load_across_the_packages(pair, tmp_path, writer, dtype):
    """An index saved by either package loads in the other with equal
    results (the file holds f32 `vectors`)."""
    ours, theirs = _both(pair, dtype)
    src, dst = (ours, theirs) if writer == "port" else (theirs, ours)
    src.add(CORPUS[:15])
    path = str(tmp_path / "index.npz")
    src.save(path)
    with np.load(path) as data:
        assert sorted(data.files) == ["vectors"] and data["vectors"].shape == (15, 64)
    assert dst.load(path) == 15
    _same(dst.search(QUERIES, k=4), src.search(QUERIES, k=4), ATOL[dtype])


def test_an_empty_index_saves_and_loads(pair, tmp_path):
    ours, theirs = _both(pair)
    path = str(tmp_path / "empty.npz")
    ours.save(path)
    assert theirs.load(path) == 0 and ours.load(path) == 0 and len(ours) == 0


def test_unnormalized_vectors_rank_by_cosine(pair):
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 64)).astype(np.float32)
    ours, theirs = _both(pair)
    for index in (ours, theirs):
        index.add_vectors(np.stack([a * 1e-3, b * 1e6]))
    got = ours.search_vectors(a[None], k=2)
    _same(got, theirs.search_vectors(a[None], k=2), ATOL["float32"])
    assert got[0][0, 0] == 0 and got[1][0, 0] > 0.999


def test_exact_false_is_exact_and_so_is_the_references_approx_here(pair):
    """`lax.approx_max_k` on the CPU returns the exact top-k at these shapes,
    so the reference's exact=False index agrees id for id with the port's
    (exact either way).  Among equal scores it may pick another of the tied
    ids: there the port keeps `lax.top_k`'s order (the reference's exact
    index), with the same scores."""
    v, q = _vectors(n=200, seed=2)
    scores = jnp.asarray(q @ v.T)
    for k in (1, 10, 200):
        a, b = jax.lax.approx_max_k(scores, k), jax.lax.top_k(scores, k)
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
    ours, theirs = _both(pair, exact=False)
    exact = VectorIndex(pair[0], dtype="float32")
    for index in (ours, theirs, exact):
        index.add_vectors(v)
    _same(ours.search_vectors(q, k=10), theirs.search_vectors(q, k=10), ATOL["float32"])
    _same(ours.search_vectors(q, k=10), exact.search_vectors(q, k=10), 0)
    v[[40, 41]] = v[7]
    ours, theirs = _both(pair, exact=False)
    ref_exact = jsearch.VectorIndex(pair[1], dtype="float32")
    for index in (ours, theirs, ref_exact):
        index.add_vectors(v)
    got, approx = ours.search_vectors(v[7:8], k=2), theirs.search_vectors(v[7:8], k=2)
    _same(got, ref_exact.search_vectors(v[7:8], k=2), ATOL["float32"])
    assert got[0].tolist() == [[7, 40]] and set(approx[0][0]) <= {7, 40, 41}
    np.testing.assert_allclose(got[1], approx[1], rtol=0, atol=ATOL["float32"])


def test_device_ingest_with_an_int8_transfer_engine(pair):
    """An int8-output engine ingests at f32 fidelity (its f32-output
    forward): the corpus equals an f32 engine's, while its encode is int8."""
    engine = pair[0]
    i8 = Engine(engine.params, engine.config, engine.tokenizer, engine.special_ids,
                opts=ComputeOptions(output_dtype="int8"), device="cpu")
    a, b = VectorIndex(i8, dtype="float32"), VectorIndex(engine, dtype="float32")
    a.add(CORPUS[:12])
    b.add(CORPUS[:12])
    torch.testing.assert_close(a._rows.gather(12, "vectors"), b._rows.gather(12, "vectors"),
                               rtol=0, atol=0)
    assert not np.array_equal(i8.encode(CORPUS[:1]), engine.encode(CORPUS[:1]))


def test_device_ingest_matches_the_host_path(pair):
    """add() through packed batches (35 short documents) and plain ones
    equals add_vectors of encode_documents."""
    engine = pair[0]
    dev, host = VectorIndex(engine, dtype="float32"), VectorIndex(engine, dtype="float32")
    dev.add(CORPUS[:5])
    dev.add(CORPUS[5:40])
    assert engine._pack_plan(engine.tokenize_batch(CORPUS[5:40]))
    host.add_vectors(engine.encode_documents(CORPUS[:40]))
    _same(dev.search(QUERIES, k=4), host.search(QUERIES, k=4), 1e-6)


def test_a_model_that_does_not_normalize_is_indexed_as_unit_rows(pair):
    """config.normalize false: the engine returns raw vectors and add()
    makes them unit rows on the device, as the reference does."""
    ours, theirs = pair
    o = Engine(ours.params, dataclasses.replace(ours.config, normalize=False), ours.tokenizer,
               ours.special_ids, device="cpu")
    t = JEngine(theirs.params, dataclasses.replace(theirs.config, normalize=False),
                theirs.tokenizer, theirs.special_ids)
    assert abs(np.linalg.norm(o.encode(CORPUS[:1])) - 1.0) > 1e-3
    a, b = VectorIndex(o, dtype="float32"), jsearch.VectorIndex(t, dtype="float32")
    a.add(CORPUS[:20])
    b.add(CORPUS[:20])
    np.testing.assert_allclose(torch.linalg.vector_norm(a._rows.gather(20, "vectors"), dim=1).numpy(), 1.0,
                               atol=1e-6)
    _same(a.search(QUERIES, k=5), b.search(QUERIES, k=5), ATOL["float32"])


def test_document_and_query_prompts(pair):
    ours, theirs = pair
    prompts = {"query": "query: ", "passage": "passage: "}
    o = Engine(ours.params, ours.config, ours.tokenizer, ours.special_ids, device="cpu",
               prompts=prompts)
    t = JEngine(theirs.params, theirs.config, theirs.tokenizer, theirs.special_ids,
                prompts=prompts)
    a, b = VectorIndex(o, dtype="float32"), jsearch.VectorIndex(t, dtype="float32")
    a.add(CORPUS[:20])
    b.add(CORPUS[:20])
    got = a.search(QUERIES, k=5)
    _same(got, b.search(QUERIES, k=5), ATOL["float32"])
    plain = VectorIndex(ours, dtype="float32")
    plain.add(CORPUS[:20])
    assert not np.allclose(got[1], plain.search(QUERIES, k=5)[1])


def test_a_mesh_is_refused_until_the_distribution_layer(pair):
    """A mesh is not refused (the name is from before the distribution
    layer): a corpus sharded over a 2-slot mesh searches as one device's."""
    from embedding_cpp_tpu_torch.parallel.mesh import make_mesh

    vecs = np.random.default_rng(3).standard_normal((19, 64)).astype(np.float32)
    one = VectorIndex(pair[0], dtype="float32")
    sharded = VectorIndex(pair[0], dtype="float32",
                          mesh=make_mesh(dp=2, tp=1, devices=["cpu", "cpu"]))
    for index in (one, sharded):
        index.add_vectors(vecs)
    assert np.array_equal(sharded.search_vectors(vecs[:4], k=5)[0],
                          one.search_vectors(vecs[:4], k=5)[0])


def test_f32_search_runs_without_tf32_and_restores_the_setting(pair):
    seen = []
    real = psearch.similarity

    def spy(q, corpus):
        seen.append(torch.get_float32_matmul_precision())
        return real(q, corpus)

    v, q = _vectors()
    index = VectorIndex(pair[0], dtype="float32")
    index.add_vectors(v)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    psearch.similarity = spy
    try:
        index.search_vectors(q, k=3)
        assert seen == ["highest"] and torch.get_float32_matmul_precision() == "high"
    finally:
        psearch.similarity = real
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "distinct"])
@pytest.mark.parametrize("n,k", [(300, 1), (300, 7), (50, 50), (4096, 100)])
def test_select_topk_is_lax_top_k(n, k, ties):
    """Equal scores by the lower index, -0.0 below 0.0, ids -1 at -inf;
    without ties at the k-th score only the 2k best are ordered."""
    rng = np.random.default_rng(n + k)
    x = rng.normal(size=(4, n)).astype(np.float32)
    x[:, 9] = -np.inf
    if ties:
        x[:, 5] = x[:, 20] = x[:, 30] = np.sort(x[0])[-max(k - 1, 1)]
        x[:, 7], x[:, 8] = 0.0, -0.0
        x[1] = np.round(x[1])
        x[2] = 0.0
    s, i = select_topk(torch.from_numpy(x), k)
    rs, ri = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(i.numpy(), np.where(np.isfinite(rs), ri, -1))


def test_concurrent_adds_and_searches_lose_no_row(pair):
    """More threads than cores add blocks and search at once (a short
    switch interval): every block lands whole, once, and each vector finds
    itself."""
    import concurrent.futures
    import os
    import sys

    workers = (os.cpu_count() or 4) + 4
    rng = np.random.default_rng(9)
    blocks = [rng.normal(size=(5, 64)).astype(np.float32) for _ in range(2 * workers)]
    index = VectorIndex(pair[0], dtype="float32")
    index.add_vectors(blocks[0])
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
            adds = [ex.submit(index.add_vectors, b) for b in blocks[1:]]
            searches = [ex.submit(index.search_vectors, blocks[0], 1) for _ in range(workers)]
            totals = [f.result(timeout=60) for f in adds]
            found = [f.result(timeout=60)[0] for f in searches]
    finally:
        sys.setswitchinterval(prev)
    assert len(index) == 5 * len(blocks) and max(totals) == len(index)
    assert all(f[:, 0].tolist() == list(range(5)) for f in found)
    ids, scores = index.search_vectors(np.concatenate(blocks), 1)
    assert sorted(ids[:, 0].tolist()) == list(range(len(index)))
    starts = {int(ids[5 * i, 0]) for i in range(len(blocks))}
    assert all(s % 5 == 0 for s in starts)  # each block's rows stayed together
    np.testing.assert_allclose(scores, 1.0, atol=1e-5)
