"""The port's MaxSim index (`runtime/maxsim_search.py`) against the JAX
package's `MaxSimIndex`, over tiny GGUFs written by the JAX package: a
plain model (`tiny`), ColBERT (`tiny-colbert`: [D]/[Q] framing, [MASK]
query augmentation, the punctuation skiplist) and nomic (`tiny-nomic`,
whose states depend on the padded length: the ingest batches as the
reference's `_padded_chunks`).

Ids equal, including the order of equal scores (each document three times,
so copies straddle k); scores within 2e-5 (f32 corpus) or 1e-5 (bf16
corpus, whose rows both packages round the same way).  Exact search, the
two-stage candidates mode at several C (equal to exact at C >= n),
`add_token_vectors`, the pooled rows refreshed by every commit (mixed `add`
and `add_token_vectors`, then candidates at C >= n equal to exact),
`doc_maxlen`, the padding contract, refusals, growth, and `.npz` files
loaded across the packages both ways; exact scores equal
`Engine.maxsim_tokens` on the same query and documents.
"""
import numpy as np
import pytest
import torch

from embedding_cpp_tpu.cli.make_test_model import make_test_model
from embedding_cpp_tpu.runtime import maxsim_search as jmaxsim
from embedding_cpp_tpu.runtime.engine import Engine as JEngine
from embedding_cpp_tpu_torch import Engine
from embedding_cpp_tpu_torch.runtime.maxsim_search import MaxSimIndex

ATOL = {"float32": 2e-5, "bfloat16": 1e-5}
DOCS = ["paris is the capital of france.", "the quick brown fox; the lazy dog!",
        "hello world", "a b c d e f g h i j k l m n o p q r s t u v w x y z"] * 3
QUERIES = ["capital of france", "lazy fox", "paris is the capital of france."]


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    cache = {}

    def get(preset):
        if preset not in cache:
            path = str(tmp_path_factory.mktemp("gguf") / f"{preset}.gguf")
            make_test_model(path, preset, "f32", seed=0)
            cache[preset] = Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)
        return cache[preset]

    return get


def _both(pair, dtype="float32", **kw):
    ours, theirs = pair
    return MaxSimIndex(ours, dtype=dtype, **kw), jmaxsim.MaxSimIndex(theirs, dtype=dtype, **kw)


def _same(got, ref, atol):
    (ids, scores), (ids_ref, scores_ref) = got, ref
    np.testing.assert_array_equal(ids, ids_ref)
    assert ids.dtype == np.int32 and scores.dtype == np.float32
    fin = np.isfinite(scores_ref)
    np.testing.assert_array_equal(np.isfinite(scores), fin)
    np.testing.assert_allclose(scores[fin], scores_ref[fin], rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset", ["tiny", "tiny-colbert", "tiny-nomic"])
def test_text_search_matches_jax(pairs, preset, dtype):
    ours, theirs = _both(pairs(preset), dtype, doc_maxlen=24)
    assert ours.add(DOCS) == theirs.add(DOCS) == 12
    for k in (2, 5, 12, 20):
        _same(ours.search(QUERIES, k=k), theirs.search(QUERIES, k=k), ATOL[dtype])
    ids, _ = ours.search(QUERIES[2:], k=4)
    assert ids[0, :3].tolist() == [0, 4, 8]  # the three copies, lower id first


@pytest.mark.parametrize("c", [2, 5, 12, 100])
@pytest.mark.parametrize("preset", ["tiny", "tiny-colbert"])
def test_candidates_mode_matches_jax(pairs, preset, c):
    ours, theirs = _both(pairs(preset), doc_maxlen=24)
    ours.add(DOCS)
    theirs.add(DOCS)
    got = ours.search(QUERIES, k=6, candidates=c)
    _same(got, theirs.search(QUERIES, k=6, candidates=c), ATOL["float32"])
    if c >= 12:
        _same(got, ours.search(QUERIES, k=6), 0)


def _states(rng, n, e, lo=3, hi=20):
    return [rng.normal(size=(int(rng.integers(lo, hi)), e)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_token_vectors_match_jax(pairs, dtype):
    """add_token_vectors, exact and candidates: rows cut to doc_maxlen 12,
    and three equal documents."""
    ours, theirs = _both(pairs("tiny"), dtype, doc_maxlen=12)
    rng = np.random.default_rng(0)
    states = _states(rng, 30, 64)
    states[20] = states[25] = states[4]
    assert ours.add_token_vectors(states) == theirs.add_token_vectors(states) == 30
    queries = [states[4][:5], rng.normal(size=(7, 64)).astype(np.float32)]
    for k in (2, 5):
        _same(ours.search_token_vectors(queries, k=k),
              theirs.search_token_vectors(queries, k=k), ATOL[dtype])
        for c in (3, 10, 45):
            _same(ours.search_token_vectors(queries, k=k, candidates=c),
                  theirs.search_token_vectors(queries, k=k, candidates=c), ATOL[dtype])
    assert ours.search_token_vectors(queries, k=3)[0][0].tolist() == [4, 20, 25]


@pytest.mark.parametrize("order", ["add_first", "vectors_first"])
def test_every_commit_refreshes_the_pooled_rows(pairs, order):
    """add() and add_token_vectors() mixed: candidates at C >= n equal
    exact search, which needs every document's pooled row (a commit that
    left its pooled rows stale would drop documents from stage 1)."""
    ours = MaxSimIndex(pairs("tiny")[0], dtype="float32", doc_maxlen=24)
    rng = np.random.default_rng(1)
    states = _states(rng, 10, 64)
    steps = [lambda: ours.add(DOCS), lambda: ours.add_token_vectors(states)]
    for step in steps if order == "add_first" else steps[::-1]:
        step()
    assert torch.all(torch.linalg.vector_norm(ours._rows.gather(22, "pooled"), dim=1) > 0.5)
    queries = [states[3], rng.normal(size=(6, 64)).astype(np.float32)]
    _same(ours.search_token_vectors(queries, k=22, candidates=22),
          ours.search_token_vectors(queries, k=22), 0)
    _same(ours.search(QUERIES, k=5, candidates=40), ours.search(QUERIES, k=5), 0)


def test_doc_maxlen_cuts_documents_as_the_reference(pairs):
    for preset in ("tiny", "tiny-colbert"):
        ours, theirs = _both(pairs(preset), doc_maxlen=5)
        ours.add(DOCS)
        theirs.add(DOCS)
        np.testing.assert_array_equal(ours._rows.gather(12, "cmask").numpy(),
                                      np.asarray(theirs._cmask[:12]))
        assert ours._rows.bufs[0]["cmask"].shape[1] == 5
        _same(ours.search(QUERIES, k=4), theirs.search(QUERIES, k=4), ATOL["float32"])


def test_colbert_skiplist_leaves_punctuation_out(pairs):
    """ColBERT documents: the punctuation ids are masked out of scoring,
    as in the reference's index; a plain model keeps every token."""
    ours, theirs = _both(pairs("tiny-colbert"))
    ours.add(DOCS[:2])
    theirs.add(DOCS[:2])
    mask = ours._rows.gather(2, "cmask").numpy()
    np.testing.assert_array_equal(mask, np.asarray(theirs._cmask[:2]))
    framed = pairs("tiny-colbert")[0].colbert_doc_tokens(DOCS[:2], cap=256)
    skip = pairs("tiny-colbert")[0].colbert_skiplist()
    for row, ids in zip(mask, framed):
        assert row.sum() == sum(t not in skip for t in ids) < len(ids)
    plain = MaxSimIndex(pairs("tiny")[0])
    plain.add(DOCS[:1])
    assert plain._rows.gather(1, "cmask")[0].sum() == len(pairs("tiny")[0].tokenize(DOCS[0]))


@pytest.mark.parametrize("preset", ["tiny", "tiny-colbert"])
def test_exact_scores_equal_maxsim_tokens(pairs, preset):
    """An f32 index's exact scores are Engine.maxsim's on the same query
    and documents."""
    engine = pairs(preset)[0]
    index = MaxSimIndex(engine, dtype="float32")
    index.add(DOCS[:4])
    for query in QUERIES:
        ids, scores = index.search([query], k=4)
        want = engine.maxsim(query, DOCS[:4])
        np.testing.assert_allclose(scores[0], want[ids[0]], rtol=1e-5)
        assert sorted(ids[0].tolist()) == [0, 1, 2, 3]


def test_k_past_the_corpus_pads_with_minus_one(pairs):
    ours, theirs = _both(pairs("tiny"))
    ours.add(DOCS[:2])
    theirs.add(DOCS[:2])
    got = ours.search(QUERIES[:1], k=5)
    _same(got, theirs.search(QUERIES[:1], k=5), ATOL["float32"])
    assert got[0][0, 2:].tolist() == [-1] * 3 and np.all(np.isneginf(got[1][0, 2:]))
    got = ours.search(QUERIES[:1], k=5, candidates=1)
    _same(got, theirs.search(QUERIES[:1], k=5, candidates=1), ATOL["float32"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_files_load_across_the_packages(pairs, tmp_path, writer):
    """f16 `token_states` and `token_masks`: a file saved by either package
    loads in the other (doc_maxlen may differ: rows are cut again)."""
    ours, theirs = _both(pairs("tiny-colbert"), doc_maxlen=24)
    ours.add(DOCS)
    theirs.add(DOCS)
    src = ours if writer == "port" else theirs
    path = str(tmp_path / "maxsim.npz")
    src.save(path)
    with np.load(path) as data:
        assert data["token_states"].dtype == np.float16 and data["token_masks"].dtype == bool
    a, b = _both(pairs("tiny-colbert"), doc_maxlen=16)
    assert a.load(path) == b.load(path) == 12
    _same(a.search(QUERIES, k=5), b.search(QUERIES, k=5), ATOL["float32"])


def test_an_empty_index_saves_and_loads(pairs, tmp_path):
    ours, theirs = _both(pairs("tiny"))
    path = str(tmp_path / "empty.npz")
    ours.save(path)
    assert theirs.load(path) == 0 and ours.load(path) == 0


def test_bad_inputs_are_refused_as_the_reference_refuses_them(pairs):
    ours, theirs = _both(pairs("tiny"))
    for index in (ours, theirs):
        with pytest.raises(ValueError, match="index is empty"):
            index.search(["x"], k=1)
        with pytest.raises(ValueError, match="expected"):
            index.add_token_vectors([np.zeros((3, 65), np.float32)])
        with pytest.raises(ValueError, match="no token vectors"):
            index.add_token_vectors([np.zeros((0, 64), np.float32)])
        index.add(DOCS[:2])
        with pytest.raises(ValueError, match="k must be positive"):
            index.search(["x"], k=0)
        with pytest.raises(ValueError, match="query 0"):
            index.search_token_vectors([np.zeros((0, 64), np.float32)])
    for kw in ({"doc_maxlen": 0},):
        with pytest.raises(ValueError, match="doc_maxlen"):
            MaxSimIndex(pairs("tiny")[0], **kw)
    from embedding_cpp_tpu_torch.parallel.mesh import Mesh, make_mesh

    # a mesh of two processes, as the JAX package refuses one
    two = Mesh(make_mesh(dp=1, tp=1, devices=["cpu"]).devices, dp=2, process_count=2)
    with pytest.raises(RuntimeError, match="single-controller only"):
        MaxSimIndex(pairs("tiny")[0], mesh=two)


def test_presized_and_grown_corpora_agree(pairs):
    """capacity= sizes the corpus ahead; adds past it grow it, keeping the
    rows; the tensors live on the engine's device."""
    engine = pairs("tiny")[0]
    pre, grow = MaxSimIndex(engine, capacity=64), MaxSimIndex(engine)
    assert pre._rows.bufs[0]["corpus"].shape[0] == 64 and grow._rows.bufs[0]["corpus"] is None
    for index in (pre, grow):
        for lo in range(0, 12, 5):
            index.add(DOCS[lo: lo + 5])
        assert len(index) == 12
        assert all(t.device == engine.device for t in index._rows.bufs[0].values())
    assert pre._rows.bufs[0]["corpus"].dtype == torch.bfloat16
    assert grow._rows.bufs[0]["corpus"].shape[0] >= 12
    _same(pre.search(QUERIES, k=6), grow.search(QUERIES, k=6), 0)
