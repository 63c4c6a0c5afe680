"""The three retrieval indexes with `mesh=` (runtime/search.py,
sparse_search.py, maxsim_search.py): their corpus rows dp-sharded over CPU
slots, searched in two stages (a top-k in every shard, then a merge that
orders equal scores by the lower id), against the JAX package's mesh
indexes (on the 8 virtual CPU devices of tests/conftest.py) and the port's
single-device ones.

- ids equal, duplicated rows (equal scores) included; f32 scores within
  1e-6, bf16 corpora within 1e-5;
- `.npz` files across mesh shapes and packages both ways;
- the ingest from texts (`add`) through a mesh engine;
- the sparse index's refusals (no device backend, candidates on a mesh);
- MaxSim's candidates mode on a mesh equals one device's, also after a
  commit that follows a search (every commit refreshes the pooled rows,
  where the JAX package's mesh branch leaves them stale); a multi-process
  mesh is refused, as the JAX package refuses it.
"""
import numpy as np
import pytest
from test_torch_families import _pconfig

from embedding_cpp_tpu.models.bert import ComputeOptions as JOpts
from embedding_cpp_tpu.models.config import BertConfig as JConfig
from embedding_cpp_tpu.parallel import mesh as jmesh
from embedding_cpp_tpu.runtime.engine import Engine as JEngine
from embedding_cpp_tpu.runtime.maxsim_search import MaxSimIndex as JMaxSimIndex
from embedding_cpp_tpu.runtime.search import VectorIndex as JVectorIndex
from embedding_cpp_tpu.runtime.sparse_search import SparseIndex as JSparseIndex
from embedding_cpp_tpu_torch.models import ComputeOptions
from embedding_cpp_tpu_torch.parallel.mesh import Mesh, make_mesh
from embedding_cpp_tpu_torch.runtime.engine import Engine
from embedding_cpp_tpu_torch.runtime.maxsim_search import MaxSimIndex
from embedding_cpp_tpu_torch.runtime.search import VectorIndex, unit
from embedding_cpp_tpu_torch.runtime.sparse_search import SparseIndex

JCFG = JConfig(n_vocab=300, n_ctx=64, n_embd=64, n_layer=2, n_head=4, n_ff=128,
               mlm_head=True, name="mesh-search")
TEXTS = [f"document {i} about " + " ".join(["cats", "dogs", "birds", "fish"][: 1 + i % 4])
         for i in range(23)]


@pytest.fixture(scope="module")
def env(eight_devices):
    jeng = JEngine.synthetic(JCFG, "q4_0", opts=JOpts(dtype="float32"))
    eng = Engine.synthetic(_pconfig(JCFG), "q4_0", opts=ComputeOptions(dtype="float32"),
                           device="cpu")
    vecs = np.random.default_rng(7).standard_normal((41, 64)).astype(np.float32)
    vecs[[9, 30]] = vecs[4]  # equal scores: ordered by the lower id
    return dict(jeng=jeng, eng=eng, vecs=vecs, q=vecs[[0, 4, 11, 39]].copy(),
                jmesh=jmesh.make_mesh(dp=4, tp=2, devices=eight_devices),
                mesh=make_mesh(dp=4, tp=2, devices=["cpu"] * 8),
                mesh3=make_mesh(dp=3, tp=1, devices=["cpu"] * 3))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-5)])
def test_vector_index_on_a_mesh(env, dtype, tol, tmp_path):
    ref = JVectorIndex(env["jeng"], dtype=dtype, mesh=env["jmesh"])
    ref.add_vectors(env["vecs"])
    ri, rs = ref.search_vectors(env["q"], k=7)
    one = VectorIndex(env["eng"], dtype=dtype)
    one.add_vectors(env["vecs"])
    oi, os_ = one.search_vectors(env["q"], k=7)
    for mesh in (env["mesh"], env["mesh3"]):
        idx = VectorIndex(env["eng"], dtype=dtype, mesh=mesh)
        idx.add_vectors(env["vecs"][:17])
        idx.add_vectors(env["vecs"][17:])
        i, s = idx.search_vectors(env["q"], k=7)
        assert np.array_equal(i, ri) and np.array_equal(i, oi)
        np.testing.assert_allclose(s, rs, atol=tol)
        np.testing.assert_allclose(s, os_, atol=tol)
        assert idx.search_vectors(env["q"], k=60)[0][:, 41:].max() == -1
    # files across mesh shapes and packages
    idx.save(tmp_path / "mesh3.npz")
    for other in (VectorIndex(env["eng"], dtype=dtype, mesh=env["mesh"]),
                  VectorIndex(env["eng"], dtype=dtype),
                  JVectorIndex(env["jeng"], dtype=dtype, mesh=env["jmesh"])):
        assert other.load(str(tmp_path / "mesh3.npz")) == 41
        assert np.array_equal(other.search_vectors(env["q"], k=7)[0], ri)
    ref.save(str(tmp_path / "jax.npz"))
    back = VectorIndex(env["eng"], dtype=dtype, mesh=env["mesh3"])
    assert back.load(str(tmp_path / "jax.npz")) == 41
    assert np.array_equal(back.search_vectors(env["q"], k=7)[0], ri)


def test_vector_index_ingests_texts_through_a_mesh_engine(env):
    mesh_eng = Engine.synthetic(_pconfig(JCFG), "q4_0", opts=ComputeOptions(dtype="float32"),
                                mesh=make_mesh(dp=2, tp=2, devices=["cpu"] * 4))
    one = VectorIndex(env["eng"], dtype="float32")
    one.add(TEXTS)
    idx = VectorIndex(mesh_eng, dtype="float32", mesh=mesh_eng.mesh)
    idx.add(TEXTS[:10])
    idx.add(TEXTS[10:])
    q = ["cats and dogs", "fish"]
    ri, rs = one.search(q, k=5)
    i, s = idx.search(q, k=5)
    assert np.array_equal(i, ri)
    np.testing.assert_allclose(s, rs, atol=2e-5)


def test_sparse_index_on_a_mesh(env, tmp_path):
    pairs = env["jeng"].sparse_tokens(env["jeng"].tokenize_batch(TEXTS), k=16)
    pairs = [(np.asarray(i), np.asarray(v)) for i, v in pairs]
    pairs[7] = pairs[3]  # equal scores
    ref = JSparseIndex(env["jeng"], device=True, mesh=env["jmesh"])
    ref.add_vectors(pairs)
    ri, rs = ref.search_vectors(pairs[:5], k=6)
    one = SparseIndex(env["eng"])
    one.add_vectors(pairs)
    for mesh in (env["mesh"], env["mesh3"]):
        idx = SparseIndex(env["eng"], mesh=mesh)
        idx.add_vectors(pairs[:8])
        idx.add_vectors(pairs[8:])
        i, s = idx.search_vectors(pairs[:5], k=6)
        assert np.array_equal(i, ri)
        assert np.array_equal(i, one.search_vectors(pairs[:5], k=6)[0])
        np.testing.assert_allclose(s, rs, atol=1e-6)
    idx.save(str(tmp_path / "sparse.npz"))
    back = JSparseIndex(env["jeng"], device=True, mesh=env["jmesh"])
    assert back.load(str(tmp_path / "sparse.npz")) == len(pairs)
    assert np.array_equal(back.search_vectors(pairs[:5], k=6)[0], ri)
    with pytest.raises(ValueError, match="mesh sharding requires device=True"):
        SparseIndex(env["eng"], device=False, mesh=env["mesh"])
    msg = "two-stage candidates mode is single-device; use exact search on a mesh"
    with pytest.raises(ValueError, match=msg):
        idx.search_vectors(pairs[:2], k=3, candidates=8)
    with pytest.raises(ValueError, match=msg):
        ref.search_vectors(pairs[:2], k=3, candidates=8)


def _docs(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(3, 12)), 64)).astype(np.float32)
            for _ in range(n)]


def test_maxsim_index_on_a_mesh(env, tmp_path):
    docs = _docs(29, 0)
    docs[11] = docs[2]  # equal scores
    queries = [d[:4] for d in docs[:3]] + _docs(2, 9)
    ref = JMaxSimIndex(env["jeng"], dtype="float32", doc_maxlen=16, mesh=env["jmesh"])
    ref.add_token_vectors(docs)
    ri, rs = ref.search_token_vectors(queries, k=6)
    one = MaxSimIndex(env["eng"], dtype="float32", doc_maxlen=16)
    one.add_token_vectors(docs)
    idx = MaxSimIndex(env["eng"], dtype="float32", doc_maxlen=16, mesh=env["mesh3"])
    idx.add_token_vectors(docs[:13])
    idx.add_token_vectors(docs[13:])
    i, s = idx.search_token_vectors(queries, k=6)
    assert np.array_equal(i, ri) and np.array_equal(i, one.search_token_vectors(queries, k=6)[0])
    np.testing.assert_allclose(s, rs, atol=1e-5)
    # candidates mode, then a commit after the search: the pooled rows follow
    for k in (one, idx):
        k.search_token_vectors(queries, k=4, candidates=6)
        k.add_token_vectors(_docs(9, 3))
    ci, cs = idx.search_token_vectors(queries, k=4, candidates=6)
    oi, os_ = one.search_token_vectors(queries, k=4, candidates=6)
    assert np.array_equal(ci, oi)
    np.testing.assert_allclose(cs, os_, atol=1e-6)
    n = len(idx)
    stored = idx._rows.gather(n, "corpus").float() * idx._rows.gather(n, "cmask")[..., None]
    np.testing.assert_allclose(idx._rows.gather(n, "pooled").numpy(),
                               unit(stored.sum(dim=1)).numpy(), atol=1e-6)
    idx.save(str(tmp_path / "maxsim.npz"))
    back = MaxSimIndex(env["eng"], dtype="float32", doc_maxlen=16, mesh=env["mesh"])
    assert back.load(str(tmp_path / "maxsim.npz")) == n
    assert np.array_equal(back.search_token_vectors(queries, k=6)[0],
                          idx.search_token_vectors(queries, k=6)[0])


def test_maxsim_index_refuses_a_multiprocess_mesh(env):
    m = env["mesh"]
    two = Mesh(m.devices[:2], dp=4, process_index=0, process_count=2)
    with pytest.raises(RuntimeError, match="single-controller only"):
        MaxSimIndex(env["eng"], mesh=two)


@pytest.mark.parametrize("dp", [1, 3])
def test_an_append_by_slices_writes_what_scattered_ids_write(dp):
    """`ShardedRows.put` of a range (by slices, every shard a strided run)
    and of the same rows as shuffled ids (`index_copy_`) give the same
    shards, and `gather` reads the rows back in global order."""
    import torch

    from embedding_cpp_tpu_torch.runtime.search import ShardedRows

    mesh = make_mesh(dp=dp, tp=1, devices=["cpu"] * dp)
    fields = {"v": ((4,), torch.float32), "m": ((), torch.bool)}
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal((23, 4)).astype(np.float32))
    m = torch.from_numpy(rng.random(23) > 0.5)
    by_range, by_ids = ShardedRows(mesh, fields), ShardedRows(mesh, fields)
    by_range.put(range(0, 5), v=v[:5], m=m[:5])
    by_range.put(range(5, 23), v=v[5:], m=m[5:])
    perm = rng.permutation(23)
    by_ids.put(torch.from_numpy(perm), v=v[perm], m=m[perm])
    for a, b in zip(by_range.bufs, by_ids.bufs):
        for name in fields:
            n = min(len(a[name]), len(b[name]))
            assert torch.equal(a[name][:n], b[name][:n])
    assert torch.equal(by_range.gather(23, "v"), v) and torch.equal(by_range.gather(23, "m"), m)
