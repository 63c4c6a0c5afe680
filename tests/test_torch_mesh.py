"""The port's meshes and weight shards (`parallel/mesh.py`,
`parallel/sharding.py`) against the JAX package's, and the Engine on a
mesh against the JAX Engine on a mesh of the same shape (the JAX side on
the 8 virtual CPU devices of tests/conftest.py, the port on CPU slots).

- `make_mesh` and `_check_divisibility` raise the JAX package's errors;
  with no card and no `devices` the port raises instead of taking the CPU;
- every weight's tp shard, in every slot, is byte for byte the addressable
  shard that `param_pspecs` + `device_put` give on the JAX mesh (f32, Q4_0,
  Q4_1, Q8_0; BERT, MPNet, gated T5, nomic), dp replicas on one device
  share one copy;
- the launch counters stay exact when shard threads count at once;
- the Engine: its row buckets, packed rows in multiples of dp, f32 and
  int8 output, packed and plain batches, the compact gather of a padded
  batch, `score_pairs`, `sparse_tokens` and token states within 2e-5 (int8:
  one code step of each row, its scale max|x| / 127) of the JAX mesh Engine; `embed_tokens_device` refuses
  int8 on a mesh; `from_gguf(mesh=)`.
"""
import dataclasses
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec
from test_torch_families import _bridge, _pconfig

from embedding_cpp_tpu.gguf import GGUFFileType
from embedding_cpp_tpu.models.bert import ComputeOptions as JOpts
from embedding_cpp_tpu.models.config import BertConfig as JConfig
from embedding_cpp_tpu.models.params import random_params as jax_random_params
from embedding_cpp_tpu.parallel import mesh as jmesh
from embedding_cpp_tpu.parallel import sharding as jsharding
from embedding_cpp_tpu.runtime.batching import pack_segments as jax_pack_segments
from embedding_cpp_tpu.runtime.engine import Engine as JEngine
from embedding_cpp_tpu_torch.models import ComputeOptions
from embedding_cpp_tpu_torch.ops import dispatch
from embedding_cpp_tpu_torch.ops.qtensor import QTensor
from embedding_cpp_tpu_torch.parallel import mesh as pmesh
from embedding_cpp_tpu_torch.parallel import sharding
from embedding_cpp_tpu_torch.parallel.mesh import make_mesh
from embedding_cpp_tpu_torch.runtime.engine import Engine

ATOL, RTOL = 2e-5, 1e-4
JCFG = JConfig(n_vocab=256, n_ctx=64, n_embd=128, n_layer=2, n_head=4, n_ff=256,
               name="mesh-test")
OPTS = ComputeOptions(dtype="float32")


@pytest.mark.parametrize("dp,tp", [(None, 3), (0, 1), (3, 3), (1, 0), (9, 1), (None, 8),
                                   (2, 4)])
def test_make_mesh_checks_as_the_jax_package(eight_devices, dp, tp):
    def outcome(fn):
        try:
            m = fn()
        except (ValueError, ZeroDivisionError) as e:
            return type(e), str(e)
        return dict(m.shape)

    ref = outcome(lambda: jmesh.make_mesh(dp=dp, tp=tp, devices=eight_devices))
    got = outcome(lambda: make_mesh(dp=dp, tp=tp, devices=["cpu"] * 8))
    assert got == ref


def test_make_mesh_grid_and_repeated_devices():
    m = make_mesh(dp=2, tp=2, devices=["cpu"] * 4)
    assert m.shape == {"dp": 2, "tp": 2} and m.devices.shape == (2, 2)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert (m.local_dp, m.dp_offset, m.multiprocess) == (2, 0, False)


def test_make_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(tp=2)


@pytest.mark.parametrize("field,value,tp", [("n_head", 2, 4), ("n_embd", 96, 2),
                                            ("n_ff", 160, 2), ("n_head", 4, 1)])
def test_divisibility_errors_as_the_jax_package(field, value, tp):
    jcfg = dataclasses.replace(JCFG, **{field: value})

    def outcome(fn):
        try:
            fn(jcfg if fn is jsharding._check_divisibility else _pconfig(jcfg), tp)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(sharding._check_divisibility) == outcome(jsharding._check_divisibility)


CONFIGS = {
    "bert": JCFG,
    "mpnet": dataclasses.replace(JCFG, n_token_types=0, arch="mpnet", pos_offset=2,
                                 rel_attn_buckets=32, name="mesh-mpnet"),
    "t5-gated": dataclasses.replace(JCFG, n_token_types=0, arch="t5", layer_norm_eps=1e-6,
                                    rel_attn_buckets=32, n_head_dim=32, ffn_act="gelu_tanh",
                                    ffn_gated=True, name="mesh-t5"),
    "nomic": dataclasses.replace(JCFG, arch="nomic-bert", rope_theta=1000.0,
                                 rope_scaling_factor=2.0, rope_max_trained=32, ffn_act="silu",
                                 ffn_gated=True, attn_bias=False, ffn_bias=False,
                                 name="mesh-nomic"),
}
FTYPES = {"f32": GGUFFileType.ALL_F32, "q4_0": GGUFFileType.MOSTLY_Q4_0,
          "q4_1": GGUFFileType.MOSTLY_Q4_1, "q8_0": GGUFFileType.MOSTLY_Q8_0}


def _leaf(tree, path):
    for key in path:
        name = getattr(key, "key", getattr(key, "name", None))
        tree = tree[name] if isinstance(tree, dict) else getattr(tree, name)
    return tree


@pytest.mark.parametrize("ftype", sorted(FTYPES))
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4)])
def test_every_shard_is_the_jax_shard_byte_for_byte(eight_devices, config, ftype, dp, tp):
    jcfg = CONFIGS[config]
    jparams = jax_random_params(jcfg, FTYPES[ftype], seed=1)
    jm = jmesh.make_mesh(dp=dp, tp=tp, devices=eight_devices)
    specs = jsharding.param_pspecs(jparams, jcfg, tp)
    placed = jax.device_put(jparams, jax.tree.map(
        lambda s: NamedSharding(jm, s), specs, is_leaf=lambda x: isinstance(x, PartitionSpec)))
    sp = sharding.shard_params(_bridge(jparams), _pconfig(jcfg),
                               make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp)))
    leaves = jax.tree_util.tree_flatten_with_path(placed)[0]
    assert leaves
    for path, arr in leaves:
        shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for d in range(dp):
            for r in range(tp):
                want = shards[jm.devices[d, r]]
                got = _leaf(sp[d, r], path).numpy()
                assert got.dtype == want.dtype and got.shape == want.shape, path
                assert got.tobytes() == want.tobytes(), path
    # dp replicas on one device share one copy; every QTensor's logical shape
    q = sp[0, 1]["layers"]["o_w"]
    assert sp[0, 1] is sp[dp - 1, 1]
    if isinstance(q, QTensor):
        assert q.shape == (jcfg.n_embd // tp, jcfg.n_embd)


def test_launch_counters_stay_exact_across_threads():
    """More threads than cores, switching every microsecond: a lost update
    of a read-modify-write would show in the total."""
    def fn():
        pass

    fn.launches = 0
    n_threads = 2 * (os.cpu_count() or 4)

    def bump():
        for _ in range(5000):
            dispatch.count(fn)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert fn.launches == 5000 * n_threads


def test_mesh_repr_names_its_slots():
    assert "dp=1, tp=2" in repr(pmesh.make_mesh(dp=1, tp=2, devices=["cpu", "cpu"]))


# --- the Engine on a mesh ---------------------------------------------------------
ECFG = dataclasses.replace(JCFG, n_labels=1, mlm_head=True, name="mesh-engine")
LISTS = [[2] + np.random.default_rng(i).integers(4, 256, size=n).tolist() + [3]
         for i, n in enumerate([5, 9, 3, 30, 12, 7] * 7)]


@pytest.fixture(scope="module")
def engines(eight_devices):
    jm = jmesh.make_mesh(dp=4, tp=2, devices=eight_devices)
    m = make_mesh(dp=4, tp=2, devices=["cpu"] * 8)
    out = {}
    for out_dtype in ("float32", "int8"):
        jopts = JOpts(dtype="float32", output_dtype=out_dtype)
        opts = ComputeOptions(dtype="float32", output_dtype=out_dtype)
        out[out_dtype] = (JEngine.synthetic(ECFG, "q4_0", opts=jopts, mesh=jm,
                                            batch_buckets=(1, 2, 8, 64)),
                          Engine.synthetic(_pconfig(ECFG), "q4_0", opts=opts, mesh=m,
                                           batch_buckets=(1, 2, 8, 64)))
    return out


def test_engine_mesh_buckets_and_packed_rows(engines):
    jeng, eng = engines["float32"]
    assert eng.batch_buckets == jeng.batch_buckets == (8, 64)
    from embedding_cpp_tpu_torch.runtime.batching import pack_segments

    lists = LISTS[:35]
    ours = pack_segments(lists, list(range(35)), 0, seq_len=64, n_seg=8, row_multiple=4)
    ref = jax_pack_segments(lists, list(range(35)), 0, seq_len=64, n_seg=8, row_multiple=4)
    assert [b.ids.shape for b in ours] == [b.ids.shape for b in ref]
    assert all(b.ids.shape[0] % 4 == 0 for b in ours)
    for a, b in zip(ours, ref):
        assert np.array_equal(a.ids, b.ids) and np.array_equal(a.seg, b.seg)


@pytest.mark.parametrize("out_dtype", ["float32", "int8"])
@pytest.mark.parametrize("packing", ["auto", "never"])
def test_engine_mesh_embeds_as_the_jax_mesh_engine(engines, out_dtype, packing):
    jeng, eng = engines[out_dtype]
    jeng.packing = eng.packing = packing
    try:
        got, ref = eng.embed_tokens(LISTS), jeng.embed_tokens(LISTS)
        # three rows of a padded plain batch: the compact gather
        got3, ref3 = eng.embed_tokens(LISTS[:3]), jeng.embed_tokens(LISTS[:3])
    finally:
        jeng.packing = eng.packing = "auto"
    for g, r in ((got, ref), (got3, ref3)):
        if out_dtype == "float32":
            np.testing.assert_allclose(g, r, atol=ATOL, rtol=RTOL)
            continue
        # one code step of each row: its int8 scale, max|x| / 127
        step = np.abs(r).max(axis=1, keepdims=True) / 127
        assert np.all(np.abs(g - r) <= step * (1 + RTOL) + ATOL), np.abs(g - r).max()


def test_engine_mesh_scores_sparse_and_token_states(engines):
    jeng, eng = engines["float32"]
    pairs = [("a query about cats", "a passage about dogs and cats"),
             ("hello", "world of words"), ("x", "y z")]
    np.testing.assert_allclose(eng.score_pairs(pairs), jeng.score_pairs(pairs),
                               atol=ATOL, rtol=RTOL)
    ours, ref = eng.sparse_tokens(LISTS[:6], k=16), jeng.sparse_tokens(LISTS[:6], k=16)
    for (oi, ov), (ri, rv) in zip(ours, ref):
        assert set(oi.tolist()) == set(np.asarray(ri).tolist())
        np.testing.assert_allclose(np.sort(ov), np.sort(np.asarray(rv)), atol=ATOL, rtol=RTOL)
    texts = ["a short text", "another somewhat longer text with words"]
    for a, b in zip(eng.encode_token_states(texts), jeng.encode_token_states(texts)):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, rtol=RTOL)


def test_embed_tokens_device_on_a_mesh_refuses_int8(engines):
    with pytest.raises(ValueError, match="needs a float output_dtype"):
        engines["int8"][1].embed_tokens_device(LISTS[:2])
    ((_, vecs),) = engines["float32"][1].embed_tokens_device(LISTS[:2])
    np.testing.assert_allclose(vecs.numpy(), engines["float32"][1].embed_tokens(LISTS[:2]),
                               atol=ATOL)


def test_engine_from_gguf_on_a_mesh(tmp_path):
    from embedding_cpp_tpu_torch.cli.make_test_model import make_test_model

    path = str(tmp_path / "tiny.gguf")
    make_test_model(path, "tiny", "q4_0", seed=0)
    one = Engine.from_gguf(path, device="cpu", opts=OPTS)
    on_mesh = Engine.from_gguf(path, opts=OPTS, mesh=make_mesh(dp=2, tp=2,
                                                               devices=["cpu"] * 4))
    texts = ["the first text", "a second one", "and a third, longer than the others"]
    np.testing.assert_allclose(on_mesh.encode(texts), one.encode(texts), atol=ATOL)
    assert on_mesh.device == torch.device("cpu") and on_mesh.mesh.shape == {"dp": 2, "tp": 2}

