"""The port's sharded forwards (`parallel/sharding.py`) against the JAX
package's GSPMD forward (`parallel/sharding.py`), its `shard_map` forward
(`parallel/shard_map_forward.py`, the Q4 matmul on its Pallas kernel in
interpret mode) and the port's own single-device forward, on meshes of CPU
slots (JAX: the 8 virtual CPU devices of tests/conftest.py).

- plain, `.gather` and packed forwards at (dp, tp) in (1, 2), (2, 2),
  (4, 2), (1, 4), f32 and Q4_0 weights, f32 activations: within 2e-5
  (atol; rtol 1e-4) of all three;
- every family's tp path at (dp, tp) = (2, 2): MPNet's per-head relative
  bias, T5 (gated and relu), ModernBERT (global and local layers), nomic,
  DeBERTa and ALBERT's shared layer, plain and packed, within 2e-5 of the
  JAX GSPMD forward and the port's single-device one;
- the tp hook (`linear(row_parallel=True)`) adds the bias once, after the
  f32 sum, and a tp slot's attention runs n_head / tp heads; a failing
  slot releases the others and its error reaches the caller.
"""
import threading

import numpy as np
import pytest
import torch
from test_torch_families import _bridge, _pconfig

from embedding_cpp_tpu.gguf import GGUFFileType
from embedding_cpp_tpu.models.bert import ComputeOptions as JOpts
from embedding_cpp_tpu.models.config import BertConfig as JConfig
from embedding_cpp_tpu.models.params import random_params as _jax_random_params
from embedding_cpp_tpu.parallel import mesh as jmesh
from embedding_cpp_tpu.parallel import shard_map_forward as jsm
from embedding_cpp_tpu.parallel import sharding as jsharding
from embedding_cpp_tpu.runtime.batching import pack_segments as jax_pack_segments
from embedding_cpp_tpu_torch.models import ComputeOptions, bert_embed_batch, bert_embed_packed
from embedding_cpp_tpu_torch.ops.linear import linear
from embedding_cpp_tpu_torch.parallel import group, sharding
from embedding_cpp_tpu_torch.parallel.mesh import make_mesh

ATOL, RTOL = 2e-5, 1e-4
JCFG = JConfig(n_vocab=256, n_ctx=64, n_embd=128, n_layer=2, n_head=4, n_ff=256,
               name="sharding-test")
CFG = _pconfig(JCFG)
OPTS = ComputeOptions(dtype="float32")


def jax_random_params(config, ftype: str, seed: int):
    return _jax_random_params(config, {"f32": GGUFFileType.ALL_F32,
                                       "q4_0": GGUFFileType.MOSTLY_Q4_0}[ftype], seed=seed)


def _data(batch=8, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, size=(batch, seq)).astype(np.int32)
    mask = np.ones((batch, seq), np.int32)
    mask[:, 12:] = 0
    mask[1, 5:] = 0
    return ids, mask


def _packed_data(seed=1):
    """One packed batch of 8 rows of 64 (24 sentences of 3-19 tokens)."""
    rng = np.random.default_rng(seed)
    lists = [rng.integers(4, 256, size=int(n)).tolist() for n in rng.integers(3, 20, 24)]
    (pb,) = jax_pack_segments(lists, list(range(len(lists))), 0, seq_len=64, n_seg=8,
                              batch_buckets=(8,), row_multiple=4)
    return pb


def _mesh(dp, tp, devices):
    return jmesh.make_mesh(dp=dp, tp=tp, devices=devices[: dp * tp]), \
        make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))


@pytest.mark.parametrize("ftype", ["f32", "q4_0"])
@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (4, 2), (1, 4)])
def test_sharded_forwards_match_gspmd_shard_map_and_single(eight_devices, dp, tp, ftype):
    jparams = jax_random_params(JCFG, ftype, seed=0)
    params = _bridge(jparams)
    jm, m = _mesh(dp, tp, eight_devices)
    ids, mask = _data()
    gidx = np.array([0, 2, 3, 6, 7], np.int32)
    single = bert_embed_batch(params, *map(torch.from_numpy, (ids, mask)), CFG, OPTS).numpy()

    jp, jfwd = jsharding.shard_params_and_make_forward(jparams, JCFG, JOpts(dtype="float32"),
                                                       jm)
    mopts = JOpts(dtype="float32", attn_impl="xla",
                  q4_impl="pallas" if ftype == "q4_0" else "auto")
    mp, mfwd = jsm.shard_params_and_make_forward_manual(jparams, JCFG, mopts, jm)
    sp, fwd = sharding.shard_params_and_make_forward(params, CFG, OPTS, m)
    got = fwd(sp, ids, mask).numpy()
    for ref in (single, np.asarray(jfwd(jp, ids, mask)), np.asarray(mfwd(mp, ids, mask))):
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(fwd.gather(sp, ids, mask, gidx).numpy(),
                               np.asarray(jfwd.gather(jp, ids, mask, gidx)), atol=ATOL, rtol=RTOL)

    pb = _packed_data()
    slots = pb.slots.astype(np.int32)
    packed = sharding.make_packed_forward(m, CFG, OPTS)(sp, pb.ids, pb.seg, pb.pos, slots,
                                                         pb.n_seg).numpy()
    jpacked = jsharding.make_packed_forward(jm, JCFG, JOpts(dtype="float32"))(
        jp, pb.ids, pb.seg, pb.pos, slots, pb.n_seg)
    mpacked = np.asarray(jsm.make_packed_forward_manual(mp, JCFG, mopts, jm)(pb.n_seg, None)(
        mp, pb.ids, pb.seg, pb.pos)).reshape(-1, CFG.n_embd)[slots]
    one = bert_embed_packed(params, *map(torch.from_numpy, (pb.ids, pb.seg, pb.pos)), CFG,
                            OPTS, n_seg=pb.n_seg, gather_idx=torch.from_numpy(slots).long())
    for ref in (one.numpy(), np.asarray(jpacked), mpacked):
        np.testing.assert_allclose(packed, ref, atol=ATOL, rtol=RTOL)


FAMILIES = {
    "mpnet": JConfig(n_vocab=256, n_ctx=64, n_embd=128, n_layer=2, n_head=4, n_ff=256,
                     n_token_types=0, arch="mpnet", pos_offset=2, rel_attn_buckets=32,
                     name="sh-mpnet"),
    "t5": JConfig(n_vocab=256, n_ctx=64, n_embd=128, n_layer=2, n_head=4, n_ff=256,
                  n_token_types=0, arch="t5", layer_norm_eps=1e-6, rel_attn_buckets=32,
                  n_head_dim=32, ffn_act="relu", name="sh-t5"),
    "t5-gated": JConfig(n_vocab=256, n_ctx=64, n_embd=128, n_layer=2, n_head=4, n_ff=256,
                        n_token_types=0, arch="t5", layer_norm_eps=1e-6, rel_attn_buckets=32,
                        n_head_dim=32, ffn_act="gelu_tanh", ffn_gated=True, name="sh-t5g"),
    "modernbert": JConfig(n_vocab=256, n_ctx=64, n_embd=128, n_layer=4, n_head=4, n_ff=256,
                          n_token_types=0, arch="modernbert", layer_norm_eps=1e-5,
                          rope_theta=160000.0, local_rope_theta=10000.0,
                          global_attn_every=3, local_window=16, name="sh-modernbert"),
    "nomic": JConfig(n_vocab=256, n_ctx=64, n_embd=128, n_layer=2, n_head=4, n_ff=256,
                     n_token_types=2, arch="nomic-bert", rope_theta=1000.0,
                     rope_scaling_factor=2.0, rope_max_trained=32, ffn_act="silu",
                     ffn_gated=True, attn_bias=False, ffn_bias=False, name="sh-nomic"),
    "deberta": JConfig(n_vocab=256, n_ctx=64, n_embd=128, n_layer=2, n_head=4, n_ff=256,
                       n_token_types=0, arch="deberta", layer_norm_eps=1e-7,
                       rel_attn_buckets=32, rel_attn_max_dist=128, name="sh-deberta"),
    "albert": JConfig(n_vocab=256, n_ctx=64, n_embd=128, n_layer=3, n_head=4, n_ff=256,
                      arch="albert", gelu="tanh", n_embd_emb=64, name="sh-albert"),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_families_at_tp2_match_gspmd_and_single(eight_devices, family):
    jcfg = FAMILIES[family]
    cfg = _pconfig(jcfg)
    jparams = jax_random_params(jcfg, "f32", seed=3)
    params = _bridge(jparams)
    jm, m = _mesh(2, 2, eight_devices)
    ids, mask = _data(seed=4)
    jp, jfwd = jsharding.shard_params_and_make_forward(jparams, jcfg, JOpts(dtype="float32"),
                                                       jm)
    sp, fwd = sharding.shard_params_and_make_forward(params, cfg, OPTS, m)
    got = fwd(sp, ids, mask).numpy()
    single = bert_embed_batch(params, *map(torch.from_numpy, (ids, mask)), cfg, OPTS).numpy()
    np.testing.assert_allclose(got, single, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, np.asarray(jfwd(jp, ids, mask)), atol=ATOL, rtol=RTOL)

    pb = _packed_data(seed=5)
    slots = pb.slots.astype(np.int32)
    packed = sharding.make_packed_forward(m, cfg, OPTS)(sp, pb.ids, pb.seg, pb.pos, slots,
                                                        pb.n_seg).numpy()
    jpacked = jsharding.make_packed_forward(jm, jcfg, JOpts(dtype="float32"))(
        jp, pb.ids, pb.seg, pb.pos, slots, pb.n_seg)
    one = bert_embed_packed(params, *map(torch.from_numpy, (pb.ids, pb.seg, pb.pos)), cfg,
                            OPTS, n_seg=pb.n_seg, gather_idx=torch.from_numpy(slots).long())
    np.testing.assert_allclose(packed, one.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(packed, np.asarray(jpacked), atol=ATOL, rtol=RTOL)


class _Recorder:
    """A one-slot tp group that records what it reduces."""

    rank, size = 0, 1

    def __init__(self):
        self.seen = []

    def all_reduce(self, t):
        self.seen.append(t.clone())
        return t


def test_row_parallel_linear_adds_the_bias_once_after_the_f32_sum():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    rec = _Recorder()
    with group.using_tp(rec):
        y = linear(x, w, b, row_parallel=True)
        linear(x, w, b)  # a column-parallel linear does not reduce
    (partial,) = rec.seen
    assert partial.dtype == torch.float32  # the partial product is kept in f32
    want = x.float() @ w.to(torch.bfloat16).float()
    torch.testing.assert_close(partial, want, atol=1e-4, rtol=1e-5)
    assert torch.equal(y, (want + b).to(torch.bfloat16))


def test_thread_group_sums_in_tp_order_and_releases_on_failure():
    g = group.ThreadGroup(3, timeout=30)
    parts = [torch.full((2,), float(10 ** r)) for r in range(3)]
    out = [None] * 3

    def run(r):
        out[r] = g.member(r).all_reduce(parts[r])

    ts = [threading.Thread(target=run, args=(r,)) for r in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert all(torch.equal(o, torch.full((2,), 111.0)) for o in out)
    g2 = group.ThreadGroup(2, timeout=30)
    g2.abort()
    with pytest.raises(threading.BrokenBarrierError):
        g2.member(0).all_reduce(parts[0])


def test_a_slot_failure_reaches_the_caller():
    m = make_mesh(dp=1, tp=2, devices=["cpu"] * 2)
    sp = sharding.shard_params(_bridge(jax_random_params(JCFG, "f32", seed=0)), CFG, m)

    def body(p, ids):
        if group.current_tp().rank == 1:
            raise KeyError("slot 1")
        return group.current_tp().all_reduce(ids.float())

    with pytest.raises(KeyError, match="slot 1"):
        sp.run(body, (np.zeros((2, 3), np.int32),))


def test_a_tp_slot_attends_with_its_local_heads(monkeypatch):
    """12 heads of 16 where there should be 6 of 32 would pass silently on
    the plain version: the head count reaching the attention is n_head / tp."""
    from embedding_cpp_tpu_torch.models import bert

    seen = []
    real = bert.flash_attention_bse
    monkeypatch.setattr(bert, "flash_attention_bse",
                        lambda q, k, v, mb, h, pb=None: seen.append((q.shape[-1], h))
                        or real(q, k, v, mb, h, pb))
    m = make_mesh(dp=1, tp=2, devices=["cpu"] * 2)
    sp, fwd = sharding.shard_params_and_make_forward(
        _bridge(jax_random_params(JCFG, "f32", seed=0)), CFG, OPTS, m)
    fwd(sp, *_data())
    assert set(seen) == {(64, 2)}
