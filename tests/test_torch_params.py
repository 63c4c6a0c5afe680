"""The port's GGUF codecs, reader and parameter loaders against the JAX
package's: the same bytes, the same kv metadata, the same leaves."""
import jax
import numpy as np
import pytest
import torch

from embedding_cpp_tpu.cli.make_test_model import make_test_model
from embedding_cpp_tpu.gguf import GGMLType as JGGMLType
from embedding_cpp_tpu.gguf import GGUFReader as JReader
from embedding_cpp_tpu.gguf.quant import dequantize as jax_dequantize
from embedding_cpp_tpu.gguf.quant import quantize as jax_quantize
from embedding_cpp_tpu.models.config import BertConfig as JConfig
from embedding_cpp_tpu.models.convert import FTYPE_NAMES as J_FTYPES
from embedding_cpp_tpu.models.params import load_params as jax_load_params
from embedding_cpp_tpu.models.params import random_params as jax_random_params
from embedding_cpp_tpu.models.params import random_state_dict as jax_state_dict
from embedding_cpp_tpu_torch.gguf import GGMLType, GGUFReader
from embedding_cpp_tpu_torch.gguf.quant import dequantize, quantize
from embedding_cpp_tpu_torch.models import (
    BertConfig,
    from_jax_params,
    load_params,
    random_params,
    random_state_dict,
)
from embedding_cpp_tpu_torch.ops.qtensor import QTensor

TINY = dict(n_vocab=300, n_ctx=64, n_embd=64, n_layer=2, n_head=4, n_ff=128)
FTYPES = ["f32", "f16", "q4_0", "q4_1", "q8_0"]


def assert_params_equal(a: dict, b: dict, path: str = "") -> None:
    assert a.keys() == b.keys(), path
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            assert_params_equal(x, y, f"{path}{k}/")
        elif isinstance(x, QTensor):
            assert isinstance(y, QTensor), path + k
            assert x.shape == y.shape and x.qtype == y.qtype, path + k
            for f in ("qs", "scales", "mins"):
                u, v = getattr(x, f), getattr(y, f)
                assert (u is None) == (v is None), path + k + f
                if u is not None:
                    assert u.dtype == v.dtype and torch.equal(u, v), path + k + f
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), path + k


def _jax_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("qtype", ["F32", "F16", "Q4_0", "Q4_1", "Q8_0"])
def test_quantize_bytes_and_dequantize_match_jax(qtype):
    x = np.random.default_rng(0).normal(size=(8, 96)).astype(np.float32)
    x[0, :32] = 0.0  # an all-zero block
    raw = quantize(x, GGMLType[qtype])
    np.testing.assert_array_equal(raw, jax_quantize(x, JGGMLType[qtype]))
    np.testing.assert_array_equal(
        dequantize(raw, GGMLType[qtype], x.size),
        jax_dequantize(raw, JGGMLType[qtype], x.size),
    )


def test_random_state_dict_matches_jax():
    sd = random_state_dict(BertConfig(**TINY), seed=3)
    ref = jax_state_dict(JConfig(**TINY), seed=3)
    assert sd.keys() == ref.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], ref[k])


@pytest.mark.parametrize("ftype", FTYPES)
def test_random_params_equal_bridged_jax_params(ftype):
    ours = random_params(BertConfig(**TINY), ftype, seed=0)
    theirs = jax_random_params(JConfig(**TINY), J_FTYPES[ftype], seed=0)
    assert_params_equal(ours, from_jax_params(_jax_tree(theirs)))
    q_w = ours["layers"]["q_w"]
    leading = q_w.qs.shape[0] if isinstance(q_w, QTensor) else q_w.shape[0]
    assert leading == TINY["n_layer"]  # the layer axis is kept


@pytest.mark.parametrize("ftype", ["f32", "q4_0", "q8_0"])
def test_from_gguf_leaves_equal_jax(tmp_path, ftype):
    path = str(tmp_path / f"tiny-{ftype}.gguf")
    make_test_model(path, "tiny", ftype, seed=1)
    with GGUFReader(path) as r, JReader(path) as jr:
        assert r.version == jr.version and r.data_start == jr.data_start
        assert set(r.kv) == set(jr.kv)
        assert {n: (i.shape, int(i.ggml_type)) for n, i in r.tensors.items()} == {
            n: (i.shape, int(i.ggml_type)) for n, i in jr.tensors.items()
        }
        ours, config = load_params(r)
        theirs, jconfig = jax_load_params(jr)
    assert (config.n_embd, config.n_layer, config.n_head, config.n_ff,
            config.n_vocab, config.n_ctx) == (
        jconfig.n_embd, jconfig.n_layer, jconfig.n_head, jconfig.n_ff,
        jconfig.n_vocab, jconfig.n_ctx)
    assert config.head_dim == jconfig.head_dim
    assert_params_equal(ours, from_jax_params(_jax_tree(theirs)))
    if ftype != "f32":
        assert isinstance(ours["layers"]["ffn_up_w"], QTensor)
        assert ours["layers"]["ffn_up_w"].qs.shape[0] == config.n_layer


def test_dense_head_params_match_jax():
    kw = dict(TINY, dense_out=32)
    ours = random_params(BertConfig(**kw), "q4_0", seed=2)
    theirs = jax_random_params(JConfig(**kw), J_FTYPES["q4_0"], seed=2)
    assert_params_equal(ours, from_jax_params(_jax_tree(theirs)))


def test_non_bert_architecture_is_refused():
    """The reference's last three families build and draw their state dicts
    as the JAX package does (ALBERT one shared layer, T5 d_kv 32); an
    architecture neither package knows is refused by both."""
    for kw in (dict(arch="mpnet", n_token_types=0, pos_offset=2, rel_attn_buckets=32),
               dict(arch="albert", n_embd_emb=32, gelu="tanh"),
               dict(arch="t5", n_token_types=0, rel_attn_buckets=32, n_head_dim=32,
                    ffn_act="relu")):
        sd = random_state_dict(BertConfig(**TINY, **kw), seed=4)
        ref = jax_state_dict(JConfig(**TINY, **kw), seed=4)
        assert list(sd) == list(ref), kw["arch"]
        for k in sd:
            np.testing.assert_array_equal(sd[k], ref[k])
    for config in (BertConfig, JConfig):
        with pytest.raises(ValueError, match="unsupported architecture"):
            config(**TINY, arch="gpt2")
