"""The port's Engine switches against the JAX package's Engine with the
same options, on `make_test_model` files with f32 activations: float16 /
bfloat16 outputs (within one ulp of the output dtype), custom
`seq_buckets` / `batch_buckets` (tiny and tiny-nomic, whose padded chunks
key off the top row bucket), `weight_mode="dequant"`, `from_hf_dir` and
`from_legacy_bin` (2e-5); the kernel switches (`q4_impl` / `attn_impl`
"plain" equals "auto" on the CPU, "kernel" is refused there); `warmup`;
the server's `--output-dtype` and warmup before it listens."""
import dataclasses

import numpy as np
import pytest
import torch
from torch_hf_dirs import make_hf_dir

from embedding_cpp_tpu.cli.make_test_model import make_test_model
from embedding_cpp_tpu.models.bert import ComputeOptions as JOptions
from embedding_cpp_tpu.runtime.engine import Engine as JEngine
from embedding_cpp_tpu_torch import Engine
from embedding_cpp_tpu_torch.models import ComputeOptions
from embedding_cpp_tpu_torch.ops.qtensor import QTensor
from embedding_cpp_tpu_torch.tokenizer.testvocab import _COMMON_WORDS

ATOL = 2e-5


def _sentences(n: int, lo: int, hi: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    words = np.array(_COMMON_WORDS)
    return [" ".join(rng.choice(words, size=int(rng.integers(lo, hi)))) for _ in range(n)]


# >= 32 short sentences (packed) and a mixed-length set up to the context
TEXTS = {"packed": _sentences(40, 3, 14, seed=0), "mixed": _sentences(14, 3, 120, seed=1)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("opts")
    out = {}
    for preset, ftype in (("tiny", "f32"), ("tiny", "q4_0"), ("tiny-nomic", "q4_0"),
                          ("tiny-modernbert", "q8_0"), ("tiny-deberta", "q4_1"),
                          ("tiny-t5", "q4_0"), ("tiny-mpnet", "q4_0")):
        out[(preset, ftype)] = str(root / f"{preset}-{ftype}.gguf")
        make_test_model(out[(preset, ftype)], preset, ftype, seed=0)
    return out


def _ulp(x: np.ndarray, dtype: str) -> np.ndarray:
    """One unit in the last place of x rounded to `dtype`."""
    if dtype == "float16":
        return np.spacing(np.abs(x.astype(np.float16))).astype(np.float32)
    mag = np.maximum(np.abs(torch.from_numpy(x).bfloat16().float().numpy()), 2.0**-126)
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.mark.parametrize("texts", sorted(TEXTS))
@pytest.mark.parametrize("output_dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("ftype", ["f32", "q4_0"])
def test_output_dtype_matches_jax_within_one_ulp(files, ftype, output_dtype, texts):
    path = files[("tiny", ftype)]
    ours = Engine.from_gguf(path, device="cpu", opts=ComputeOptions(output_dtype=output_dtype))
    theirs = JEngine.from_gguf(path, opts=JOptions(output_dtype=output_dtype))
    got, ref = ours.encode(TEXTS[texts]), theirs.encode(TEXTS[texts])
    assert got.dtype == ref.dtype == np.float32
    assert np.all(np.abs(got - ref) <= _ulp(ref, output_dtype))
    # the values are the output dtype's: the f32 result rounds to them
    f32 = Engine(ours.params, ours.config, ours.tokenizer, ours.special_ids,
                 device="cpu").encode(TEXTS[texts])
    rounded = torch.from_numpy(f32).to(getattr(torch, output_dtype)).float().numpy()
    np.testing.assert_array_equal(got, rounded)


@pytest.mark.parametrize("buckets", [((32, 128), (4, 16)), ((16, 64), (64,)), ((24,), (2, 8)),
                                     ((64, 256), (8,))],
                         ids=["two", "one-row-bucket", "below-every-length", "past-the-context"])
@pytest.mark.parametrize("packing", ["auto", "never"])
@pytest.mark.parametrize("preset", ["tiny", "tiny-nomic"])
def test_custom_buckets_match_jax(files, preset, packing, buckets):
    seq, rows = buckets
    kw = dict(seq_buckets=seq, batch_buckets=rows, packing=packing)
    path = files[(preset, "q4_0")]
    ours = Engine.from_gguf(path, device="cpu", **kw)
    theirs = JEngine.from_gguf(path, **kw)
    assert ours.seq_buckets == theirs.seq_buckets
    assert ours.batch_buckets == theirs.batch_buckets
    assert ours.max_batch_tokens == theirs.max_batch_tokens
    texts = TEXTS["packed"] + TEXTS["mixed"]
    np.testing.assert_allclose(ours.encode(texts), theirs.encode(texts), rtol=0, atol=ATOL)
    lists = ours.tokenize_batch(texts)
    if max(map(len, lists)) > seq[-1]:
        # the token surfaces refuse a list past the top length bucket (the
        # JAX Engine fails there too, in numpy's broadcast)
        with pytest.raises(ValueError, match="top length bucket"):
            ours.token_states_tokens(lists)
        with pytest.raises(ValueError):
            theirs.token_states_tokens(lists)
    elif preset == "tiny-nomic":
        # F3: the token surfaces pad chunks of the top row bucket's rows to
        # the chunk's longest list; the dynamic-NTK base follows that length
        for a, b in zip(ours.token_states_tokens(lists), theirs.token_states_tokens(lists)):
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_default_buckets_extend_only_when_not_given(files):
    path = files[("tiny-nomic", "q4_0")]
    assert Engine.from_gguf(path, device="cpu").seq_buckets == (16, 32, 64, 128, 256)
    custom = Engine.from_gguf(path, device="cpu", seq_buckets=(16, 64))
    assert custom.seq_buckets == JEngine.from_gguf(path, seq_buckets=(16, 64)).seq_buckets
    assert custom.seq_buckets == (16, 64)
    big = Engine.from_gguf(path, device="cpu", batch_buckets=(8, 4096))
    assert big.max_batch_tokens == 4096 * 512


@pytest.mark.parametrize("preset,ftype", [("tiny", "q4_0"), ("tiny-nomic", "q4_0"),
                                          ("tiny-modernbert", "q8_0"), ("tiny-deberta", "q4_1")])
def test_dequant_weight_mode_matches_jax(files, preset, ftype):
    path = files[(preset, ftype)]
    ours = Engine.from_gguf(path, device="cpu", weight_mode="dequant")
    theirs = JEngine.from_gguf(path, weight_mode="dequant")
    layers = ours.params["layers"]
    assert not any(isinstance(v, QTensor) for v in layers.values())
    assert not isinstance(ours.params["embeddings"]["word"], QTensor)
    auto = Engine.from_gguf(path, device="cpu")
    assert any(isinstance(v, QTensor) for v in auto.params["layers"].values())
    texts = TEXTS["packed"] + TEXTS["mixed"]
    got = ours.encode(texts)
    np.testing.assert_allclose(got, theirs.encode(texts), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, auto.encode(texts), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="weight_mode"):
        Engine.from_gguf(path, device="cpu", weight_mode="xla")


@pytest.mark.parametrize("ftype", ["f32", "q4_0"])
@pytest.mark.parametrize("family", ["bert", "st-dense", "xlmr"])
def test_from_hf_dir_matches_jax(tmp_path, family, ftype):
    src = make_hf_dir(tmp_path, family)
    ours = Engine.from_hf_dir(str(src), ftype=ftype, device="cpu")
    theirs = JEngine.from_hf_dir(str(src), ftype=ftype)
    assert dataclasses.asdict(ours.config) == dataclasses.asdict(theirs.config)
    assert ours.prompts == theirs.prompts
    texts = TEXTS["mixed"]
    np.testing.assert_allclose(ours.encode(texts), theirs.encode(texts), rtol=0, atol=ATOL)


@pytest.mark.parametrize("ftype", ["f32", "f16"])
def test_from_legacy_bin_matches_jax(tmp_path, ftype):
    from embedding_cpp_tpu_torch.models.convert import convert_hf_dir_to_legacy

    src = make_hf_dir(tmp_path, "bert")
    convert_hf_dir_to_legacy(src, tmp_path / "m.bin", ftype)
    ours = Engine.from_legacy_bin(str(tmp_path / "m.bin"), device="cpu")
    theirs = JEngine.from_legacy_bin(str(tmp_path / "m.bin"))
    texts = TEXTS["packed"]
    got = ours.encode(texts)
    np.testing.assert_allclose(got, theirs.encode(texts), rtol=0, atol=ATOL)
    # the same weights through a GGUF of the file's dtype
    from embedding_cpp_tpu_torch.models.convert import convert_hf_dir

    convert_hf_dir(src, tmp_path / "m.gguf", ftype)
    np.testing.assert_array_equal(got, Engine.from_gguf(str(tmp_path / "m.gguf"),
                                                        device="cpu").encode(texts))


SWITCHES = [("plain", "auto"), ("auto", "plain"), ("plain", "plain")]


@pytest.mark.parametrize("q4_impl,attn_impl", SWITCHES, ids=["q4", "attn", "both"])
@pytest.mark.parametrize("preset,ftype", [("tiny", "q4_0"), ("tiny-nomic", "q4_0"),
                                          ("tiny-modernbert", "q8_0"), ("tiny-deberta", "q4_1"),
                                          ("tiny-t5", "q4_0"), ("tiny-mpnet", "q4_0")])
def test_plain_equals_auto_on_the_cpu(files, preset, ftype, q4_impl, attn_impl):
    auto = Engine.from_gguf(files[(preset, ftype)], device="cpu")
    plain = Engine(auto.params, auto.config, auto.tokenizer, auto.special_ids, device="cpu",
                   opts=ComputeOptions(q4_impl=q4_impl, attn_impl=attn_impl))
    texts = TEXTS["packed"] + TEXTS["mixed"]
    np.testing.assert_array_equal(plain.encode(texts), auto.encode(texts))


@pytest.mark.parametrize("field", ["q4_impl", "attn_impl"])
def test_kernel_on_the_cpu_is_refused_when_the_engine_is_built(files, field):
    path = files[("tiny", "q4_0")]
    with pytest.raises(ValueError, match="'kernel' on the CPU"):
        Engine.from_gguf(path, device="cpu", opts=ComputeOptions(**{field: "kernel"}))
    with pytest.raises(ValueError, match=field):
        ComputeOptions(**{field: "pallas"})


def test_kernel_impl_on_a_cpu_tensor_raises_in_the_wrapper():
    from embedding_cpp_tpu_torch.ops.attention import flash_attention_bse
    from embedding_cpp_tpu_torch.ops.dispatch import kernel_impls

    q = torch.zeros(1, 8, 32)
    bias = torch.zeros(1, 8)
    with kernel_impls(attn="kernel"), pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_bse(q, q, q, bias, 2)
    with kernel_impls(attn="plain"):
        assert flash_attention_bse(q, q, q, bias, 2).shape == q.shape


def test_warmup_runs_the_smallest_shape(files):
    eng = Engine.from_gguf(files[("tiny", "q4_0")], device="cpu",
                           seq_buckets=(32, 64), batch_buckets=(2, 8))
    eng.warmup()
    eng.warmup([(3, 16), (1, 64)])
    assert eng.stats["sentences"] == 0  # warmup is not traffic


@pytest.mark.parametrize("output_dtype", ["float16", "bfloat16", "int8", "float32"])
def test_server_main_takes_the_output_dtype_and_warms_up(files, monkeypatch, output_dtype):
    from embedding_cpp_tpu_torch.runtime import server

    calls = []
    monkeypatch.setattr(Engine, "warmup", lambda self: calls.append(("warmup", self.opts)))
    monkeypatch.setattr(server.asyncio, "run", lambda coro: (calls.append(("serve",)),
                                                             coro.close()))
    server.main(["-m", files[("tiny", "q4_0")], "--device", "cpu", "--output-dtype",
                 output_dtype, "--dtype", "float32"])
    assert calls[0][0] == "warmup" and calls[0][1].output_dtype == output_dtype
    assert calls[1] == ("serve",)
