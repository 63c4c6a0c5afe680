"""The port's HF converter against the JAX package's: `from_hf_config`
field by field for one config.json per family, its refusals, the
safetensors parser against the `safetensors` package, and
`convert_hf_dir` byte for byte at f32 and q4_0 on a tiny checkpoint
directory of every family (tests/torch_hf_dirs.py) — pooling, Dense head,
prompts, special-token map, SPLADE, ColBERT and classification heads
included — plus the convert CLI."""
import dataclasses
import filecmp
import json

import numpy as np
import pytest
import torch
from torch_hf_dirs import (
    FAMILIES,
    hf_config_dict,
    make_hf_dir,
    upcast_bf16,
    write_weights,
)

from embedding_cpp_tpu.models import convert as jconvert
from embedding_cpp_tpu.models.config import BertConfig as JConfig
from embedding_cpp_tpu_torch.cli.convert import main as convert_main
from embedding_cpp_tpu_torch.models import convert as tconvert
from embedding_cpp_tpu_torch.models.config import BertConfig as TConfig

pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {f: make_hf_dir(root, f, fmt="safetensors" if f == "bert" else "bin")
            for f in FAMILIES}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_from_hf_config_matches_jax_field_by_field(family):
    hf = hf_config_dict(family)
    got = dataclasses.asdict(TConfig.from_hf_config(hf, name="x"))
    want = dataclasses.asdict(JConfig.from_hf_config(hf, name="x"))
    assert got == want


REFUSALS = [
    ("modernbert", {"attention_bias": True}), ("modernbert", {"hidden_activation": "silu"}),
    ("t5", {"feed_forward_proj": "gated-swish"}),
    ("deberta", {"relative_attention": False}), ("deberta", {"share_att_key": False}),
    ("deberta", {"position_biased_input": True}), ("deberta", {"conv_kernel_size": 3}),
    ("deberta", {"norm_rel_ebd": "none"}), ("deberta", {"pos_att_type": "c2p"}),
    ("deberta", {"embedding_size": 32}), ("deberta", {"position_buckets": 0}),
    ("albert", {"num_hidden_groups": 2}), ("albert", {"hidden_act": "relu"}),
    ("nomic", {"activation_function": "gelu"}), ("nomic", {"rotary_emb_fraction": 0.5}),
    ("nomic", {"rotary_emb_interleaved": True}), ("nomic", {"prenorm": True}),
    ("nomic", {"use_rms_norm": True}), ("nomic", {"mlp_fc2_bias": True}),
]


@pytest.mark.parametrize("family,change", REFUSALS, ids=[f"{f}-{next(iter(c))}"
                                                         for f, c in REFUSALS])
def test_from_hf_config_refuses_as_jax_does(family, change):
    hf = {**hf_config_dict(family), **change}
    with pytest.raises(ValueError) as want:
        JConfig.from_hf_config(hf)
    with pytest.raises(ValueError) as got:
        TConfig.from_hf_config(hf)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("overrides", [{}, {"n_token_types": 0}, {"gelu": "erf"}])
@pytest.mark.parametrize("arch", ["bert", "roberta", "distilbert", "mpnet", "modernbert",
                                  "albert", "electra", "t5", "deberta", "nomic-bert"])
def test_arch_defaults_match_jax(arch, overrides):
    kw = dict(n_vocab=100, n_ctx=64, n_embd=64, n_layer=2, n_head=4, n_ff=128, **overrides)
    if arch in ("albert", "electra"):
        kw["n_embd_emb"] = 32
    assert dataclasses.asdict(TConfig.arch_defaults(arch, **kw)) == dataclasses.asdict(
        JConfig.arch_defaults(arch, **kw))


def test_safetensors_parser_matches_the_package(tmp_path):
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import load_file as load_torch
    from safetensors.torch import save_file as save_torch

    rng = np.random.default_rng(0)
    arrays = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "f16": rng.standard_normal((4,)).astype(np.float16),
              "f64": rng.standard_normal((2, 2)),
              "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
              "i32": np.arange(-3, 3, dtype=np.int32), "u8": np.arange(7, dtype=np.uint8),
              "bool": np.array([True, False]), "scalar": np.array(2.5, np.float32),
              "empty": np.zeros((0, 4), np.float32)}
    save_file(arrays, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    got, want = (tconvert.load_safetensors(tmp_path / "a.safetensors"),
                 load_file(str(tmp_path / "a.safetensors")))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert np.array_equal(got[k], want[k])
    bf = {"w": torch.randn(3, 8).bfloat16(), "b": torch.randn(5).bfloat16(),
          "f": torch.randn(2)}
    save_torch(bf, str(tmp_path / "b.safetensors"))
    got, want = tconvert.load_safetensors(tmp_path / "b.safetensors"), load_torch(
        str(tmp_path / "b.safetensors"))
    for k in want:
        assert got[k].dtype == np.float32
        assert np.array_equal(got[k], want[k].float().numpy())


@pytest.mark.parametrize("ftype", ["f32", "q4_0"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_convert_hf_dir_is_byte_identical(dirs, family, ftype, tmp_path):
    src = dirs[family]
    tconvert.convert_hf_dir(src, tmp_path / "t.gguf", ftype)
    jconvert.convert_hf_dir(src, tmp_path / "j.gguf", ftype)
    assert filecmp.cmp(tmp_path / "t.gguf", tmp_path / "j.gguf", shallow=False)


@pytest.mark.parametrize("family", ["bert", "splade", "colbert", "st-dense", "nomic", "xlmr",
                                    "modernbert-reranker", "t5-gated", "deberta-reranker"])
def test_load_hf_dir_matches_jax(dirs, family):
    got = tconvert.load_hf_dir(dirs[family])
    want = jconvert.load_hf_dir(dirs[family])
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
    assert list(got[1]) == list(want[1])
    assert all(np.array_equal(np.asarray(got[1][k]), np.asarray(want[1][k])) for k in got[1])
    assert got[2:] == want[2:]


def test_bf16_safetensors_converts_as_its_upcast_weights(dirs, tmp_path):
    """A bf16 checkpoint (ModernBERT's published dtype) converts as the same
    weights upcast to f32 would: the JAX reader cannot read bf16, so the
    port's file is held to JAX's on the upcast weights, saved as f32
    safetensors (which orders tensors as the bf16 file does)."""
    src = dirs["modernbert"]
    sd = torch.load(src / "pytorch_model.bin", weights_only=True)
    # one directory name under two parents: the file's general.name is it
    bf, up = tmp_path / "bf16" / "ckpt", tmp_path / "up" / "ckpt"
    for d, fmt, weights in ((bf, "bf16", sd), (up, "safetensors", upcast_bf16(sd))):
        d.mkdir(parents=True)
        for name in ("config.json", "tokenizer.json"):
            (d / name).write_bytes((src / name).read_bytes())
        write_weights(d, weights, fmt)
    for ftype in ("f32", "q4_0"):
        tconvert.convert_hf_dir(bf, tmp_path / "t.gguf", ftype)
        jconvert.convert_hf_dir(up, tmp_path / "j.gguf", ftype)
        assert filecmp.cmp(tmp_path / "t.gguf", tmp_path / "j.gguf", shallow=False)


@pytest.mark.parametrize("family,err", [
    ("modernbert", "requires a \\*ForMaskedLM"), ("colbert", "cannot be both")])
def test_load_hf_dir_refusals_match_jax(dirs, family, err):
    src = dirs["modernbert-reranker" if family == "modernbert" else family]
    with pytest.raises(ValueError, match=err):
        tconvert.load_hf_dir(src, sparse=True)
    with pytest.raises(ValueError, match=err):
        jconvert.load_hf_dir(src, sparse=True)


def test_unsupported_architecture_is_refused(tmp_path, dirs):
    d = tmp_path / "gpt"
    d.mkdir()
    hf = json.loads((dirs["bert"] / "config.json").read_text())
    (d / "config.json").write_text(json.dumps({**hf, "architectures": ["GPT2Model"]}))
    with pytest.raises(ValueError, match="unsupported architecture: GPT2Model"):
        tconvert.load_hf_dir(d)


@pytest.mark.parametrize("argv,ftypes", [(["--ftype", "q8_0"], ["q8_0"]), ([], ["f32"]),
                                         (["--all-ftypes"], ["f32", "f16", "q4_0", "q4_1",
                                                             "q8_0"])])
def test_convert_cli(dirs, tmp_path, argv, ftypes, capsys):
    out = tmp_path / ("all" if "--all-ftypes" in argv else "m.gguf")
    convert_main([str(dirs["bert"]), str(out), *argv])
    assert "wrote" in capsys.readouterr().out
    for ftype in ftypes:
        got = out / f"ggml-model-{ftype}.gguf" if out.is_dir() else out
        jconvert.convert_hf_dir(dirs["bert"], tmp_path / "j.gguf", ftype)
        assert filecmp.cmp(got, tmp_path / "j.gguf", shallow=False)


def test_convert_cli_legacy_round_trip(dirs, tmp_path):
    """HF dir -> legacy .bin -> GGUF through the CLI, against the JAX
    package's functions; a legacy file has no name, so the GGUF takes its
    file's stem, the same in both directories."""
    from embedding_cpp_tpu.gguf.legacy import upgrade_legacy_bin

    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    convert_main([str(dirs["bert"]), str(tmp_path / "t" / "m.bin"), "--legacy"])
    jconvert.convert_hf_dir_to_legacy(dirs["bert"], tmp_path / "j" / "m.bin", "f16")
    assert filecmp.cmp(tmp_path / "t" / "m.bin", tmp_path / "j" / "m.bin", shallow=False)
    convert_main([str(tmp_path / "t" / "m.bin"), str(tmp_path / "t" / "up.gguf"),
                  "--ftype", "q4_0"])
    upgrade_legacy_bin(tmp_path / "j" / "m.bin", tmp_path / "j" / "up.gguf", "q4_0")
    assert filecmp.cmp(tmp_path / "t" / "up.gguf", tmp_path / "j" / "up.gguf", shallow=False)
    with pytest.raises(SystemExit):
        convert_main([str(tmp_path / "t" / "m.bin"), str(tmp_path / "x.gguf"), "--sparse"])
