"""The port's `make_test_model` against the JAX package's: every preset's
config field by field, and the file byte for byte for every preset at
f32 / f16 / q4_0 / q4_1 / q8_0; the trained test vocabularies against the
JAX builders; the CLI.

HF `tokenizers`' Unigram trainer is not deterministic from run to run (the
order of pieces of equal score and the last bits of the scores vary; the
piece set and everything else do not), so the Unigram presets of both
packages are given one trained vocabulary; BPE training is deterministic
and each package trains its own."""
import dataclasses
import filecmp
import json

import pytest

from embedding_cpp_tpu.cli import make_test_model as jmake
from embedding_cpp_tpu.tokenizer import testvocab as jvocab
from embedding_cpp_tpu_torch.cli import make_test_model as tmake
from embedding_cpp_tpu_torch.tokenizer import testvocab as tvocab

pytest.importorskip("tokenizers")
FTYPES = ("f32", "f16", "q4_0", "q4_1", "q8_0")
# the full-width presets: 6 to 22 layers of 384 to 768
FULL = ("minilm-l6", "minilm-l12", "bert-base", "mpnet-base", "modernbert-base", "gtr-base",
        "nomic-embed-text", "deberta-base")
TINY = tuple(p for p in sorted(jmake.PRESETS) if p not in FULL)


@pytest.fixture(scope="module")
def unigram_blob():
    return jvocab.build_unigram_tokenizer_json(600)


def test_presets_match_jax_field_by_field():
    assert sorted(tmake.PRESETS) == sorted(jmake.PRESETS)
    for name, config in jmake.PRESETS.items():
        assert dataclasses.asdict(tmake.PRESETS[name]) == dataclasses.asdict(config), name


def _same_file(tmp_path, monkeypatch, blob, preset, ftype) -> bool:
    for module in (jmake, tmake):
        monkeypatch.setattr(module, "build_unigram_tokenizer_json", lambda n: blob)
    jmake.make_test_model(str(tmp_path / "j.gguf"), preset, ftype, seed=0)
    tmake.make_test_model(str(tmp_path / "t.gguf"), preset, ftype, seed=0)
    return filecmp.cmp(tmp_path / "j.gguf", tmp_path / "t.gguf", shallow=False)


@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("preset", TINY)
def test_tiny_preset_file_is_byte_identical(tmp_path, monkeypatch, unigram_blob, preset, ftype):
    assert _same_file(tmp_path, monkeypatch, unigram_blob, preset, ftype)


@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("preset", FULL)
def test_full_width_preset_file_is_byte_identical(tmp_path, monkeypatch, unigram_blob, preset,
                                                  ftype):
    assert _same_file(tmp_path, monkeypatch, unigram_blob, preset, ftype)


@pytest.mark.parametrize("n_vocab", [600, 1000])
def test_bpe_vocabulary_is_the_jax_builders(n_vocab):
    assert tvocab.build_bpe_tokenizer_json(n_vocab) == jvocab.build_bpe_tokenizer_json(n_vocab)


@pytest.mark.parametrize("builder", ["build_unigram_tokenizer_json",
                                     "build_albert_tokenizer_json"])
def test_unigram_vocabulary_matches_the_jax_builders(builder):
    """Everything but the piece order and the scores, which vary between two
    runs of either builder: the pipeline, the piece set, and each piece's
    log-probability within 1e-3."""
    got = json.loads(getattr(tvocab, builder)(600))
    want = json.loads(getattr(jvocab, builder)(600))
    got_vocab, want_vocab = dict(map(tuple, got["model"].pop("vocab"))), dict(
        map(tuple, want["model"].pop("vocab")))
    assert got == want
    assert set(got_vocab) == set(want_vocab)
    assert all(abs(got_vocab[p] - want_vocab[p]) <= 1e-3 for p in want_vocab)


def test_trained_vocabularies_need_the_tokenizers_library(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_tokenizers(name, *a, **kw):
        if name == "tokenizers":
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tokenizers)
    with pytest.raises(RuntimeError, match="tokenizers"):
        tvocab.build_bpe_tokenizer_json(600)
    assert tvocab.build_tokenizer_json(1000)  # WordPiece needs nothing


def test_cli_writes_the_preset(tmp_path, capsys):
    tmake.main([str(tmp_path / "t.gguf"), "--preset", "tiny-colbert", "--ftype", "q8_0",
                "--seed", "2"])
    assert "wrote tiny-colbert (q8_0)" in capsys.readouterr().out
    jmake.make_test_model(str(tmp_path / "j.gguf"), "tiny-colbert", "q8_0", seed=2)
    assert filecmp.cmp(tmp_path / "j.gguf", tmp_path / "t.gguf", shallow=False)
