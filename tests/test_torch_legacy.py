"""The port's legacy pre-GGUF .bin format (magic 'ggml') against the JAX
package's: the written file byte for byte at f32 and f16, each package
reading the other's file to the same hparams, tokenizer, vocab and
tensors, the upgrade to GGUF byte for byte at every ftype, and the
refusals."""
import dataclasses
import filecmp
import struct

import numpy as np
import pytest

from embedding_cpp_tpu.gguf import legacy as jlegacy
from embedding_cpp_tpu.models.config import BertConfig as JConfig
from embedding_cpp_tpu_torch.gguf import legacy as tlegacy
from embedding_cpp_tpu_torch.models.config import BertConfig
from embedding_cpp_tpu_torch.models.params import random_state_dict
from embedding_cpp_tpu_torch.tokenizer.testvocab import build_tokenizer_json

CONFIG = BertConfig(n_vocab=1000, n_ctx=128, n_embd=64, n_layer=2, n_head=4, n_ff=128,
                    name="legacy-test")


@pytest.fixture(scope="module")
def model():
    sd = random_state_dict(CONFIG, seed=3)
    # the buffers and pooler an HF BertModel dict carries: the writer drops them
    sd["embeddings.position_ids"] = np.arange(128, dtype=np.float32)[None]
    sd["pooler.dense.weight"] = np.ones((64, 64), np.float32)
    return sd, build_tokenizer_json(CONFIG.n_vocab)


@pytest.fixture(scope="module", params=["f32", "f16"])
def files(request, model, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"legacy-{request.param}")
    sd, blob = model
    tlegacy.write_legacy_bin(root / "t.bin", CONFIG, sd, blob, request.param)
    jconfig = JConfig(**dataclasses.asdict(CONFIG))
    jlegacy.write_legacy_bin(root / "j.bin", jconfig, sd, blob, request.param)
    return request.param, root


def test_written_file_is_byte_identical(files):
    _, root = files
    assert filecmp.cmp(root / "t.bin", root / "j.bin", shallow=False)
    assert struct.unpack("<i", (root / "t.bin").read_bytes()[:4])[0] == tlegacy.LEGACY_MAGIC


@pytest.mark.parametrize("reader,writer", [("t", "j"), ("j", "t"), ("t", "t")])
def test_each_reader_reads_the_others_file(files, model, reader, writer):
    ftype, root = files
    read = (tlegacy if reader == "t" else jlegacy).read_legacy_bin
    got = read(root / f"{writer}.bin")
    sd, blob = model
    assert got.ftype == {"f32": 0, "f16": 1}[ftype]
    assert got.tokenizer_json == blob
    assert len(got.vocab) == CONFIG.n_vocab and got.vocab[2] == b"[CLS]"
    want = dataclasses.asdict(CONFIG) | {"name": ""}
    assert dataclasses.asdict(got.config) == want
    assert sorted(got.tensors) == sorted(k for k in sd if k not in (
        "embeddings.position_ids", "pooler.dense.weight"))
    for name, arr in got.tensors.items():
        half = ftype == "f16" and name.endswith(".weight") and sd[name].ndim == 2
        assert arr.dtype == (np.float16 if half else np.float32)
        ref = sd[name].astype(np.float16) if half else sd[name]
        assert np.array_equal(arr, ref.reshape(arr.shape))


@pytest.mark.parametrize("target", [None, "f32", "f16", "q4_0", "q4_1", "q8_0"])
def test_upgrade_to_gguf_is_byte_identical(files, target, tmp_path):
    _, root = files
    # the GGUF takes its name from the output file's stem: the same in both
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tlegacy.upgrade_legacy_bin(root / "t.bin", tmp_path / "t" / "m.gguf", target)
    jlegacy.upgrade_legacy_bin(root / "j.bin", tmp_path / "j" / "m.gguf", target)
    assert filecmp.cmp(tmp_path / "t" / "m.gguf", tmp_path / "j" / "m.gguf", shallow=False)


def test_refusals(model, tmp_path):
    sd, blob = model
    with pytest.raises(ValueError, match="f32/f16 only"):
        tlegacy.write_legacy_bin(tmp_path / "x.bin", CONFIG, sd, blob, "q4_0")
    with pytest.raises(ValueError, match="no dense-head hparams"):
        tlegacy.write_legacy_bin(tmp_path / "x.bin", dataclasses.replace(CONFIG, dense_out=8),
                                 sd, blob, "f16")
    (tmp_path / "gguf.bin").write_bytes(b"GGUF" + bytes(60))
    with pytest.raises(ValueError, match="bad magic"):
        tlegacy.read_legacy_bin(tmp_path / "gguf.bin")
    head = struct.pack("<9i", tlegacy.LEGACY_MAGIC, 10, 8, 8, 8, 2, 1, 2, 3)
    (tmp_path / "ftype.bin").write_bytes(head)
    with pytest.raises(ValueError, match="unsupported legacy ftype 3"):
        tlegacy.read_legacy_bin(tmp_path / "ftype.bin")
    tlegacy.write_legacy_bin(tmp_path / "ok.bin", CONFIG, sd, blob, "f32")
    raw = (tmp_path / "ok.bin").read_bytes()
    (tmp_path / "cut.bin").write_bytes(raw[:-10])
    with pytest.raises(EOFError):
        tlegacy.read_legacy_bin(tmp_path / "cut.bin")
