"""The plain reference against the port's CPU path (its kernels' plain
versions), on tiny configurations of both families: the GGUF the
benchmark writes loads through `Engine.from_gguf`, the port tokenizes each
text to the ids the reference derives from the text alone, and in f32 the
two give the same vectors to rounding."""
from __future__ import annotations

import os
import tempfile

import numpy as np
import pytest
import torch

from _cells import TINY, cut_cell

CELLS = ["bge-large.corpus", "modernbert.docs8k"]


def _engine_and_reference(cell: str, dtype: str):
    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models.bert import ComputeOptions
    from perfbench import weights
    from perfbench.vocab import build_vocab

    _, c = cut_cell(cell, TINY)
    voc = build_vocab(c)
    drawn = weights.draw(c, 2**31 + 3, "cpu")
    fd, path = tempfile.mkstemp(suffix=".gguf")
    os.close(fd)
    try:
        weights.write_model(path, c, voc, drawn)
        eng = Engine.from_gguf(path, device="cpu", opts=ComputeOptions(dtype=dtype))
    finally:
        os.remove(path)
    return eng, c, voc


def _texts(voc, c, n=24, seed=5):
    rng = np.random.default_rng(seed)
    texts = [voc.text(rng.choice(voc.word_ids, size=int(k))) for k in rng.integers(3, 90, n)]
    prompt = (c.get("prompts") or {}).get("query")
    return [prompt + t for t in texts[: n // 2]] + texts[n // 2:] if prompt else texts


@pytest.mark.parametrize("cell", CELLS)
def test_ids_derived_from_text_match_the_port(cell):
    from perfbench.reference.common import TextIds

    eng, c, voc = _engine_and_reference(cell, "float32")
    texts = _texts(voc, c)
    ids = [TextIds(voc, c["max_position_embeddings"])(t) for t in texts]
    assert [list(map(int, t)) for t in eng.tokenize_batch(texts)] == ids


@pytest.mark.parametrize("cell", CELLS)
def test_reference_matches_the_port_in_f32(cell):
    from perfbench import check

    eng, c, voc = _engine_and_reference(cell, "float32")
    texts = _texts(voc, c)
    got = eng.encode(texts)
    ref = check.reference_vectors(c, voc, 2**31 + 3, texts, "cpu")
    assert check.gaps(got, ref).max() < 1e-5


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_port_is_near_the_reference_and_fp8_control_is_not_exact(cell):
    from perfbench import check

    eng, c, voc = _engine_and_reference(cell, "bfloat16")
    texts = _texts(voc, c)
    ref = check.reference_vectors(c, voc, 2**31 + 3, texts, "cpu")
    ctl = check.reference_vectors(c, voc, 2**31 + 3, texts, "cpu", "fp8")
    assert 0 < check.gaps(eng.encode(texts), ref).max() < 0.05
    assert check.gaps(ctl, ref).max() > 1e-4


def test_dequantize_matches_the_block_layouts():
    from perfbench.reference.common import dequantize

    d = np.float16(0.5)
    q8 = np.arange(-16, 16, dtype=np.int8)
    blk = np.concatenate([np.frombuffer(d.tobytes(), np.uint8), q8.view(np.uint8)])[None]
    got = dequantize(torch.from_numpy(blk), "q8_0", (32,))
    assert torch.equal(got, torch.from_numpy(q8.astype(np.float32) * 0.5))
    nib = np.arange(16, dtype=np.uint8)
    packed = (nib | ((15 - nib) << 4)).astype(np.uint8)
    blk4 = np.concatenate([np.frombuffer(d.tobytes(), np.uint8), packed])[None]
    want = np.concatenate([nib, 15 - nib]).astype(np.float32) - 8.0
    assert torch.equal(dequantize(torch.from_numpy(blk4), "q4_0", (32,)),
                       torch.from_numpy(want * 0.5))
