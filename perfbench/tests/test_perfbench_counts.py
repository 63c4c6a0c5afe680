"""`counts.py` against counts made by hand for one layer, and the pairs
from lengths against the frozen copies of the port's pair counting."""
from __future__ import annotations

import numpy as np
import pytest

import _cells  # noqa: F401  (puts the repo root on sys.path)


def _cfg(arch: str, layers: int = 1) -> dict:
    from perfbench import harness

    name = {"bert": "bge-large-en-v1.5.q8_0", "modernbert": "gte-modernbert-base.q4_0"}[arch]
    c = harness.load_json(f"configs/{name}.json")
    c["num_hidden_layers"] = layers
    return c


def test_bert_layer_flops_by_hand():
    from perfbench import counts

    c = _cfg("bert")
    # q, k, v, o: 1024 x 1024 each; up 1024 x 4096; down 4096 x 1024
    by_hand = 2 * (4 * 1024 * 1024 + 2 * 1024 * 4096)
    assert counts.linear_flops_per_token(c) == by_hand
    # one text of 100 tokens: 100^2 pairs, 4 x 1024 a pair (QK^T + PV, 16 heads of 64)
    assert counts.attention_flops(c, [100]) == 4 * 1024 * 100 * 100
    assert counts.model_flops(c, [100]) == by_hand * 100 + 4 * 1024 * 100 * 100


def test_modernbert_layers_flops_by_hand():
    from perfbench import counts

    c = _cfg("modernbert", layers=3)  # global, local, local
    per_layer = 2 * (768 * 2304 + 768 * 768 + 768 * 2304 + 1152 * 768)
    assert counts.linear_flops_per_token(c) == 3 * per_layer
    n = 1000
    local = n * 129 - 64 * 65  # keys within 64 of each query
    assert counts.attention_pairs(c, [n]) == n * n + 2 * local
    assert counts.attention_flops(c, [n]) == 4 * 768 * (n * n + 2 * local)


def test_linear_bound_by_hand():
    from perfbench import counts
    from perfbench.peaks import PEAKS

    c = _cfg("bert")
    peaks = PEAKS["H100"]
    m = 128 * 512
    total = 0.0
    for k, n in [(1024, 1024)] * 4 + [(1024, 4096), (4096, 1024)]:
        flops = 2 * m * k * n
        nbytes = k * n * 34 / 32 + 2 * m * k + 2 * m * n
        total += max(flops / peaks[1], nbytes / peaks[0])
    assert counts.linear_bound_s(c, [(128, 512)], peaks) == pytest.approx(total, rel=1e-12)
    # Q4_0 moves 18 bytes a block
    small = counts.linear_bound_s(dict(c, qtype="q4_0"), [(1, 1)], peaks)
    assert small == pytest.approx(sum(
        (k * n * 18 / 32 + 2 * (k + n)) / peaks[0]
        for k, n in [(1024, 1024)] * 4 + [(1024, 4096), (4096, 1024)]), rel=1e-12)


def test_attention_bound_counts_real_tokens_and_pairs():
    from perfbench import counts
    from perfbench.peaks import PEAKS

    c = _cfg("bert")
    peaks = PEAKS["H100"]
    lens = [100, 200]
    flops = 4 * 1024 * (100 ** 2 + 200 ** 2)
    nbytes = 4 * 2 * 1024 * 300
    want = max(flops / peaks[1], nbytes / peaks[0])
    assert counts.attention_bound_s(c, lens, peaks) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("window", [None, 16, 128])
def test_text_pairs_match_the_frozen_segment_counting(window):
    from perfbench.pairs import segment_pairs, segment_window_pairs, text_pairs

    rng = np.random.default_rng(4)
    lens = rng.integers(1, 300, 40)
    # rows filled exactly, no padding: the frozen copies count only real pairs
    seg = np.concatenate([np.full(n, i, np.int32) for i, n in enumerate(lens)])[None]
    want = segment_pairs(seg) if window is None else segment_window_pairs(seg, window)
    assert text_pairs(lens, None if window is None else window // 2) == want
