"""The traffic generator: the same seed gives the same calls, another seed
other ones, lengths stay in their bounds, the framed lengths it reports
are the token counts, and the vocabulary's words have English-like
lengths."""
from __future__ import annotations

import numpy as np
import pytest

from _cells import TINY, cut_cell


class _Run:
    def __init__(self, cell, seed, sizes=TINY):
        from perfbench.vocab import build_vocab

        self.workload, self.config = cut_cell(cell, sizes)
        self.params = self.workload["params"]
        self.seed = seed
        self.vocab = build_vocab(self.config)


@pytest.mark.parametrize("cell", ["bge-large.corpus", "modernbert.docs8k", "modernbert.chunks"])
def test_bulk_calls_are_deterministic_by_seed(cell):
    from perfbench.traffic.bulk_encode import call_texts

    a, b, c = _Run(cell, 2**31 + 7), _Run(cell, 2**31 + 7), _Run(cell, 2**31 + 8)
    for k in (0, 1, 5):
        ta, la = call_texts(a, k)
        tb, lb = call_texts(b, k)
        assert ta == tb and np.array_equal(la, lb)
        assert call_texts(c, k)[0] != ta
    assert call_texts(a, 0)[0] != call_texts(a, 1)[0]


def test_corpus_lengths_follow_the_passage_profile():
    from perfbench.traffic.bulk_encode import lengths

    rng = np.random.default_rng(0)
    n = lengths(rng, {"dist": "normal", "mean": 60, "std": 20, "min": 20, "max": 126}, 20000)
    assert n.min() == 22 and n.max() <= 128
    assert 60 < n.mean() < 64
    d = lengths(rng, {"dist": "loguniform", "min": 4097, "max": 8192}, 20000)
    assert d.min() >= 4097 and d.max() <= 8192
    assert abs(np.median(d) - np.sqrt(4097 * 8193)) < 120
    u = lengths(rng, {"dist": "uniform", "min": 128, "max": 512}, 20000)
    assert u.min() == 128 and u.max() == 512


@pytest.mark.parametrize("cell", ["bge-large.corpus", "modernbert.docs8k"])
def test_reported_lengths_are_the_ports_token_counts(cell):
    from perfbench.reference.common import TextIds
    from perfbench.traffic.bulk_encode import call_texts

    run = _Run(cell, 2**31 + 9)
    texts, framed = call_texts(run, 3)
    ids = TextIds(run.vocab, 1 << 30)
    assert [len(ids(t)) for t in texts] == framed.tolist()


@pytest.mark.parametrize("cell", ["bge-large.corpus", "modernbert.docs8k"])
def test_vocabulary_words_have_english_lengths(cell):
    from perfbench import harness
    from perfbench.vocab import build_vocab

    w = harness.load_json(f"workloads/{cell}.json")
    voc = build_vocab(harness.load_json(f"configs/{w['config']}.json"))
    assert build_vocab(harness.load_json(f"configs/{w['config']}.json")).tokens == voc.tokens
    n = np.array([len(voc.words[i]) for i in voc.word_ids])
    assert len(set(voc.words[voc.word_ids])) == len(n) > 10000
    assert 5.0 < n.mean() < 6.5 and n.min() >= 2 and n.max() <= 16
