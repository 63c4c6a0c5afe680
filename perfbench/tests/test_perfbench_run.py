"""Whole runs on the CPU (the harness's look for a card skipped) at a size a
test holds: the result line parses with every key and the compared
numbers last; a sound run comes out correct; with the timed path broken
underneath (an answer altered where it is produced, half of each call
left out and filled with the mean of the rest) or the fp8 control put in
the program's place, `correct` comes out false.  Published widths, six
layers, the cells' own limits: there the faults read 0.10-0.17 and sound
runs 0.007-0.010 against the limit of 0.06, as at full depth on the card
(PERF.md section 2)."""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest

from _cells import ROOT, SMALL, cut_cell

SEED = 2**31 + 21


def _run(cell: str, monkeypatch=None, fault=None, trace=False):
    from perfbench import harness

    w, c = cut_cell(cell, SMALL)
    if fault is not None:
        _break(monkeypatch, fault)
    return harness.run_cell(cell, SEED, 0.5, trace, device="cpu", workload=w, config=c)


def _break(monkeypatch, fault: str) -> None:
    from perfbench import check, harness

    make = harness._engine

    def broken_engine(run, path):
        eng = make(run, path)
        embed = eng.embed_tokens

        def embed_tokens(token_lists):
            out = embed(token_lists)
            if fault == "answer_altered" and len(out) > 1:
                out[[0, 1]] = out[[1, 0]]
            elif fault == "half_left_out" and len(out) > 1:
                half = (len(out) + 1) // 2
                mean = out[:half].mean(axis=0)
                out[half:] = mean / np.linalg.norm(mean)
            return out

        if fault == "control":
            encode_with_counts = eng.encode_with_counts

            def control(texts, **kw):
                _, counts = encode_with_counts(texts, **kw)
                prefix = eng.resolve_prompt(kw.get("prompt_name"), kw.get("prompt"))
                texts = [prefix + t for t in ([texts] if isinstance(texts, str) else texts)]
                return check.reference_vectors(run.config, run.vocab, run.seed, texts, "cpu",
                                               "fp8"), counts
            eng.encode_with_counts = control
        else:
            eng.embed_tokens = embed_tokens
        return eng

    monkeypatch.setattr(harness, "_engine", broken_engine)


@pytest.mark.parametrize("cell", ["bge-large.corpus", "modernbert.chunks"])
def test_sound_run_is_correct_and_its_line_parses(cell):
    result = _run(cell)
    line = json.loads(json.dumps(result))
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device", "check"}
    assert list(line)[-1] == "check"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert "setup_s" in line["metrics"]
    assert line["device"]["platform"] == "cpu"
    n = line["check"]["vec_gap"]
    assert 0 < n["value"] < n["limit"]


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out", "control"])
@pytest.mark.parametrize("cell", ["bge-large.corpus", "modernbert.docs8k", "modernbert.chunks"])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    result = _run(cell, monkeypatch, fault)
    assert result["correct"] is False, result["check"]


def test_traced_run_reports_per_layer_metrics():
    result = _run("bge-large.corpus", trace=True)
    assert "slot_occupancy.bulk" in result["metrics"]
    assert "tokenize_ms_per_ktok" in result["metrics"]
    assert "setup_s" not in result["metrics"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0


def test_cli_refuses_without_a_card():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "bge-large.corpus",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
