"""The port's spans and op ranges (`utils/metrics.py`): the Engine's request
path and the op families on the profiler's clock, none of them a user
annotation (so nothing of them reaches the device's row), the spans'
timers with no profiler and no range built then, and the batcher's spans.
Synthetic BERT and ModernBERT engines on the CPU, a few seconds in all."""
from __future__ import annotations

import asyncio
import json
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from embedding_cpp_tpu_torch import Engine
from embedding_cpp_tpu_torch.models import MINILM_L6, MODERNBERT_BASE
from embedding_cpp_tpu_torch.utils import metrics

REQUEST_SPANS = ["encode", "tokenize", "plan", "launch", "fetch", "finish"]
OP_RANGES = {
    "bert": ["op.embed", "op.linear", "op.residual", "op.norm", "op.attention", "op.pool"],
    "modernbert": ["op.embed", "op.linear", "op.residual", "op.norm", "op.attention",
                   "op.rope", "op.pool"],
}
CONFIGS = {
    "bert": replace(MINILM_L6, n_vocab=300, n_embd=64, n_head=4, n_ff=128, n_layer=2,
                    n_ctx=128),
    "modernbert": replace(MODERNBERT_BASE, n_vocab=300, n_embd=64, n_head=4, n_ff=96,
                          n_layer=3, n_ctx=256, local_window=16),
}
# 40 short texts and two long ones: packed rows and a plain bucket both run
TEXTS = [f"word{i % 7} text number {i}" for i in range(40)] + ["long " * 60, "longer " * 90]
USER_SCOPE = 7  # at::RecordScope::USER_SCOPE, what record_function gives


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def engine(request):
    torch.manual_seed(0)
    return request.param, Engine.synthetic(CONFIGS[request.param], "q4_0", device="cpu")


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _descendants(e):
    for c in e.cpu_children:
        yield c
        yield from _descendants(c)


def _program(name: str) -> bool:
    return name in REQUEST_SPANS or name == "eval" or name.startswith("op.")


def test_encode_spans_nest_in_order_on_one_thread(engine):
    _, eng = engine
    events = _profiled(lambda: eng.encode(TEXTS)).events()
    (enc,) = [e for e in events if e.name == "encode"]
    inner = sorted((e for e in _descendants(enc) if e.name in REQUEST_SPANS),
                   key=lambda e: e.time_range.start)
    assert [e.name for e in inner] == REQUEST_SPANS[1:]
    for e in inner:
        assert e.thread == enc.thread
        assert enc.time_range.start <= e.time_range.start <= e.time_range.end \
            <= enc.time_range.end
    (ev,) = [e for e in _descendants(enc) if e.name == "eval"]
    assert {c.name for c in ev.cpu_children if _program(c.name)} == {"plan", "launch", "fetch"}


def test_forward_shows_every_op_family_with_its_aten_children(engine):
    arch, eng = engine
    events = _profiled(lambda: eng.encode(TEXTS)).events()
    (launch,) = [e for e in events if e.name == "launch"]
    under = list(_descendants(launch))
    for name in OP_RANGES[arch]:
        ranges = [e for e in under if e.name == name]
        assert ranges, name
        assert any(c.name.startswith("aten::") for e in ranges for c in e.cpu_children), name
    if arch == "bert":
        assert not [e for e in events if e.name == "op.rope"]


def test_no_program_range_is_a_user_annotation(engine, tmp_path):
    _, eng = engine
    prof = _profiled(lambda: eng.encode(TEXTS))
    mine = [e for e in prof.events() if _program(e.name)]
    assert {e.name for e in mine} >= set(REQUEST_SPANS)
    for e in mine:
        assert e.scope != USER_SCOPE, e.name
        assert not getattr(e, "is_user_annotation", False), e.name
        assert e.device_type.name == "CPU", e.name
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    cats = {ev.get("cat") for ev in json.loads(path.read_text())["traceEvents"]
            if _program(str(ev.get("name", "")))}
    assert cats == {"cpu_op"}


def test_spans_time_without_a_profiler_and_build_no_range(engine, monkeypatch):
    _, eng = engine
    built = []

    class Counted:
        def __init__(self, name):
            built.append(name)
            self._rf = torch._C._profiler._RecordFunctionFast(name)

        def __enter__(self):
            return self._rf.__enter__()

        def __exit__(self, *exc):
            return self._rf.__exit__(*exc)

    monkeypatch.setattr(metrics, "_RecordFunctionFast", Counted)
    before = metrics.GLOBAL.snapshot()
    want = eng.encode(TEXTS)
    after = metrics.GLOBAL.snapshot()
    assert built == []
    for name in REQUEST_SPANS + ["eval"]:
        assert after["timer_counts"][name] == before["timer_counts"].get(name, 0) + 1, name
        assert after["timers_s"][name] >= before["timers_s"].get(name, 0.0)
    # the same call while a profiler records builds the ranges, and
    # returns the same vectors
    got = []
    _profiled(lambda: got.append(eng.encode(TEXTS)))
    assert set(REQUEST_SPANS) <= set(built) and "op.linear" in built
    np.testing.assert_array_equal(got[0], want)


def test_batcher_records_queue_wait_batch_form_and_executor_wait(engine):
    from embedding_cpp_tpu_torch.runtime.server import ContinuousBatcher

    _, eng = engine
    names = ("queue_wait", "batch_form", "executor_wait")
    before = metrics.GLOBAL.snapshot()["timer_counts"]

    async def drive():
        b = ContinuousBatcher(eng, window_ms=50.0)
        await b.start()
        try:
            outs = await asyncio.gather(b.encode(TEXTS[:3]), b.encode(TEXTS[3:5]),
                                        b.encode(TEXTS[5:6]))
        finally:
            await b.stop()
        return b.stats.batches, outs

    batches, outs = asyncio.run(drive())
    after = metrics.GLOBAL.snapshot()["timer_counts"]
    grew = {n: after.get(n, 0) - before.get(n, 0) for n in names}
    assert grew == {"queue_wait": 3, "batch_form": batches, "executor_wait": batches}
    assert batches >= 1
    np.testing.assert_allclose(np.concatenate(outs), eng.encode(TEXTS[:6]), atol=1e-5)
