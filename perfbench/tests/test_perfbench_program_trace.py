"""The readers of the program's own ranges (`program_trace.py` and the four
metrics that use it) on hand-built profiler events, where each value is
known: a kernel linked under `op.norm` inside a forward, a ctypes-style
kernel linked straight to `op.linear`, an idle gap inside `tokenize`.  The
program's ranges, CPU ops, leave the readers of device operations as they
were; a run without them, or without a device row, gives None."""
from __future__ import annotations

import importlib.util
from collections import namedtuple
from types import SimpleNamespace

import numpy as np
import pytest

from _cells import ROOT, TINY, cut_cell

Kernel = namedtuple("Kernel", ["name", "device", "duration"])
CPU, CUDA = SimpleNamespace(name="CPU"), SimpleNamespace(name="CUDA")
NEW = ("residual_norm_us_per_ktok", "rope_us_per_ktok", "tokenize_idle_share.bulk",
       "plan_ms_per_ktok")
OLD = ("elementwise_us_per_ktok", "q4_matmul_roofline", "attention_roofline",
       "idle_share.bulk")


def _reader(name: str):
    path = ROOT / "perfbench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ev(name, t0, t1, parent=None, kernels=(), device=CPU, user=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=t0, end=t1),
                           cpu_parent=parent, kernels=list(kernels), device_type=device,
                           is_user_annotation=user)


def _kernel(name, t0, t1):
    """A device operation as the profiler lists it: on the device's row,
    and under its op's `kernels`."""
    return _ev(name, t0, t1, device=CUDA)


def _program_events():
    """One call on the profiler's clock (us): the benchmark's slice and
    encode annotations; the program's tokenize 100-400 (no device work),
    plan 400-420, launch 420-900 over a copy of the ids (5 us, listed twice),
    an embedding gather, a LayerNorm (a mean of 30 us under op.norm), a
    linear whose kernel the program launched through ctypes (400 us, linked
    straight to op.linear), a residual add (20 us) and an attention kernel
    (50 us, through ctypes too); the fetch's copy (10 us)."""
    sl = _ev("bench.slice", 0, 2000, user=True)
    enc = _ev("bench.encode", 50, 1900, sl, user=True)
    encode = _ev("encode", 60, 1890, enc)
    tok = _ev("tokenize", 100, 400, encode)
    ev = _ev("eval", 400, 1500, encode)
    plan = _ev("plan", 400, 420, ev)
    launch = _ev("launch", 420, 900, ev)
    h2d = _ev("aten::copy_", 421, 425, launch, [Kernel("Memcpy HtoD", 0, 5.0)])
    # the profiler's own host event, listing the same copy again
    buf = _ev("Activity Buffer Request", 425, 426, launch, [Kernel("Memcpy HtoD", 0, 5.0)])
    emb = _ev("op.embed", 430, 460, launch)
    gather = _ev("aten::index", 431, 440, emb, [Kernel("index_kernel", 0, 40.0)])
    norm = _ev("op.norm", 461, 500, emb)
    mean = _ev("aten::mean", 462, 470, norm, [Kernel("reduce_kernel", 0, 30.0)])
    lin = _ev("op.linear", 501, 600, launch,
              [Kernel("q4_matmul_tc_kernel<bf16>", 0, 400.0)])
    res = _ev("op.residual", 601, 610, launch)
    add = _ev("aten::add", 602, 609, res, [Kernel("elementwise_add", 0, 20.0)])
    att = _ev("op.attention", 611, 700, launch, [Kernel("attn_long_tc_kernel<64>", 0, 50.0)])
    fetch = _ev("fetch", 900, 1500, ev)
    copy = _ev("aten::copy_", 1000, 1490, fetch, [Kernel("Memcpy DtoH", 0, 10.0)])
    finish = _ev("finish", 1500, 1600, encode)
    host = [sl, enc, encode, tok, ev, plan, launch, h2d, buf, emb, gather, norm, mean, lin,
            res, add, att, fetch, copy, finish]
    device = [_kernel("Memcpy HtoD", 430, 435), _kernel("index_kernel", 500, 540),
              _kernel("reduce_kernel", 540, 570),
              _kernel("q4_matmul_tc_kernel<bf16>", 600, 1000),
              _kernel("elementwise_add", 1000, 1020),
              _kernel("attn_long_tc_kernel<64>", 1020, 1070),
              _kernel("Memcpy DtoH", 1400, 1410),
              _kernel("bench.encode", 50, 1900)]  # the annotation's device-row mirror
    return host + device


def _run(events, *, device="cuda", with_ranges=True):
    """A traced run whose slice `trace.Profiler` reduced from `events`."""
    from perfbench import harness
    from perfbench.trace import Profiler

    if not with_ranges:
        from perfbench.program_trace import is_program_range

        events = [e for e in events if not is_program_range(e.name)]
    prof = Profiler()
    prof._prof = SimpleNamespace(stop=lambda: None, events=lambda: events)
    prof._range = SimpleNamespace(__exit__=lambda *a: None)
    prof._t0 = __import__("time").perf_counter()
    s = prof.stop()
    s.window_s = 2000e-6
    s.shapes = [(1, 512)]
    s.lengths = np.array([300, 200], dtype=np.int64)
    w, c = cut_cell("modernbert.chunks", TINY)
    run = harness.Run(w, c, 1, 1.0, True, device)
    run.slice, run._profiler, run.card = s, prof, "NVIDIA H100 80GB HBM3"
    return run


def test_kernel_under_norm_and_residual_inside_a_forward():
    run = _run(_program_events())
    # (30 + 20) us over 500 real tokens
    assert _reader("residual_norm_us_per_ktok")(run) == pytest.approx(50.0 / 0.5)
    assert _reader("rope_us_per_ktok")(run) == 0.0


def test_ctypes_kernel_links_straight_to_its_range():
    from perfbench.program_trace import program_trace

    run = _run(_program_events())
    pt = program_trace(run)
    assert pt.device_us == {"op.embed": 40.0, "op.norm": 30.0, "op.linear": 400.0,
                            "op.residual": 20.0, "op.attention": 50.0, "fetch": 10.0,
                            "launch": 5.0}
    # each device operation counted once: all of the slice's, none twice
    assert sum(pt.device_us.values()) * 1e-6 == pytest.approx(
        run.slice.kernel_seconds(lambda name: True))
    assert pt.span_seconds("plan") == pytest.approx(20e-6)


def test_idle_gap_inside_tokenize():
    run = _run(_program_events())
    # device busy 430-435, 500-570, 600-1070, 1400-1410 of 0-2000: the gap
    # 0-430 has its midpoint (215) inside tokenize (100-400); the others not
    assert _reader("tokenize_idle_share.bulk")(run) == pytest.approx(100.0 * 430 / 2000)
    assert _reader("tokenize_idle_share.bulk")(run) <= _reader("idle_share.bulk")(run)
    # 20 us of planning over 500 tokens
    assert _reader("plan_ms_per_ktok")(run) == pytest.approx(0.020 / 0.5)


@pytest.mark.parametrize("metric", OLD)
def test_existing_readers_unmoved_by_the_program_ranges(metric):
    with_ranges = _reader(metric)(_run(_program_events()))
    without = _reader(metric)(_run(_program_events(), with_ranges=False))
    assert with_ranges is not None and with_ranges == without


def test_slice_has_no_program_range_as_a_device_operation():
    from perfbench.program_trace import is_program_range

    s = _run(_program_events()).slice
    assert not any(is_program_range(name) for name, _, _ in s.kernels)
    assert [k[0] for k in s.device_ops()] == ["q4_matmul_tc_kernel<bf16>",
                                              "attn_long_tc_kernel<64>", "index_kernel",
                                              "reduce_kernel", "elementwise_add",
                                              "Memcpy DtoH", "Memcpy HtoD"]


@pytest.mark.parametrize("metric", NEW)
def test_readers_give_nothing_without_the_program_ranges_or_a_device_row(metric):
    read = _reader(metric)
    assert read(_run(_program_events(), with_ranges=False)) is None
    assert read(SimpleNamespace(slice=None, _profiler=None)) is None
    host_only = [e for e in _program_events() if e.device_type is CPU]
    for e in host_only:
        e.kernels = []
    value = read(_run(host_only, device="cpu"))
    if metric == "plan_ms_per_ktok":  # a host span: read where the program ran
        assert value == pytest.approx(0.020 / 0.5)
    else:
        assert value is None


def test_cpu_traced_run_reads_the_program_spans():
    """A whole traced run on the CPU (the profiler's CPU row only): the
    program's plan span is read, the device metrics are left out."""
    from perfbench import harness

    w, c = cut_cell("bge-large.corpus", TINY)
    result = harness.run_cell("bge-large.corpus", 2**31 + 5, 0.3, True, device="cpu",
                              workload=w, config=c)
    assert result["metrics"]["plan_ms_per_ktok"]["value"] > 0
    for name in ("residual_norm_us_per_ktok", "tokenize_idle_share.bulk"):
        assert name not in result["metrics"]
