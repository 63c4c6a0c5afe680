"""The port's metrics against the JAX package's (`utils/metrics.py`), its
profiling helpers (`utils/profiling.py`: the torch.profiler trace, the
roofline bound, the card's peaks), and the kernel suite's refusal to
measure without a GPU."""
import pytest

from embedding_cpp_tpu.utils.metrics import Metrics as JMetrics
from embedding_cpp_tpu_torch.utils import metrics, profiling


def _drive(m) -> dict:
    for name, value in (("sentences", 3), ("tokens", 41), ("padded_slots", 64),
                        ("batches", 1), ("tokens", 9)):
        m.inc(name, value)
    with m.timer("eval"):
        pass
    with m.timer("eval"):
        pass
    return m.snapshot()


def test_metrics_snapshot_matches_jax():
    ours, theirs = _drive(metrics.Metrics()), _drive(JMetrics())
    assert set(ours) == set(theirs)
    assert ours["counters"] == theirs["counters"]
    assert ours["timer_counts"] == theirs["timer_counts"] == {"eval": 2}
    assert ours["batch_occupancy"] == theirs["batch_occupancy"] == round(50 / 64, 4)
    m = metrics.Metrics()
    _drive(m)
    m.reset()
    assert m.snapshot()["counters"] == {}


@pytest.mark.parametrize("write", [False, True], ids=["in-memory", "chrome-trace"])
def test_trace_profiles_the_region(tmp_path, write):
    """`trace` yields the profiler with the region's ops; with a log_dir it
    also writes the Chrome trace there."""
    import torch

    with profiling.trace(str(tmp_path) if write else None) as prof:
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    assert any("mm" in ev.key for ev in prof.key_averages())
    assert (tmp_path / "trace.json").exists() == write


def test_bound_is_the_larger_of_bytes_and_operations():
    bw, rate = profiling.PEAKS["H100"]
    assert profiling.bound_ms(bw * 1e-3, 1.0, (bw, rate)) == (1.0, "bytes")
    assert profiling.bound_ms(1.0, rate * 2e-3, (bw, rate)) == (2.0, "operations")
    assert profiling.peaks_for("NVIDIA H100 80GB HBM3") == ("H100", (bw, rate))
    assert profiling.peaks_for("NVIDIA H100 PCIe")[0] == "H100 PCIe"
    with pytest.raises(RuntimeError):
        profiling.peaks_for("NVIDIA A100-SXM4-80GB")


def test_kernel_suite_refuses_to_run_without_a_gpu():
    import torch

    from embedding_cpp_tpu_torch.benchmarks import kernels

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the suite would run")
    with pytest.raises(SystemExit, match="no CUDA device"):
        kernels.main([])


@pytest.mark.parametrize("json_lines", [True, False], ids=["json", "text"])
def test_logging_matches_jax(capsys, monkeypatch, json_lines):
    """`get_logger` / `log_event` (exported by `utils`) write what the JAX
    package's write, as JSON lines with TPUEMBED_LOG_JSON=1 (the fields
    beside "msg") or as text; both packages log under "tpuembed"."""
    import json
    import logging

    from embedding_cpp_tpu.utils import logging as jlog
    from embedding_cpp_tpu_torch.utils import get_logger, log_event

    root = logging.getLogger("tpuembed")
    monkeypatch.setattr(root, "handlers", [])
    if json_lines:
        monkeypatch.setenv("TPUEMBED_LOG_JSON", "1")
    else:
        monkeypatch.delenv("TPUEMBED_LOG_JSON", raising=False)
    lines = []
    for get, event in ((get_logger, log_event), (jlog.get_logger, jlog.log_event)):
        root.handlers.clear()
        logger = get("server")
        assert logger.name == "tpuembed.server" and not root.propagate
        event(logger, "batch done", sentences=4, tokens=37)
        lines.append(capsys.readouterr().err.strip().splitlines()[-1])
    if json_lines:
        ours, theirs = (json.loads(line) for line in lines)
        assert ours.pop("ts") > 0 and theirs.pop("ts") > 0
        assert ours == theirs == {"level": "INFO", "logger": "tpuembed.server",
                                  "msg": "batch done", "sentences": 4, "tokens": 37}
    else:
        assert [line.split(" ", 2)[2] for line in lines] == [
            "INFO tpuembed.server: batch done"] * 2
    root.handlers.clear()
