"""One run of one cell: set-up, the measured window, the traced slice, the
metrics, the comparison, and the result line.

Set-up (`setup_s`) runs from the process's start until the cell's shapes
are warm: import, the vocabulary, the weights drawn on the device from the
seed and written as a GGUF into $TMPDIR, `Engine.from_gguf` (the path a
user takes), the kernels built (`Engine.warmup`, which compiles only what
`embedding_cpp_tpu_torch/_build/` lacks), and one warm pass over the
cell's own shapes (`traffic/<kind>.py`'s `warm`).  Then the window
(`window`), with the benchmark's host spans recorded only in a traced run,
then in a traced run the profiled slice, then the program is freed and the
reference judges a sample of the window's answers (`check.py`).
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "embedding_cpp_tpu")
SLICE_SECONDS = 1.0
HOST_THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def process_age() -> float:
    """Seconds since this process started (Linux: /proc/self/stat's start
    time against /proc/uptime)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return float(Path("/proc/uptime").read_text().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return 0.0


def load_json(rel: str) -> dict:
    return json.loads((BENCH / rel).read_text())


def cache_env(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout, no JAX
    pulled in by a library, and one thread for PyTorch's and the math
    libraries' host pools (set before torch is imported): the window does
    no host tensor math, and idle pools left spinning would take cores
    from the tokenizer's threads."""
    cache = root / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var in HOST_THREAD_VARS:
        os.environ[var] = "1"


class Run:
    """What one run holds: its inputs, the engine, the spans and marks its
    traffic records, and what the per-layer readers read."""

    def __init__(self, workload: dict, config: dict, seed: int, seconds: float, trace: bool,
                 device: str):
        from .vocab import build_vocab

        self.workload, self.config = workload, config
        self.params = workload["params"]
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.vocab = build_vocab(config)
        self.engine = None
        self.marks: dict = {}
        self.tokenize = [0.0, 0]  # host seconds, tokens
        self.recording = False
        self.slice = None
        self.window: dict = {}
        self._profiler = None

    # --- what traffic modules call --------------------------------------------
    def span(self, name: str):
        """A host span (a profiler range) in a traced run; nothing otherwise."""
        if not self.trace:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function("bench." + name)

    def mark(self, which: str) -> None:
        from embedding_cpp_tpu_torch.utils.metrics import GLOBAL

        self.marks[which] = (time.perf_counter(), GLOBAL.snapshot()["counters"],
                             tuple(self.tokenize))

    def note(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    # --- counters over the window ---------------------------------------------
    def counter_delta(self, name: str) -> float:
        a, b = self.marks["start"][1], self.marks["end"][1]
        return float(b.get(name, 0.0) - a.get(name, 0.0))

    def tokenize_delta(self) -> tuple[float, int]:
        a, b = self.marks["start"][2], self.marks["end"][2]
        return b[0] - a[0], b[1] - a[1]

    # --- traced runs ----------------------------------------------------------
    def _start_slice(self) -> None:
        from .trace import Profiler

        self._profiler = Profiler()
        self.recording = True
        self._shapes, self._lengths = [], []
        self._profiler.start()

    def _stop_slice(self) -> None:
        s = self._profiler.stop()
        self.recording = False
        s.shapes, s.lengths = self._shapes, np.asarray(self._lengths, dtype=np.int64)
        self.slice = s

    def install_spans(self) -> None:
        """Host spans around the program's tokenizer, planning + launch and
        fetch, the tokenizer's time and tokens, and the shapes and texts
        launched while the slice records."""
        import torch

        import embedding_cpp_tpu_torch.runtime.engine as engine_mod

        eng, run = self.engine, self
        tokenize, dispatch, fetch = eng.tokenize_batch, eng._dispatch, engine_mod.fetch_output

        def tokenize_batch(texts, **kw):
            t = time.perf_counter()
            with torch.profiler.record_function("bench.tokenize"):
                out = tokenize(texts, **kw)
            run.tokenize[0] += time.perf_counter() - t
            run.tokenize[1] += sum(len(x) for x in out)
            return out

        def _dispatch(token_lists, opts=None):
            with torch.profiler.record_function("bench.dispatch"):
                pending = dispatch(token_lists, opts)
            if run.recording:
                run._shapes += [tuple(b.ids.shape) for b, _ in pending]
                run._lengths += [len(t) for t in token_lists]
            return pending

        def fetch_output(x):
            with torch.profiler.record_function("bench.fetch"):
                return fetch(x)

        eng.tokenize_batch, eng._dispatch = tokenize_batch, _dispatch
        engine_mod.fetch_output = fetch_output


def _engine(run: Run, path: str):
    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models.bert import ComputeOptions

    opts = ComputeOptions(dtype=run.config["activation_dtype"])
    return Engine.from_gguf(path, opts=opts, device=run.device,
                            **run.workload.get("engine", {}))


def setup(run: Run, times: dict) -> None:
    import torch

    from . import weights

    t = time.perf_counter()
    drawn = weights.draw(run.config, run.seed, run.device)
    if run.device != "cpu":
        torch.cuda.synchronize()
    times["draw"] = time.perf_counter() - t
    t = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".gguf", prefix="perfbench-")
    os.close(fd)
    try:
        weights.write_model(path, run.config, run.vocab, drawn)
        del drawn
        times["write"] = time.perf_counter() - t
        t = time.perf_counter()
        run.engine = _engine(run, path)
        times["load"] = time.perf_counter() - t
    finally:
        os.remove(path)
    t = time.perf_counter()
    run.engine.warmup([])  # builds what the checkout's _build/ lacks
    times["build"] = time.perf_counter() - t
    t = time.perf_counter()
    run.traffic.warm(run)
    if run.device != "cpu":
        torch.cuda.synchronize()
    times["warm"] = time.perf_counter() - t


def _metric_module(name: str):
    path = BENCH / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.layer_metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, cell: str, key: str) -> list[dict]:
    """The manifest's metrics of `key` this cell reports: those listing it
    under `workloads`, and those without the key."""
    return [m for m in manifest.get(key, []) if cell in m.get("workloads", [cell])]


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             workload: dict | None = None, config: dict | None = None,
             manifest: dict | None = None, t_start: float | None = None) -> dict:
    """Run one cell and return its result object (the keys of the last line)."""
    import torch

    import embedding_cpp_tpu_torch  # noqa: F401  (the program under test; fails fast without it)

    times = {"import": time.perf_counter() - t_start if t_start is not None else 0.0}
    workload = workload or load_json(f"workloads/{cell}.json")
    config = config or load_json(f"configs/{workload['config']}.json")
    if manifest is None:
        manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    run = Run(workload, config, seed, seconds, trace, device)
    run.traffic = importlib.import_module(f"perfbench.traffic.{workload['kind']}")
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    setup(run, times)
    setup_s = process_age() if device != "cpu" else sum(times.values())
    run.note("setup seconds: " + " ".join(f"{k} {v:.3f}" for k, v in times.items())
             + f" total {setup_s:.3f}")
    if trace:
        run.install_spans()
    gc.collect()  # set-up's garbage, not the window's
    gc.freeze()  # and set-up's objects left out of the window's collections
    win = run.traffic.window(run)
    run.window = win
    if trace:
        run._start_slice()
        run.traffic.traced_slice(run, SLICE_SECONDS)
        run._stop_slice()
    peak = int(torch.cuda.max_memory_allocated()) if device != "cpu" else 0
    kind = torch.cuda.get_device_name(0) if device != "cpu" else "cpu"
    run.card = kind
    # per-layer readers see the run before the program is freed
    metrics = {}
    if trace:
        for m in cell_metrics(manifest, cell, "per_layer"):
            value = _metric_module(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(win["e2e"], setup_s=setup_s)
        for m in cell_metrics(manifest, cell, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    engine_stats = dict(run.engine.stats)
    run.engine = None
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    from . import check

    correct, numbers = check.compare(run, win)
    run.note(f"reference check seconds {time.perf_counter() - t:.3f}; window "
             f"{win['seconds']:.3f} s ({win.get('making_s', 0.0):.3f} s of text making left "
             f"out), {win['attempted']} texts; engine "
             f"{engine_stats['sentences']} sentences {engine_stats['batches']} batches")
    dev = {"platform": "gpu" if device != "cpu" else "cpu", "kind": kind,
           "count": int(workload["chips"]), "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics, "device": dev}
    if trace and run.slice is not None:
        dev["busy_s"] = run.slice.busy_s
        dev["window_s"] = run.slice.window_s
        result["breakdown"] = {"device_ops": run.slice.device_ops(),
                               "idle_gaps": run.slice.idle_gaps(
                                   unnamed=getattr(run.traffic, "IDLE", "other"))}
    result["check"] = numbers
    return result


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
