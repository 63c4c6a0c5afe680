"""Format `run_eval`'s result JSONs as markdown tables.

The port's copy of the JAX package's `benchmarks/print_tables.py` (the
reference's benchmarks/print_tables.py:23-69): one table per model, one
row per mode, score + eval-time columns per task, so the numbers line up
against BASELINE.md directly; below each table, the devices its results
ran on.  It reads `--results DIR` (default: `run_eval`'s, `eval_results/`
at the repository root).

    python -m embedding_cpp_tpu_torch.benchmarks.print_tables [--results DIR]
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict
from pathlib import Path

from .run_eval import DEFAULT_RESULTS

TASKS = ("STSBenchmark", "EmotionClassification", "SyntheticRetrieval")
MODE_ORDER = ("f32", "f16", "q4_0", "q4_1", "q8_0", "gguf", "sbert",
              "sbert-batchless")


def _device_name(device) -> str:
    if isinstance(device, dict):
        return f"{device.get('nvidia_smi_name', device.get('name'))}, {device.get('power_limit')}"
    return str(device)


def collect(results: Path = DEFAULT_RESULTS):
    """{model: {mode: {task: (score, eval seconds, device)}}}"""
    models = defaultdict(dict)
    for d in sorted(results.iterdir()) if results.exists() else []:
        if not d.is_dir() or "_" not in d.name:
            continue
        # mode is a known suffix (q4_0 etc. contain underscores themselves)
        for mode in sorted(MODE_ORDER, key=len, reverse=True):
            if d.name.endswith(f"_{mode}"):
                model = d.name[: -len(mode) - 1]
                break
        else:
            model, _, mode = d.name.rpartition("_")
        for f in d.glob("*.json"):
            data = json.loads(f.read_text())
            test = data.get("test", {})
            score = test.get("cos_sim", {}).get("spearman", test.get("main_score"))
            models[model].setdefault(mode, {})[f.stem] = (
                score, test.get("evaluation_time"), _device_name(data.get("device")))
    return models


def tables(models) -> str:
    out = []
    for model, modes in models.items():
        out.append(f"\n### {model}\n")
        header = "| mode |"
        sep = "|---|"
        for t in TASKS:
            header += f" {t} score | {t} time (s) |"
            sep += "---|---|"
        out += [header, sep]
        ordered = sorted(modes, key=lambda m: MODE_ORDER.index(m) if m in MODE_ORDER else 99)
        for mode in ordered:
            row = f"| {mode} |"
            for t in TASKS:
                if t in modes[mode]:
                    score, tm, _ = modes[mode][t]
                    row += f" {score:.4f} | {tm} |"
                else:
                    row += " - | - |"
            out.append(row)
        devices = sorted({dev for m in modes.values() for (_, _, dev) in m.values()})
        out.append(f"\ndevice: {'; '.join(devices)}")
    return "\n".join(out)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--results", type=Path, default=DEFAULT_RESULTS)
    args = p.parse_args(argv)
    models = collect(args.results)
    if not models:
        print("no results in", args.results)
        return
    print(tables(models))


if __name__ == "__main__":
    main()
