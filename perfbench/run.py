"""Run one cell of BENCHMARK.json on the card and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m perfbench.run ...`) from the root of a checkout.  The last
line of standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device` and, traced, `breakdown`; `check` comes last,
each compared number beside its limit, and the same numbers are the last
lines of standard error.  Exits non-zero, printing no result, where the
card or the cell's chips are missing, or where JAX or the JAX package has
been loaded.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    from perfbench import harness

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.cache_env()
    workload = harness.load_json(f"workloads/{args.workload}.json")

    import torch

    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(workload["chips"]):
        print(f"needs {workload['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              workload=workload, t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, n in result["check"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
