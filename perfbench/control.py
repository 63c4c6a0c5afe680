"""Readings that set a cell's limit on `vec_gap` (see check.py), on the
card, in one process:

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--seconds 3]

For each seed: the cell's set-up and a short window of its own traffic at
its own sizes, then the program's reading (`vec_gap` of the sample against
the f32 reference), and on the control seeds the control's reading (the
same reference computed with fp8 operands, `reference/common.Precision`,
put in the program's place) and the nearest two distinct texts' vectors
(what an answer landing in another text's row would read).  One JSON line
per seed on standard output.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def readings(cell: str, seed: int, seconds: float, control: bool, *, device: str = "cuda",
             workload: dict | None = None, config: dict | None = None) -> dict:
    import importlib

    import numpy as np
    import torch

    from perfbench import check, harness

    workload = workload or harness.load_json(f"workloads/{cell}.json")
    config = config or harness.load_json(f"configs/{workload['config']}.json")
    run = harness.Run(workload, config, seed, seconds, False, device)
    run.traffic = importlib.import_module(f"perfbench.traffic.{workload['kind']}")
    times: dict = {}
    harness.setup(run, times)
    win = run.traffic.window(run)
    run.engine = None
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    texts, got = check.sample(win["answers"], seed,
                              workload["check"].get("sample", check.SAMPLE))
    ref = check.reference_vectors(config, run.vocab, seed, texts, device)
    out = {"cell": cell, "seed": seed, "texts": len(texts), "window_s": win["seconds"],
           "program_vec_gap": float(check.gaps(got, ref).max()),
           "program_vec_gap_median": float(np.median(check.gaps(got, ref)))}
    if control:
        ctl = check.reference_vectors(config, run.vocab, seed, texts, device, "fp8")
        out["control_vec_gap"] = float(check.gaps(ctl, ref).max())
        out["control_vec_gap_median"] = float(np.median(check.gaps(ctl, ref)))
        d = np.linalg.norm(ref[:, None].astype(np.float64) - ref[None], axis=-1)
        same = np.array([[a == b for b in texts] for a in texts])
        out["nearest_other_text"] = float(d[~same].min()) if (~same).any() else None
    return out


def main(argv=None) -> int:
    from perfbench import harness

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    harness.cache_env()
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for s in args.seeds.split(","):
        t = time.perf_counter()
        r = readings(args.workload, int(s), args.seconds, int(s) in controls)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
