"""Scaling harness: throughput vs device count on a dp(xtp) mesh.

The port's copy of the JAX package's `benchmarks/scaling.py`.  North-star
target (BASELINE.json): >= 85% scaling efficiency from 1 card to N.  Each
count runs the MiniLM-L6-shaped forward (Q4_0 weights) over
`--batch-per-device` rows of `--seq` tokens a dp slot through
`parallel.sharding.shard_params_and_make_forward`, best of `--iters`.

Where the slots are: by default the visible cards (dp = 1, 2, 4, ... as
many as there are), and the JSON gives each count's efficiency against
dp = 1.  With `--device D`, every slot is that one device (the mesh's
devices repeat), so the slots run one after another: the JSON then gives
sentences/s per (dp, tp) and no efficiency, and says so (`slots`).

Multi-process (one process per host or card, every one running this
script with the same `--coordinator`, `--num-processes` and its own
`--process-id`): each process feeds its own rows
(`parallel.distributed.local_batch`) and fetches its own outputs
(`fetch_local`), and the processes meet at a barrier before each timed
run; the JSON gives the global sentences/s.

    python -m embedding_cpp_tpu_torch.benchmarks.scaling [--device cuda:0 --dp 1 2 4]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..parallel import distributed as dist

CONFIG = dict(n_vocab=2048, n_ctx=512, n_embd=384, n_layer=6, n_head=12, n_ff=1536,
              name="scaling")


def measure(dp: int, tp: int, batch_per_device: int, seq: int, iters: int,
            devices=None, dtype: str = "float32") -> float:
    """Global sentences/s of the sharded forward on a [dp, tp] mesh of
    `devices` (default: the visible cards)."""
    import torch

    from ..models.bert import ComputeOptions
    from ..models.config import BertConfig
    from ..models.params import random_params
    from ..parallel.mesh import make_mesh
    from ..parallel.sharding import shard_params_and_make_forward

    multiprocess = dist.is_multiprocess()
    config = BertConfig(**CONFIG)
    params = random_params(config, "q4_0", seed=0)
    mesh = make_mesh(dp=dp, tp=tp, devices=devices)
    sharded, fwd = shard_params_and_make_forward(params, config,
                                                 ComputeOptions(dtype=dtype), mesh)
    batch = batch_per_device * dp
    rng = np.random.default_rng(dist.process_index())

    def sync():
        for d in {mesh.device(i, r) for i in range(mesh.local_dp) for r in range(tp)}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    if multiprocess:
        # the per-process batch stream: each process feeds ONLY its local
        # dp rows — no data-plane traffic between processes
        local_rows = batch // dist.process_count()
        ids = rng.integers(0, config.n_vocab, size=(local_rows, seq)).astype(np.int32)
        args = (dist.local_batch(mesh, ids),
                dist.local_batch(mesh, np.ones((local_rows, seq), np.int32)))

        def run_once():
            dist.fetch_local(fwd(sharded, *args))  # each process fetches its own rows
    else:
        ids = rng.integers(0, config.n_vocab, size=(batch, seq)).astype(np.int32)
        args = (ids, np.ones((batch, seq), np.int32))

        def run_once():
            fwd(sharded, *args).cpu()

    run_once()  # warmup: the kernels build at first use
    best = float("inf")
    for _ in range(iters):
        if multiprocess:
            dist.barrier()
        sync()
        t0 = time.perf_counter()
        run_once()
        best = min(best, time.perf_counter() - t0)
    return batch / best  # sentences/sec (global)


def main(argv=None) -> dict | None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch-per-device", type=int, default=64)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--dp", type=int, nargs="+", default=None,
                   help="dp counts to measure (default: 1, 2, 4, ... while dp x tp "
                        "devices exist; with --device: 1 2 4)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--device", default=None,
                   help="put every slot on this one device (e.g. cuda:0, or cpu to run "
                        "the plain PyTorch versions of the kernels); default: the "
                        "visible cards, one slot each")
    dist.add_args(p)
    args = p.parse_args(argv)
    multihost = dist.init_from_args(args)

    from ..runtime.engine import resolve_device
    from ..utils.profiling import device_block

    one_device = resolve_device(args.device) if args.device is not None else None
    if one_device is None and not dist.local_devices():
        resolve_device(None)  # raises: no card, and no --device
    n = len(dist.local_devices()) * dist.process_count()
    if multihost:
        # every process runs the SAME program over the full global mesh,
        # each feeding its own stream
        counts = [n // args.tp]
    elif args.dp:
        counts = args.dp
    elif one_device is not None:
        counts = [1, 2, 4]
    else:
        counts = [c for c in (1, 2, 4, 8, 16, 32) if c * args.tp <= n]
    results = {}
    base = None
    for dp in counts:
        devices = [one_device] * (dp * args.tp) if one_device is not None else None
        sps = measure(dp, args.tp, args.batch_per_device, args.seq, args.iters, devices,
                      args.dtype)
        base = base or sps
        row = {"sentences_per_sec": round(sps, 1)}
        if one_device is None and not multihost:
            row["efficiency"] = round(sps / (base * dp), 3)
        results[dp] = row
        dist.log_once(f"dp={dp:3d} tp={args.tp}: {sps:10.1f} sentences/s"
                      + (f"  efficiency {row['efficiency'] * 100:5.1f}%"
                         if "efficiency" in row else ""))
    if multihost and dist.process_index() != 0:
        return None
    if one_device is not None:
        slots = (f"every slot on {one_device}: the slots run one after another, so "
                 "there is no scaling efficiency")
    elif multihost:
        slots = ("one program over every process's cards: global sentences/s; the "
                 "efficiency is this figure against a one-process run of the script")
    else:
        slots = "one slot a card: efficiency against dp = 1"
    result = {
        "metric": "dp_scaling_efficiency",
        "platform": (one_device or dist.local_devices()[0]).type,
        "processes": dist.process_count(),
        "batch_per_device": args.batch_per_device,
        "seq": args.seq,
        "tp": args.tp,
        "slots": slots,
        "results": results,
        "device": device_block(one_device or dist.local_devices()[0]),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
