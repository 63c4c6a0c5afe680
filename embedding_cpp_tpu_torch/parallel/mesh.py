"""Device meshes: a [dp, tp] grid of torch devices.

The JAX package's `parallel/mesh.py` on torch.  dp splits a batch's rows:
every dp slot runs the whole model on its rows.  tp splits each layer's
weights Megatron-style (parallel/sharding.py): the slots of one dp row run
one forward together and sum their partial products (parallel/group.py).

Where it differs from the JAX mesh, deliberately:
- `devices` may name one device more than once: several slots on one card,
  or on the CPU (the counterpart of XLA's
  `--xla_force_host_platform_device_count`).  The slots then run one after
  another on that device.
- On a multi-process run (parallel/distributed.py) every process builds
  the mesh from its own devices: `devices` is the local grid of dp/P rows,
  and `shape` the global one.  A tp group never spans processes; dp does,
  in process order (process p holds dp rows p*dp/P .. (p+1)*dp/P - 1).
"""
from __future__ import annotations

import numpy as np
import torch

DP_AXIS = "dp"
TP_AXIS = "tp"


class Mesh:
    """A [dp, tp] mesh.  `devices`: this process's [dp / processes, tp]
    grid of `torch.device`s; `shape`: {"dp": dp, "tp": tp} over every
    process; `dp_offset`: the global dp index of this process's first row."""

    def __init__(self, devices: np.ndarray, dp: int, process_index: int = 0,
                 process_count: int = 1):
        self.devices = devices
        self.shape = {DP_AXIS: int(dp), TP_AXIS: int(devices.shape[1])}
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.local_dp = int(devices.shape[0])
        self.dp_offset = self.process_index * self.local_dp

    @property
    def dp(self) -> int:
        return self.shape[DP_AXIS]

    @property
    def tp(self) -> int:
        return self.shape[TP_AXIS]

    @property
    def multiprocess(self) -> bool:
        return self.process_count > 1

    def device(self, d: int = 0, r: int = 0) -> torch.device:
        """The device of local slot (d, r)."""
        return self.devices[d, r]

    def __repr__(self) -> str:
        names = [[str(x) for x in row] for row in self.devices]
        return (f"Mesh(dp={self.dp}, tp={self.tp}, process {self.process_index} of "
                f"{self.process_count}, devices={names})")


def make_mesh(dp: int | None = None, tp: int = 1, devices=None) -> Mesh:
    """Build a (dp, tp) mesh.  dp defaults to n_devices // tp.  `devices`
    defaults to every visible card, on a multi-process run to this
    process's share of them (`distributed.local_devices`); no card raises.
    A multi-process run counts every process's devices, each process
    passing its own."""
    from . import distributed

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass devices=['cpu'] * n to build "
                               "a mesh on the CPU")
        devices = distributed.local_devices()
    devices = [torch.device(d) for d in devices]
    procs, rank = distributed.process_count(), distributed.process_index()
    n = len(devices) * procs
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh sizes must be >= 1, got dp={dp} tp={tp}")
    if dp * tp > n:
        raise ValueError(f"mesh {dp}x{tp} needs {dp*tp} devices, have {n}")
    if dp % procs:
        raise ValueError(f"dp={dp} not divisible by {procs} processes (a tp group never "
                         "spans processes)")
    local = dp // procs
    grid = np.empty((local, tp), dtype=object)
    for i, d in enumerate(devices[: local * tp]):
        grid[i // tp, i % tp] = d
    return Mesh(grid, dp, rank, procs)


def single_device_mesh(device) -> Mesh:
    """The [1, 1] mesh of one device, in this process alone: the storage
    layout of an index without a mesh (runtime/search.py `ShardedRows`)."""
    return Mesh(np.array([[torch.device(device)]], dtype=object), 1)
