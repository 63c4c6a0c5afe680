"""The tensor-parallel group a shard's forward reduces over.

One forward body runs per mesh slot, on that slot's weight shards (column-
parallel q/k/v/up/gate, row-parallel o/down: parallel/sharding.py).  The
body's only hook into the distribution is the group of its dp row's tp
slots: `current_tp()` gives it (None on one device), with the slot's
`rank`, the group's `size` and `all_reduce(t)`, which the row-parallel
linears call on their f32 partial products (ops/linear.py).  It takes the
place of the JAX package's `opts.tp_axis` / `inside_shard_map`.

A tp group never spans processes, so its one implementation is
`ThreadGroup`: the tp slots of one process, one thread each.  The partials
meet at a barrier and every slot sums them in f32 in tp order, so every
slot holds the same bits.  What crosses processes (dp rows, the serving
plane) goes over parallel/distributed.py's `torch.distributed` groups.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading

import torch

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("tp_group", default=None)


def current_tp():
    """The tp group member of the running shard, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def using_tp(member):
    """Within the block, `current_tp()` is `member`."""
    token = _CURRENT.set(member)
    try:
        yield member
    finally:
        _CURRENT.reset(token)


class ThreadGroup:
    """The `size` tp slots of one dp row in this process, one thread each.
    `member(rank)` is the handle a slot's forward reduces through; `abort()`
    releases the others when one slot fails, so no thread waits forever."""

    def __init__(self, size: int, timeout: float | None = None):
        self.size = int(size)
        self._parts: list = [None] * self.size
        self._barrier = threading.Barrier(self.size, timeout=timeout)

    def member(self, rank: int) -> "ThreadRank":
        return ThreadRank(self, rank)

    def abort(self) -> None:
        self._barrier.abort()


class ThreadRank:
    """Slot `rank` of a ThreadGroup."""

    def __init__(self, group: ThreadGroup, rank: int):
        self.group = group
        self.rank = int(rank)
        self.size = group.size

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The f32 sum of every slot's `t`, added in tp order on this
        slot's device (the same bits on every slot)."""
        g = self.group
        g._parts[self.rank] = t
        g._barrier.wait()
        acc = g._parts[0].to(t.device, torch.float32)
        for p in g._parts[1:]:
            acc = acc + p.to(t.device, torch.float32)
        g._barrier.wait()  # every slot has read the parts before the next call writes them
        return acc
