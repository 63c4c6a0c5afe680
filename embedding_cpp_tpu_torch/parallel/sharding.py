"""Megatron weight shards over a [dp, tp] mesh and the forwards that run
one body per mesh slot.

The JAX package has two distributed forwards: GSPMD (`parallel/sharding.py`,
XLA places the collectives) and `shard_map` (`parallel/shard_map_forward.py`,
explicit `psum`s so the Pallas kernels run inside).  torch has no GSPMD, so
the port keeps one path, shaped like the `shard_map` one:

- every slot (d, r) holds its own parameter dict (`shard_params`): q/k/v,
  up and gate are column-parallel (their N split over tp, with their
  biases), o and down row-parallel (K split over tp, in whole 32-blocks of
  a quantized weight's `qs` / `scales` / `mins`), everything else
  replicated; dp replicas on one device share one copy;
- a batch's rows split evenly over dp; the tp slots of a dp row run the
  model body at once, one thread each, on their shards with the hand
  kernels inside, and meet in the row-parallel linears' `all_reduce`
  (parallel/group.py); every slot then holds the same output and the dp
  rows' outputs are joined in dp order on local slot (0, 0)'s device;
- on a multi-process mesh every process runs its own dp rows of a batch
  that is identical on every process (the serving plane broadcasts it) and
  the rows are all-gathered over the processes (parallel/distributed.py);
  a per-process stream (`distributed.local_batch`) runs only its rows.

`ShardedForward` has the JAX package's three forms: plain, `.gather`
(the real rows' vectors only) and packed (`make_packed_forward`).  The
Engine's embedding forwards run through `.gather` and the packed form,
its other forwards (scores, sparse, token states) through
`ShardedParams.run`.
"""
from __future__ import annotations

import contextlib
import contextvars
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np
import torch

from ..models.bert import ComputeOptions, bert_embed_batch, bert_embed_packed
from ..models.config import BertConfig
from ..ops.qtensor import QTensor
from .group import ThreadGroup, using_tp
from .mesh import Mesh

# per-logical-weight split; the layer stack's leading L axis is never split
_COLUMN_PARALLEL = frozenset({"q_w", "k_w", "v_w", "ffn_up_w", "ffn_gate_w"})
_ROW_PARALLEL = frozenset({"o_w", "ffn_down_w"})
# the JAX package leaves nomic's gate bias out (its FFN-bias checkpoints would
# not shard there); the port splits it with its weight
_COLUMN_BIAS = frozenset({"q_b", "k_b", "v_b", "ffn_up_b", "ffn_gate_b"})


def _layer_axis(key: str, tp: int) -> int | None:
    """The axis of a layer-stacked tensor that tp splits: N of a
    column-parallel weight [L, K(/2), N] or bias [L, N], K of a row-parallel
    weight; None where the tensor replicates."""
    if tp > 1 and key in _COLUMN_PARALLEL:
        return 2
    if tp > 1 and key in _ROW_PARALLEL:
        return 1
    if tp > 1 and key in _COLUMN_BIAS:
        return 1
    return None


def _check_divisibility(config: BertConfig, tp: int) -> None:
    if tp == 1:
        return
    if config.n_head % tp:
        raise ValueError(f"n_head {config.n_head} not divisible by tp={tp}")
    for name, k in (("n_embd", config.n_embd), ("n_ff", config.n_ff)):
        if (k // 32) % tp:
            raise ValueError(
                f"{name}={k}: K/32={k//32} not divisible by tp={tp} "
                "(Q4 block alignment)"
            )


def _slice(t: torch.Tensor, axis: int, tp: int, r: int) -> torch.Tensor:
    n = t.shape[axis]
    return t.narrow(axis, r * (n // tp), n // tp)


def shard_leaf(leaf, axis: int | None, tp: int, r: int, device):
    """Slot r's piece of one parameter (a tensor or a QTensor, whose planes
    all carry N last and blocked K second) on `device`."""
    if axis is None:
        fn = lambda t: t.to(device)  # noqa: E731
    else:
        fn = lambda t: _slice(t, axis, tp, r).contiguous().to(device)  # noqa: E731
    if not isinstance(leaf, QTensor):
        return fn(leaf)
    out = leaf.map(fn)
    if axis is not None:  # the logical (K, N): stacked axes 1 / 2 are K / N
        k, n = leaf.shape
        out.shape = (k // tp, n) if axis == 1 else (k, n // tp)
    return out


def _shard_dict(params: dict, tp: int, r: int, device, in_layers: bool = False) -> dict:
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _shard_dict(v, tp, r, device, in_layers or k == "layers")
        else:
            out[k] = shard_leaf(v, _layer_axis(k, tp) if in_layers else None, tp, r, device)
    return out


class ShardedParams:
    """Every local slot's parameter dict: `slots[d][r]` for local dp row d
    and tp rank r.  Runs forwards on the mesh (`run`); one run at a time."""

    def __init__(self, slots: list[list[dict]], mesh: Mesh):
        self.slots = slots
        self.mesh = mesh
        self._lock = threading.Lock()
        self._pool = (ThreadPoolExecutor(mesh.local_dp * mesh.tp, "tp-slot")
                      if mesh.tp > 1 else None)

    def __getitem__(self, slot: tuple[int, int]) -> dict:
        d, r = slot
        return self.slots[d][r]

    def run(self, fn: Callable, rows: Sequence, kw: dict | None = None, *,
            local: bool = False) -> torch.Tensor:
        """fn(slot params, *row tensors, **kw) on every slot: `rows` (numpy
        or tensors, one row per batch row) split evenly over dp after the
        last row is repeated up to a multiple of it; the tensors of `kw` go
        to each slot's device.  Returns the dp rows' outputs joined in dp
        order on local slot (0, 0)'s device, cut to the rows given.  On a
        multi-process mesh `rows` is the whole batch, every process runs its
        own dp rows and the outputs are all-gathered, unless `local`: the
        rows are this process's alone and stay so."""
        mesh = self.mesh
        rows = [torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
                for a in rows]
        n = rows[0].shape[0]
        split = mesh.local_dp if (local or not mesh.multiprocess) else mesh.dp
        pad = -n % split
        if pad:
            rows = [torch.cat([a, a[-1:].expand(pad, *a.shape[1:])]) for a in rows]
        per = (n + pad) // split
        first = 0 if split == mesh.local_dp else mesh.dp_offset
        chunks = [[a[(first + d) * per:(first + d + 1) * per] for a in rows]
                  for d in range(mesh.local_dp)]
        with self._lock:
            outs = self._run_slots(fn, chunks, kw or {})
        home = mesh.device(0, 0)
        out = torch.cat([o.to(home) for o in outs])
        if mesh.multiprocess and not local:
            from . import distributed

            out = distributed.all_gather_rows(out)
        return out[:n]

    def _run_slots(self, fn, chunks, kw) -> list[torch.Tensor]:
        """Each local dp row's output (its tp rank 0's)."""
        mesh = self.mesh
        moved: dict = {}

        def args_for(d: int, r: int):
            dev = mesh.device(d, r)
            if dev not in moved:
                moved[dev] = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                              for k, v in kw.items()}
            return [a.to(dev) for a in chunks[d]], moved[dev]

        if self._pool is None:
            outs = []
            for d in range(mesh.local_dp):
                a, k = args_for(d, 0)
                with _on(mesh.device(d, 0)):
                    outs.append(fn(self.slots[d][0], *a, **k))
            return outs
        groups = [ThreadGroup(mesh.tp) for _ in range(mesh.local_dp)]
        grad, inference = torch.is_grad_enabled(), torch.is_inference_mode_enabled()
        futures = []
        for d in range(mesh.local_dp):
            for r in range(mesh.tp):
                a, k = args_for(d, r)

                def task(d=d, r=r, a=a, k=k):
                    try:
                        with _on(mesh.device(d, r)), torch.inference_mode(inference), \
                                torch.set_grad_enabled(grad), \
                                using_tp(groups[d].member(r)):
                            return fn(self.slots[d][r], *a, **k)
                    except BaseException:
                        groups[d].abort()  # the other slots of the row stop waiting
                        raise

                futures.append(self._pool.submit(contextvars.copy_context().run, task))
        errors = [e for e in (f.exception() for f in futures) if e is not None]
        if errors:  # the failing slot's error, not its siblings' broken barrier
            raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        return [futures[d * mesh.tp].result() for d in range(mesh.local_dp)]


def _on(device: torch.device):
    """The CUDA device context of a slot's launches (nothing on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_params(params: dict, config: BertConfig, mesh: Mesh) -> ShardedParams:
    """Every local slot's parameters: tp shards (`_layer_axis`) on the
    slot's device; dp replicas on one device share one copy."""
    tp = mesh.tp
    _check_divisibility(config, tp)
    cache: dict = {}
    slots = []
    for d in range(mesh.local_dp):
        row = []
        for r in range(tp):
            key = (mesh.device(d, r), r)
            if key not in cache:
                cache[key] = _shard_dict(params, tp, r, key[0])
            row.append(cache[key])
        slots.append(row)
    return ShardedParams(slots, mesh)


class LocalBatch:
    """Rows of a per-process batch stream: this process's rows only (the
    global batch is every process's rows in process order)."""

    def __init__(self, rows):
        self.rows = rows


def _rows(a):
    return a.rows if isinstance(a, LocalBatch) else a


class ShardedForward:
    """The distributed forward.  `__call__` gives every row's output (on a
    multi-process mesh this process's rows, as a LocalBatch: the JAX
    package's dp-sharded output, read with `distributed.fetch_local`);
    `.gather` the rows `gather_idx` of the whole batch on every process.
    Inputs are numpy or tensors; LocalBatch inputs are a per-process
    stream."""

    def __init__(self, config: BertConfig, opts: ComputeOptions):
        self.config = config
        self.opts = opts

    def _forward(self, p: ShardedParams, ids, mask, local: bool) -> torch.Tensor:
        return p.run(bert_embed_batch, (_rows(ids), _rows(mask)),
                     dict(config=self.config, opts=self.opts), local=local)

    def __call__(self, p: ShardedParams, ids, mask):
        local = isinstance(ids, LocalBatch)
        if p.mesh.multiprocess and not local:
            # this process's rows of the batch: no collective, as the JAX
            # package's dp-sharded output
            per = _rows(ids).shape[0] // p.mesh.process_count
            lo = p.mesh.process_index * per
            ids, mask = (LocalBatch(_rows(a)[lo:lo + per]) for a in (ids, mask))
            local = True
        out = self._forward(p, ids, mask, local)
        return LocalBatch(out) if local and p.mesh.multiprocess else out

    def gather(self, p: ShardedParams, ids, mask, gather_idx):
        local = isinstance(ids, LocalBatch)
        out = self._forward(p, ids, mask, local)
        if local and p.mesh.multiprocess:
            from . import distributed

            out = distributed.all_gather_rows(out)
        return out[torch.as_tensor(np.asarray(gather_idx), device=out.device).long()]


def shard_params_and_make_forward(params: dict, config: BertConfig, opts: ComputeOptions,
                                  mesh: Mesh) -> tuple[ShardedParams, ShardedForward]:
    """(every slot's parameters, the forward over them)."""
    return shard_params(params, config, mesh), ShardedForward(config, opts)


def make_packed_forward(mesh: Mesh, config: BertConfig, opts: ComputeOptions):
    """The packed forward: packed rows split over dp like plain rows; the
    flat slots `gather_idx` of [B * n_seg] are taken from the joined
    output."""

    def packed(p: ShardedParams, ids, seg, pos, gather_idx, n_seg: int,
               max_seg_len: int | None = None) -> torch.Tensor:
        out = p.run(bert_embed_packed, (ids, seg, pos),
                    dict(config=config, opts=opts, n_seg=n_seg, max_seg_len=max_seg_len))
        out = out.reshape(-1, out.shape[-1])
        return out[torch.as_tensor(np.asarray(gather_idx), device=out.device).long()]

    return packed
