"""Multi-process runtime: `torch.distributed` processes joined into one mesh,
and the leader-follower serving plane.

The JAX package's `parallel/distributed.py` on torch:

- `initialize` joins the processes: every one passes the coordinator's
  `HOST:PORT`, the process count and its own id (`add_args` /
  `init_from_args` give a CLI the reference's `--coordinator`,
  `--num-processes`, `--process-id`).  Every process takes its own share
  of the cards (`local_devices`): all it sees where no other process sees
  them (one `CUDA_VISIBLE_DEVICES` each), its 1/P slice in process order
  where every process sees the same cards.  Two groups come out of it: the
  control plane, gloo over host tensors, and the data plane that the mesh's
  dp rows are gathered over: NCCL where every process has cards of its own,
  gloo where processes share a card (NCCL refuses two ranks on one card)
  or run on the CPU.  gloo stages a card's tensors through the host.  The
  choice is printed.
- **Data plane.**  A mesh (parallel/mesh.py) gives each process dp/P of
  its rows; a tp group never spans processes.  `global_batch` takes a batch
  that is identical on every process, `local_batch` a per-process stream;
  `fetch_local` reads this process's rows of an output.
- **Control plane for serving.**  Every process must join every
  collective in the same order, so a multi-process server runs in
  lockstep: process 0 owns the sockets and broadcasts each device
  dispatch (a 4-slot header `[op, n_rows, payload_width, k]`, then its
  payload), and the followers replay it (`follower_loop`).  One lock,
  `_LEADER_LOCK`, orders every broadcast with its dispatch.
"""
from __future__ import annotations

import sys
import threading
from typing import Sequence

import numpy as np
import torch

from .mesh import DP_AXIS

# one lock orders EVERY leader-side broadcast+dispatch pair (engine embeds
# and index ops alike): followers replay strictly in broadcast order, so the
# leader must execute in that same order
_LEADER_LOCK = threading.Lock()

# leader -> follower opcodes (first slot of the fixed-size header broadcast)
OP_STOP = 0
OP_EMBED = 1
OP_INDEX = 2  # vector-index append (payload: f32 [n, E] normalized vectors)
OP_SEARCH = 3  # index search (payload: f32 padded queries; header[3] = k)
OP_SAVE = 4  # index persistence: followers join the corpus all-gather
OP_SPARSE_ENCODE = 5  # payload: i32 token matrix; header[3] = top-k width
OP_SPARSE_INDEX = 6  # payloads: i32 ids [n, Kd], f32 weights [n, Kd]
OP_SPARSE_SEARCH = 7  # payloads: i32 q ids, f32 q weights (-1 / 0 padded); header[3] = k
_HEADER_SHAPE = (4,)  # [op, n_rows, payload_width, k]


class DistGroup:
    """A `torch.distributed` group (`rank`, `size`) and the gather the dp
    plane needs.  gloo takes a card's tensors through the host."""

    def __init__(self, group, backend: str):
        import torch.distributed as dist

        self.group = group
        self.backend = backend
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.backend == "gloo" else t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (one shape on every rank), joined along rows in
        rank order."""
        import torch.distributed as dist

        x = self._staged(t).contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts).to(t.device)


class _World:
    def __init__(self, rank: int, size: int, control: DistGroup, data: DistGroup,
                 devices: list):
        self.rank, self.size, self.control, self.data = rank, size, control, data
        self.devices = devices


_WORLD: _World | None = None


def _all_gather(obj) -> list:
    """Every process's `obj`, in process order (over the control plane)."""
    import torch.distributed as dist

    seen: list = [None] * dist.get_world_size()
    dist.all_gather_object(seen, obj)
    return seen


def _card_uuids(devices) -> list[str] | None:
    """The cards' uuids, or None where a device is not a card."""
    devices = [torch.device(d) for d in devices]
    if not devices or any(d.type != "cuda" for d in devices):
        return None
    return [str(torch.cuda.get_device_properties(d).uuid) for d in devices]


def card_share(seen: list[list[str]], rank: int) -> list[int]:
    """Which of its visible cards process `rank` takes, from every
    process's list of visible card uuids (`seen`, in process order): all of
    them where no other process sees one of them; where every process sees
    the same cards, its slice of len // P in process order.  Anything else
    raises: a card two processes would both drive."""
    mine, procs = seen[rank], len(seen)
    others = {u for p, cards in enumerate(seen) if p != rank for u in cards}
    if not others & set(mine):
        return list(range(len(mine)))
    if all(cards == mine for cards in seen):
        per = len(mine) // procs
        if per == 0:
            raise ValueError(f"{len(mine)} card(s) cannot be shared by {procs} processes; "
                             "pass --device to run several processes on one card")
        return list(range(rank * per, (rank + 1) * per))
    raise ValueError("processes see overlapping but different cards; give each process "
                     "its own CUDA_VISIBLE_DEVICES, or let every process see the same cards")


def choose_backend(devices) -> str:
    """The data plane's backend: "nccl" where every process's devices are
    cards no other process uses, else "gloo" (processes sharing a card, or
    the CPU).  A collective over the control plane."""
    seen = _all_gather(_card_uuids(devices))
    if any(c is None for c in seen):
        return "gloo"
    flat = [c for cs in seen for c in set(cs)]
    return "nccl" if len(flat) == len(set(flat)) else "gloo"


def initialize(coordinator: str, num_processes: int, process_id: int, devices=None) -> str:
    """Join the processes (`coordinator` "host:port", the same on every
    process; process 0 binds it).  `devices`: this process's devices;
    by default its share of the visible cards (`card_share`), the CPU
    where there is none.  The data plane's backend is `choose_backend`'s
    for them; returns it."""
    import torch.distributed as dist

    global _WORLD
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id))
    control = DistGroup(dist.group.WORLD, "gloo")
    if devices is not None:
        devices = [torch.device(d) for d in devices]
    elif torch.cuda.is_available():
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        share = card_share(_all_gather(_card_uuids(visible)), int(process_id))
        devices = [visible[i] for i in share]
    else:
        devices = [torch.device("cpu")]
    backend = choose_backend(devices)
    data = control if backend == "gloo" else DistGroup(dist.new_group(backend="nccl"), "nccl")
    _WORLD = _World(int(process_id), int(num_processes), control, data, devices)
    print(f"distributed: process {process_id} of {num_processes} on "
          f"{', '.join(str(d) for d in devices)}, data plane {backend}, control plane gloo",
          file=sys.stderr, flush=True)
    return backend


def shutdown() -> None:
    """Leave the process group (after the serving loop has ended)."""
    import torch.distributed as dist

    global _WORLD
    if _WORLD is not None:
        dist.destroy_process_group()
        _WORLD = None


def backend() -> str | None:
    return None if _WORLD is None else _WORLD.data.backend


def process_count() -> int:
    return 1 if _WORLD is None else _WORLD.size


def process_index() -> int:
    return 0 if _WORLD is None else _WORLD.rank


def local_devices() -> list[torch.device]:
    """This process's devices (`initialize`'s), or every visible card in a
    single process."""
    if _WORLD is not None:
        return list(_WORLD.devices)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def is_multiprocess() -> bool:
    return process_count() > 1


def add_args(parser) -> None:
    """Attach the standard multi-process flags to an argparse parser."""
    parser.add_argument(
        "--coordinator", default=None, metavar="HOST:PORT",
        help="torch.distributed rendezvous address (process 0 binds it); "
             "enables the multi-process runtime",
    )
    parser.add_argument("--num-processes", type=int, default=1)
    parser.add_argument("--process-id", type=int, default=0)


def init_from_args(args, devices=None) -> bool:
    """initialize() from add_args flags; returns True if multi-process."""
    if args.coordinator is None:
        if getattr(args, "num_processes", 1) > 1:
            raise SystemExit("--num-processes > 1 requires --coordinator")
        return False
    initialize(args.coordinator, args.num_processes, args.process_id, devices=devices)
    return True


# --- data plane --------------------------------------------------------------
def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every process's rows of `t` (one shape on every process), joined in
    process order: the dp order of a multi-process mesh."""
    return t if _WORLD is None or _WORLD.size == 1 else _WORLD.data.all_gather(t)


def global_batch(mesh, arr: np.ndarray) -> torch.Tensor:
    """A batch that is identical on every process (leader-broadcast
    serving, tests) -> the tensor the sharded forwards split over dp; its
    rows must divide over dp."""
    arr = np.ascontiguousarray(arr)
    if arr.shape[0] % mesh.shape[DP_AXIS]:
        raise ValueError(f"{arr.shape[0]} rows do not split over dp={mesh.shape[DP_AXIS]}")
    return torch.from_numpy(arr)


def local_batch(mesh, local: np.ndarray):
    """This process's rows of a per-process batch stream (the global batch
    is every process's rows in process order)."""
    from .sharding import LocalBatch

    local = np.ascontiguousarray(local)
    if local.shape[0] % mesh.local_dp:
        raise ValueError(f"{local.shape[0]} local rows do not split over this process's "
                         f"{mesh.local_dp} dp rows")
    return LocalBatch(torch.from_numpy(local))


def fetch_local(arr) -> np.ndarray:
    """This process's rows of a dp-split output (no traffic between
    processes): a LocalBatch's rows, or this process's share of a whole
    batch's output."""
    from .sharding import LocalBatch

    if isinstance(arr, LocalBatch):
        arr = arr.rows
    else:
        per = arr.shape[0] // process_count()
        arr = arr[process_index() * per:(process_index() + 1) * per]
    return arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)


# --- serving control plane (leader-follower lockstep) ------------------------
def _encode_token_lists(token_lists: Sequence[Sequence[int]]) -> np.ndarray:
    """Ragged id lists -> one padded i32 matrix [n, 1+maxlen] (col 0 = len),
    the broadcastable wire form of a batch."""
    n = len(token_lists)
    maxlen = max((len(t) for t in token_lists), default=0)
    m = np.zeros((n, maxlen + 1), dtype=np.int32)
    for i, t in enumerate(token_lists):
        m[i, 0] = len(t)
        m[i, 1 : 1 + len(t)] = t
    return m


def _decode_token_lists(m: np.ndarray) -> list[list[int]]:
    return [row[1 : 1 + row[0]].tolist() for row in m]


def _broadcast(arr: np.ndarray) -> np.ndarray:
    """Process 0's `arr` on every process (its shape and dtype are the
    callers' agreement), over the gloo control plane."""
    import torch.distributed as dist

    t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    dist.broadcast(t, src=0, group=_WORLD.control.group)
    return t.numpy()


def _host(x, dtype) -> np.ndarray:
    """A tensor (on any device) or an array as a contiguous host array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype)


def _header(op: int, n: int = 0, width: int = 0, k: int = 0) -> None:
    _broadcast(np.array([op, n, width, k], np.int32))


def _require_leader(what: str) -> None:
    if process_index() != 0:
        raise RuntimeError(f"{what} runs on process 0 only")


def make_leader(engine) -> None:
    """Patch engine.embed_tokens (and sparse_tokens on an MLM model) on
    process 0 so every device dispatch is announced to the followers first;
    they replay the identical call, which keeps every process in lockstep.
    encode() and the server's frames all reach embed_tokens, so one patch
    covers the serving surface.  `_LEADER_LOCK` makes broadcast + execution
    one step: the server drives the engine from several threads."""
    _require_leader("make_leader")
    real = engine.embed_tokens

    def embed_tokens(token_lists):
        with _LEADER_LOCK:
            payload = _encode_token_lists(token_lists)
            _header(OP_EMBED, payload.shape[0], payload.shape[1])
            _broadcast(payload)
            return real(token_lists)

    engine.embed_tokens = embed_tokens

    if engine.config.mlm_head:
        real_sparse = engine.sparse_tokens

        def sparse_tokens(token_lists, k=256):
            with _LEADER_LOCK:
                payload = _encode_token_lists(token_lists)
                _header(OP_SPARSE_ENCODE, payload.shape[0], payload.shape[1], int(k))
                _broadcast(payload)
                return real_sparse(token_lists, k=k)

        engine.sparse_tokens = sparse_tokens


def make_leader_index(engine):
    """Process 0's VectorIndex over the multi-process mesh: its corpus rows
    split over every process's dp rows, so every commit, search and save
    broadcasts first and the followers replay it with the same inputs
    (follower_loop OP_INDEX / OP_SEARCH / OP_SAVE)."""
    from ..runtime.search import VectorIndex

    _require_leader("make_leader_index")

    class LeaderIndex(VectorIndex):
        _host_ingest_only = True  # every commit must broadcast to followers

        def _commit_vectors(self, vecs):
            with _LEADER_LOCK:
                _header(OP_INDEX, vecs.shape[0], vecs.shape[1])
                _broadcast(_host(vecs, np.float32))
                return super()._commit_vectors(vecs)

        def _run_search(self, q, k):
            with _LEADER_LOCK:
                _header(OP_SEARCH, q.shape[0], q.shape[1], k)
                _broadcast(_host(q, np.float32))
                return super()._run_search(q, k)

        def _snapshot_rows(self):
            # save(): the corpus rows all-gather over the processes
            with _LEADER_LOCK:
                _header(OP_SAVE)
                return super()._snapshot_rows()

    return LeaderIndex(engine, mesh=engine.mesh)


def make_leader_sparse_index(engine):
    """Process 0's device SparseIndex over the multi-process mesh: every
    commit of padded rows and every search broadcasts first (follower_loop
    OP_SPARSE_INDEX / OP_SPARSE_SEARCH)."""
    from ..runtime.sparse_search import SparseIndex

    _require_leader("make_leader_sparse_index")

    class LeaderSparseIndex(SparseIndex):
        def _commit_device(self, padded, base):
            di, dv = padded
            with _LEADER_LOCK:
                _header(OP_SPARSE_INDEX, di.shape[0], di.shape[1])
                _broadcast(_host(di, np.int32))
                _broadcast(_host(dv, np.float32))
                return super()._commit_device(padded, base)

        def _run_device_search(self, q_idx, q_val, k, candidates=None, prefix=8):
            # candidates mode is refused on a mesh before this is reached
            with _LEADER_LOCK:
                _header(OP_SPARSE_SEARCH, q_idx.shape[0], q_idx.shape[1], k)
                _broadcast(_host(q_idx, np.int32))
                _broadcast(_host(q_val, np.float32))
                return super()._run_device_search(q_idx, q_val, k)

    return LeaderSparseIndex(engine, device=True, mesh=engine.mesh)


def broadcast_stop() -> None:
    """Leader: release the followers (end of serving)."""
    _header(OP_STOP)


def follower_loop(engine) -> None:
    """Processes 1..P-1: replay the leader's device dispatches until STOP.
    The engine's planning is deterministic in its inputs, so replaying
    embed_tokens with the broadcast lists issues the same forwards and
    gathers in the same order as the leader.  Index ops replay into
    follower-local indexes over the same mesh; their results are
    discarded."""
    from ..runtime.search import VectorIndex
    from ..runtime.sparse_search import SparseIndex

    if process_index() == 0:
        raise RuntimeError("follower_loop runs on processes > 0")
    fidx = fsparse = None
    sparse_rows = 0
    while True:
        header = _broadcast(np.zeros(_HEADER_SHAPE, np.int32))
        op, n, width, k = (int(v) for v in header)
        if op == OP_STOP:
            return
        if op in (OP_EMBED, OP_SPARSE_ENCODE):
            lists = _decode_token_lists(_broadcast(np.zeros((n, width), np.int32)))
            if op == OP_EMBED:
                engine.embed_tokens(lists)
            else:
                engine.sparse_tokens(lists, k=k)
        elif op in (OP_SPARSE_INDEX, OP_SPARSE_SEARCH):
            if fsparse is None:
                fsparse = SparseIndex(engine, device=True, mesh=engine.mesh)
            a = _broadcast(np.zeros((n, width), np.int32))
            b = _broadcast(np.zeros((n, width), np.float32))
            with fsparse._lock:
                if op == OP_SPARSE_INDEX:
                    fsparse._commit_device((a, b), sparse_rows)
                    sparse_rows += n
                else:
                    fsparse._run_device_search(a, b, k)
        else:
            if fidx is None:
                fidx = VectorIndex(engine, mesh=engine.mesh)
            with fidx._lock:
                if op == OP_SAVE:
                    fidx._snapshot_rows()
                    continue
                payload = _broadcast(np.zeros((n, width), np.float32))
                if op == OP_INDEX:
                    fidx._commit_vectors(payload)
                elif op == OP_SEARCH:
                    fidx._run_search(payload, k)
                else:
                    raise RuntimeError(f"unknown leader op {op}")


def barrier() -> None:
    """Every process waits here (over the control plane)."""
    import torch.distributed as dist

    if _WORLD is not None:
        dist.barrier(group=_WORLD.control.group)


def log_once(msg: str) -> None:
    """Print from process 0 only."""
    if process_index() == 0:
        print(msg, file=sys.stderr)
