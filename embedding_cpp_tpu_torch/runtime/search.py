"""On-device vector index: the corpus embeddings stay in the device's memory
and a query batch returns only its top-k (id, score) pairs.

The JAX package's `runtime/search.py` on torch.  The similarity product
([Q, E] x [E, N]) and the top-k selection run where the vectors are, and
only k ids and scores per query cross to the host.  Vectors are unit rows,
so a dot product is a cosine.

The helpers here are shared by the sparse and MaxSim indexes: the exact
top-k with the JAX package's order (`select_topk`), f32 products without
TF32 (`exact_f32`), the padding of a result to the requested width
(`pad_to_k`), and the corpus storage: rows dp-sharded over a mesh
(`ShardedRows`; an index without a mesh holds one shard on its device),
searched in two stages, a top-k in every shard and a merge of the shards'
candidates that orders equal scores by the lower id (`merge_topk`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import numpy as np
import torch

from ..parallel.mesh import single_device_mesh

# the JAX package's bound on an index's rows (its ids ride an f32 result
# there); kept so both packages refuse the same corpora
MAX_INDEX_ROWS = 1 << 24
# bytes of one [Qc, N] block of f32 scores and int64 selection keys
_SCORE_BUDGET = 1 << 30
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_PRECISION_LOCK = threading.Lock()


def index_dtype(dtype) -> torch.dtype:
    """"float32" / "bfloat16" (or the torch dtype) -> the torch dtype."""
    if isinstance(dtype, torch.dtype) and dtype in _DTYPES.values():
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"index dtype must be float32 or bfloat16, got {dtype!r}")
    return _DTYPES[dtype]


@contextlib.contextmanager
def exact_f32():
    """f32 matmuls inside run at full f32 precision (no TF32 on the card),
    whatever the process set; the setting is restored after."""
    with _PRECISION_LOCK:
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(prev)


def unit(x: torch.Tensor) -> torch.Tensor:
    """Rows of `x` as f32 unit vectors (a zero row stays zero)."""
    x = x.float()
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)).clamp_min(1e-12)


def grown(buf: torch.Tensor | None, need: int, shape: tuple, dtype, device) -> torch.Tensor:
    """`buf` with room for `need` rows (of `shape` each): the same buffer
    while it has room, else a new one of twice the rows (at least `need`)
    holding its rows; past MAX_INDEX_ROWS it raises."""
    if need > MAX_INDEX_ROWS:
        raise ValueError(f"index would exceed {MAX_INDEX_ROWS} rows")
    cap = 0 if buf is None else buf.shape[0]
    if need <= cap:
        return buf
    out = torch.zeros((min(max(need, 2 * cap), MAX_INDEX_ROWS), *shape), dtype=dtype,
                      device=device)
    if cap:
        out[:cap] = buf
    return out


def _ordered_keys(vals: torch.Tensor, ids: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest int64 keys over `vals` (f32, [..., m]; their `ids`
    int64, below 2^32, broadcast against them), which hold the value's total
    order (-0.0 below 0.0) above the reversed id, so every key is distinct
    and equal values come by the lower id."""
    bits = vals.contiguous().view(torch.int32).to(torch.int64)
    # negative floats order by their magnitude bits reversed
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.topk(bits * (1 << 32) + (0xFFFFFFFF - ids), k, dim=-1).values


def _ordered(vals: torch.Tensor, ids: torch.Tensor, k: int) -> torch.Tensor:
    """The ids of the k largest `vals`, equal values by the lower id
    (`_ordered_keys`)."""
    return 0xFFFFFFFF - (_ordered_keys(vals, ids, k) & 0xFFFFFFFF)


def select_topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., n] f32 -> (scores, ids int64) [..., k], descending, equal
    scores by the lower index (`lax.top_k`'s order), ids -1 where the score
    is not finite.  `torch.topk` orders ties freely: it takes the 2k best
    scores, and where every row's k-th score beats its 2k-th (so all the
    scores tied with it are among them) only those are ordered by
    (score, index); otherwise the whole row is."""
    scores = scores.float()
    n = scores.shape[-1]
    ids = None
    if 0 < 2 * k < n:
        vals, cand = torch.topk(scores, 2 * k, dim=-1)
        if bool((vals[..., k - 1] > vals[..., -1]).all()):
            ids = _ordered(vals, cand, k)
    if ids is None:
        ids = _ordered(scores, torch.arange(n, device=scores.device), k)
    vals = torch.gather(scores, -1, ids)
    return vals, torch.where(torch.isfinite(vals), ids, -1)


def merge_topk(parts, k: int, mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The second stage of a sharded search: every local shard's (scores,
    global ids) [Q, k_i] (`select_topk`'s, ids -1 where none) -> the k best
    over every shard of the mesh (all-gathered over its processes), equal
    scores by the lower id, id -1 where the score is not finite."""
    if len(parts) == 1 and not (mesh is not None and mesh.multiprocess):
        return parts[0]  # one shard's select_topk is in that order already
    dev = parts[0][0].device
    q = parts[0][0].shape[0]  # a shard without rows passes [Q, 0]
    scores = torch.full((q, k * len(parts)), -torch.inf, device=dev)
    ids = torch.full((q, k * len(parts)), -1, dtype=torch.int64, device=dev)
    for j, (s, i) in enumerate(parts):
        scores[:, j * k: j * k + s.shape[1]] = s.to(dev)
        ids[:, j * k: j * k + s.shape[1]] = i.to(dev)
    if mesh is not None and mesh.multiprocess:
        from ..parallel import distributed

        scores = distributed.all_gather_rows(scores.T.contiguous()).T
        ids = distributed.all_gather_rows(ids.T.contiguous()).T
    key = _ordered_keys(scores, torch.where(ids < 0, 0xFFFFFFFF, ids), k)
    bits = key >> 32
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int32)
    vals = bits.view(torch.float32)
    top = 0xFFFFFFFF - (key & 0xFFFFFFFF)
    return vals, torch.where(torch.isfinite(vals), top, -1)


class ShardedRows:
    """An index's rows dp-sharded over a mesh: global row r lives in dp
    shard r % dp at local row r // dp, so appends stay balanced and a
    growing corpus moves no row.  This process holds its own dp rows'
    shards, each on its dp row's tp rank 0 device.  `fields`: {name:
    (row shape, dtype)}.  `mesh` None: one shard on `device`, the layout
    of an index without a mesh."""

    def __init__(self, mesh, fields: dict, device=None):
        self.mesh = mesh if mesh is not None else single_device_mesh(device)
        self.dp = self.mesh.dp
        self.fields = fields
        self.bufs = [dict.fromkeys(fields) for _ in range(self.mesh.local_dp)]

    def count(self, g: int, n: int) -> int:
        """Rows of global shard g among the first n."""
        return max(0, -(-(n - g) // self.dp))

    def reserve(self, n: int) -> None:
        """Room for the first n rows in every local shard (a capacity asked
        ahead, or a batch of appends written in any order)."""
        for d, bufs in enumerate(self.bufs):
            need = self.count(self.mesh.dp_offset + d, n)
            for name, (shape, dtype) in self.fields.items():
                if need:
                    bufs[name] = grown(bufs[name], need, shape, dtype, self.mesh.device(d, 0))

    def put(self, rows, **values) -> None:
        """Write values[name][i] at global row rows[i], growing the shards.
        `rows`: a range (an append: each shard takes a strided slice of the
        values into a run of its rows, by slices) or int64 ids in any order
        (every process passes the same)."""
        if isinstance(rows, range):
            self._put_range(rows, values)
            return
        rows = torch.as_tensor(rows, dtype=torch.int64).cpu()
        if rows.numel() and int(rows.max()) >= MAX_INDEX_ROWS:
            raise ValueError(f"index would exceed {MAX_INDEX_ROWS} rows")
        for d, bufs in enumerate(self.bufs):
            g = self.mesh.dp_offset + d
            sel = torch.nonzero(rows % self.dp == g)[:, 0]
            if not sel.numel():
                continue
            local = rows[sel] // self.dp
            dev = self.mesh.device(d, 0)
            ldev = local.to(dev)
            for name, (shape, dtype) in self.fields.items():
                bufs[name] = grown(bufs[name], int(local.max()) + 1, shape, dtype, dev)
                v = torch.as_tensor(values[name])
                if len(sel) < len(v):  # one shard takes every row as it is
                    v = v[sel.to(v.device)]
                bufs[name].index_copy_(0, ldev, v.to(dev, dtype))

    def _put_range(self, rows: range, values: dict) -> None:
        if len(rows) and rows.stop > MAX_INDEX_ROWS:
            raise ValueError(f"index would exceed {MAX_INDEX_ROWS} rows")
        for d, bufs in enumerate(self.bufs):
            g = self.mesh.dp_offset + d
            first = rows.start + (g - rows.start) % self.dp  # its first row of the range
            count = len(range(first, rows.stop, self.dp))
            if not count:
                continue
            lo, dev = first // self.dp, self.mesh.device(d, 0)
            for name, (shape, dtype) in self.fields.items():
                bufs[name] = grown(bufs[name], lo + count, shape, dtype, dev)
                v = torch.as_tensor(values[name])[first - rows.start::self.dp]
                bufs[name][lo: lo + count] = v.to(dev, dtype)

    def shards(self, n: int):
        """(global shard g, {name: its first rows of the n, or None where it
        holds none}) of every local shard."""
        for d, bufs in enumerate(self.bufs):
            g = self.mesh.dp_offset + d
            c = self.count(g, n)
            yield g, {name: b[:c] if c else None for name, b in bufs.items()}

    def top_k(self, n: int, k: int, q: int, top) -> tuple[torch.Tensor, torch.Tensor]:
        """The sharded search over the first n rows: `top(fields, k')` gives
        a local shard's (scores, local ids) [q, k'], its top k' rows; the
        shards' candidates, as global ids, merge into the k best
        (`merge_topk`).  A shard without rows joins the merge all the same
        (on a multi-process mesh the merge is a collective)."""
        parts = []
        home = self.mesh.device(0, 0)
        for g, fields in self.shards(n):
            if next(iter(fields.values())) is None:
                parts.append((torch.empty((q, 0), device=home),
                              torch.empty((q, 0), dtype=torch.int64, device=home)))
                continue
            s, i = top(fields, min(k, self.count(g, n)))
            parts.append((s, torch.where(i >= 0, i * self.dp + g, -1) if self.dp > 1 else i))
        return merge_topk(parts, k, self.mesh)

    def gather(self, n: int, name: str) -> torch.Tensor:
        """Field `name` of the first n rows in global order, on local slot
        (0, 0)'s device (all-gathered over the processes)."""
        if self.dp == 1:
            return self.bufs[0][name][:n]
        shape, dtype = self.fields[name]
        per = -(-n // self.dp)
        home = self.mesh.device(0, 0)
        stack = torch.zeros((self.mesh.local_dp, per, *shape), dtype=dtype, device=home)
        for d, bufs in enumerate(self.bufs):
            c = self.count(self.mesh.dp_offset + d, n)
            if c:
                stack[d, :c] = bufs[name][:c].to(home)
        if self.mesh.multiprocess:
            from ..parallel import distributed

            stack = distributed.all_gather_rows(stack)
        return stack.transpose(0, 1).reshape(per * self.dp, *shape)[:n]


def pad_to_k(ids: torch.Tensor, scores: torch.Tensor, k: int) -> tuple[np.ndarray, np.ndarray]:
    """A [Q, k'] device result -> host (ids int32, scores f32) [Q, k]: the
    slots past k' (k clamped to the corpus) carry id -1 and score -inf."""
    ids, scores = ids.cpu().numpy().astype(np.int32), scores.cpu().numpy()
    q, kk = ids.shape
    out_i = np.full((q, k), -1, np.int32)
    out_s = np.full((q, k), -np.inf, np.float32)
    out_i[:, :kk], out_s[:, :kk] = ids, scores
    return out_i, out_s


def similarity(q: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """[Q, E] x [N, E] -> [Q, N] f32 (call under `exact_f32`).  A bf16
    corpus takes bf16 queries, whose products are exact in f32 and are
    summed in f32 (the JAX package's preferred_element_type): never a bf16
    result."""
    if corpus.dtype == torch.float32:
        return q @ corpus.T
    if corpus.is_cuda:
        return torch.mm(q, corpus.T, out_dtype=torch.float32)
    return q.float() @ corpus.float().T


class VectorIndex:
    """Exact top-k over engine embeddings, resident on the engine's device.

    dtype="bfloat16" halves the corpus bytes; scores still sum in f32.
    `exact=False` keeps the JAX package's signature: its TPU selection
    (`lax.approx_max_k`, recall target 0.99) has no torch counterpart, so
    both settings run the exact selection (recall 1.0).  The corpus rows
    are `ShardedRows`: dp-sharded over `mesh`, else one shard on the
    engine's device; a search takes a top-k in every shard and merges them
    (`merge_topk`).  On a multi-process mesh every process makes the same
    calls (parallel/distributed.py's serving plane).
    Thread-safe: one lock covers adds and searches (the server calls from
    executor threads)."""

    # device ingest is off for subclasses that must see every commit on the
    # host (the multi-process leader broadcasts them)
    _host_ingest_only = False

    def __init__(self, engine, dtype: str = "bfloat16", mesh=None, exact: bool = True):
        self.engine = engine
        self.dtype = index_dtype(dtype)
        self.mesh = mesh
        self.device = mesh.device(0, 0) if mesh is not None else engine.device
        self.exact = bool(exact)
        self._rows = ShardedRows(mesh, {"vectors": ((engine.n_embd,), self.dtype)},
                                 self.device)
        self._n = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self._n

    def _device_ingest_ok(self) -> bool:
        mesh = self.mesh or self.engine.mesh
        return not self._host_ingest_only and not (mesh is not None and mesh.multiprocess)

    # --- building -----------------------------------------------------------
    def add(self, texts: Sequence[str]) -> int:
        """Embed the texts (with the model's document prompt) and append
        them; returns the total indexed.  The vectors go from the forward
        into the corpus on the device (`Engine.embed_tokens_device`), unit
        rows again where the model does not normalize; a multi-process
        mesh takes them through the host, where every commit is
        broadcast."""
        texts = list(texts)
        prefix = self.engine.document_prompt_prefix()
        if prefix:
            texts = [prefix + t for t in texts]
        if not self._device_ingest_ok():
            return self.add_vectors(self.engine.encode(texts, prompt=""))
        token_lists = self.engine.tokenize_batch(texts)
        with self._lock:
            base = self._n
            self._rows.reserve(base + len(texts))
            for positions, vecs in self.engine.embed_tokens_device(token_lists):
                vecs = vecs.float() if self.engine.config.normalize else unit(vecs)
                self._rows.put(base + positions, vectors=vecs)
            self._n = base + len(texts)
            return self._n

    def add_vectors(self, vecs) -> int:
        """Append vectors [n, n_embd] (numpy or a tensor), as unit rows:
        ranking is by cosine."""
        vecs = torch.as_tensor(vecs).to(self.device, torch.float32)
        if vecs.ndim != 2 or vecs.shape[1] != self.engine.n_embd:
            raise ValueError(f"expected [n, {self.engine.n_embd}] vectors, "
                             f"got {tuple(vecs.shape)}")
        if len(vecs) == 0:
            return self._n
        with self._lock:
            return self._commit_vectors(unit(vecs))

    def _commit_vectors(self, vecs) -> int:
        """Append unit vectors [m, n_embd] (caller holds the lock).  The
        multi-process leader broadcasts them first, and its followers replay
        this with the same vectors."""
        vecs = torch.as_tensor(vecs).to(self.device, torch.float32)
        need = self._n + len(vecs)
        self._rows.put(range(self._n, need), vectors=vecs)
        self._n = need
        return self._n

    # --- persistence ----------------------------------------------------------
    def save(self, path: str) -> None:
        """The indexed vectors as f32 in an .npz (`vectors`), the JAX
        package's layout; a sharded corpus is gathered (on every process of
        a multi-process mesh), so the file loads into any mesh shape."""
        with self._lock:
            vecs = self._snapshot_rows()
        np.savez_compressed(path, vectors=vecs)

    def _snapshot_rows(self) -> np.ndarray:
        """The indexed rows as host f32 (caller holds the lock; a collective
        on a multi-process mesh)."""
        if self._n == 0:
            return np.zeros((0, self.engine.n_embd), np.float32)
        return self._rows.gather(self._n, "vectors").float().cpu().numpy()

    def load(self, path: str) -> int:
        """Append the vectors of a saved index; returns the total."""
        with np.load(path) as data:
            return self.add_vectors(data["vectors"])

    # --- querying ------------------------------------------------------------
    def search(self, queries: Sequence[str], k: int = 10) -> tuple[np.ndarray, np.ndarray]:
        """Texts (with the model's query prompt) -> (ids [n, k] int32,
        scores [n, k] f32), descending, equal scores by the lower id.  Always
        k columns: past the corpus size the slots carry id -1 and score
        -inf."""
        return self.search_vectors(self.engine.encode_queries(list(queries)), k)

    def search_vectors(self, qvecs, k: int = 10) -> tuple[np.ndarray, np.ndarray]:
        """Query vectors [n, n_embd] -> `search`'s result."""
        with self._lock:
            if self._n == 0:
                raise ValueError("index is empty")
            q = unit(torch.as_tensor(np.asarray(qvecs, np.float32)))
            scores, ids = self._run_search(q, k)
        return pad_to_k(ids, scores, k)

    def _run_search(self, q, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Unit queries [Q, E] -> (scores, ids) [Q, min(k, n)] on the device
        (caller holds the lock).  The multi-process leader broadcasts the
        queries first."""
        q = torch.as_tensor(q).to(self.device, torch.float32)
        kk = min(k, self._n)
        return self._rows.top_k(self._n, kk, len(q), lambda f, k: self._top(
            q.to(f["vectors"].device), f["vectors"], k))

    def _top(self, q: torch.Tensor, corpus: torch.Tensor, k: int):
        """select_topk of q x corpus in query slices of the score budget."""
        q = q.to(self.dtype)
        step = max(1, _SCORE_BUDGET // (12 * len(corpus)))
        parts = []
        with exact_f32():
            for lo in range(0, max(len(q), 1), step):
                parts.append(select_topk(similarity(q[lo: lo + step], corpus), k))
        return torch.cat([s for s, _ in parts]), torch.cat([i for _, i in parts])
