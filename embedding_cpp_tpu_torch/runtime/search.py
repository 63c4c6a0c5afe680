"""On-device vector index: the corpus embeddings stay in the device's memory
and a query batch returns only its top-k (id, score) pairs.

The JAX package's `runtime/search.py` on torch.  The similarity product
([Q, E] x [E, N]) and the top-k selection run where the vectors are, and
only k ids and scores per query cross to the host.  Vectors are unit rows,
so a dot product is a cosine.

The helpers here are shared by the sparse and MaxSim indexes: the exact
top-k with the JAX package's order (`select_topk`), f32 products without
TF32 (`exact_f32`), and the padding of a result to the requested width
(`pad_to_k`).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import numpy as np
import torch

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


def _ordered(vals: torch.Tensor, ids: torch.Tensor, k: int) -> torch.Tensor:
    """The ids of the k largest `vals` (f32, [..., m]; their `ids` int64,
    below 2^32, broadcast against them), equal values by the lower id: one
    top-k over int64 keys that hold the value's total order (-0.0 below
    0.0) above the reversed id, so every key is distinct."""
    bits = vals.contiguous().view(torch.int32).to(torch.int64)
    # negative floats order by their magnitude bits reversed
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    top = torch.topk(bits * (1 << 32) + (0xFFFFFFFF - ids), k, dim=-1).values
    return 0xFFFFFFFF - (top & 0xFFFFFFFF)


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
    both settings run the exact selection (recall 1.0).  A mesh-sharded
    corpus waits for the distribution layer.  Thread-safe: one lock covers
    adds and searches (the server calls from executor threads)."""

    def __init__(self, engine, dtype: str = "bfloat16", mesh=None, exact: bool = True):
        if mesh is not None:
            raise NotImplementedError("a mesh-sharded index waits for the port's "
                                      "distribution layer")
        self.engine = engine
        self.dtype = index_dtype(dtype)
        self.device = engine.device
        self.exact = bool(exact)
        self._corpus: torch.Tensor | None = None  # [capacity, n_embd]
        self._n = 0
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self._n

    # --- building -----------------------------------------------------------
    def add(self, texts: Sequence[str]) -> int:
        """Embed the texts (with the model's document prompt) and append
        them; returns the total indexed.  The vectors go from the forward
        into the corpus on the device (`Engine.embed_tokens_device`), unit
        rows again where the model does not normalize."""
        texts = list(texts)
        prefix = self.engine.document_prompt_prefix()
        if prefix:
            texts = [prefix + t for t in texts]
        token_lists = self.engine.tokenize_batch(texts)
        with self._lock:
            base = self._n
            self._corpus = grown(self._corpus, base + len(texts), (self.engine.n_embd,),
                                 self.dtype, self.device)
            for positions, vecs in self.engine.embed_tokens_device(token_lists):
                vecs = vecs.float() if self.engine.config.normalize else unit(vecs)
                rows = torch.from_numpy(base + positions).to(self.device)
                self._corpus.index_copy_(0, rows, vecs.to(self.dtype))
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
        vecs = unit(vecs).to(self.dtype)
        with self._lock:
            need = self._n + len(vecs)
            self._corpus = grown(self._corpus, need, (self.engine.n_embd,), self.dtype,
                                 self.device)
            self._corpus[self._n: need] = vecs
            self._n = need
            return self._n

    # --- persistence ----------------------------------------------------------
    def save(self, path: str) -> None:
        """The indexed vectors as f32 in an .npz (`vectors`), the JAX
        package's layout."""
        with self._lock:
            vecs = (np.zeros((0, self.engine.n_embd), np.float32) if self._n == 0
                    else self._corpus[: self._n].float().cpu().numpy())
        np.savez_compressed(path, vectors=vecs)

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
            q = unit(torch.as_tensor(np.asarray(qvecs, np.float32)).to(self.device))
            corpus = self._corpus[: self._n]
            q = q.to(self.dtype)
            step = max(1, _SCORE_BUDGET // (12 * self._n))
            parts = []
            with exact_f32():
                for lo in range(0, max(len(q), 1), step):
                    parts.append(select_topk(similarity(q[lo: lo + step], corpus),
                                             min(k, self._n)))
            scores = torch.cat([s for s, _ in parts])
            ids = torch.cat([i for _, i in parts])
        return pad_to_k(ids, scores, k)
