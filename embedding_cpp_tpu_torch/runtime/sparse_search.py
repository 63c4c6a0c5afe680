"""Sparse (SPLADE) retrieval over the (term id, weight) vectors of
`Engine.encode_sparse`, and reciprocal-rank fusion for hybrid search.

The JAX package's `runtime/sparse_search.py` on torch, with its two
scoring backends behind one index:

- **device** (the default with an engine): the documents live on the
  device as padded COO rows, ids [N, Kd] int32 and weights [N, Kd] f32
  (pad slots id 0 / weight 0 add nothing), each row sorted by weight at
  ingest.  A search builds the dense [Q, V] query on the device from the
  sparse terms (never the corpus) and sums the gathered weights over
  blocks of documents: scores[q, n] = sum_j val[n, j] * qdense[q, idx[n, j]],
  each block's [NB, Kd, Q] gather held under a 256 MiB budget.
  `candidates=C` scores every document by its P heaviest terms first and
  scores the C best again with their whole rows.
- **host** (device=False, or no engine): one numpy pass over the corpus
  nonzeros per query, reduced per document with `np.bincount`.

Scores are exact dot products in both; results follow the dense
VectorIndex contract (k columns, id -1 and -inf past the corpus, `.npz`
files).  Equal scores come by the lower id on the device backend, and in
the JAX package's host order (numpy's argpartition) on the host one.
The device rows are runtime/search.py's `ShardedRows`: dp-sharded over
`mesh`, else one shard on the backend's device.  Every shard scores its
rows and keeps its top-k, and `merge_topk` merges the shards' candidates.
"""
from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from .engine import resolve_device
from .search import ShardedRows, exact_f32, pad_to_k, select_topk

# bytes of one block's [NB, Kd, Q] f32 gather (the JAX package's budget)
_GATHER_TILE_BUDGET = 256 << 20


def rrf_fuse(rankings: Sequence[np.ndarray], k: int, c: float = 60.0):
    """Reciprocal-rank fusion (Cormack et al. 2009) of per-query rankings:
    fused(d) = sum over rankings of 1 / (c + rank of d), rank 1-based,
    absent documents adding 0.  `rankings` are [Q, k_i] id arrays with -1
    on empty slots (the search padding).  Returns (ids [Q, k] int32, scores
    [Q, k] f32), equal scores by the lower id, -1 / 0.0 past the fused
    candidates."""
    if not rankings:
        raise ValueError("no rankings to fuse")
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    q = rankings[0].shape[0]
    if any(r.shape[0] != q for r in rankings):
        raise ValueError("rankings disagree on query count")
    out_i = np.full((q, k), -1, np.int32)
    out_s = np.zeros((q, k), np.float32)
    for qi in range(q):
        scores: dict[int, float] = {}
        for r in rankings:
            for rank, doc in enumerate(r[qi], start=1):
                if doc >= 0:
                    scores[int(doc)] = scores.get(int(doc), 0.0) + 1.0 / (c + rank)
        top = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        for j, (doc, sc) in enumerate(top):
            out_i[qi, j] = doc
            out_s[qi, j] = sc
    return out_i, out_s


def _gathered_scores(qd_t: torch.Tensor, didx: torch.Tensor, dval: torch.Tensor) -> torch.Tensor:
    """Documents' padded rows (ids, weights [N, P]) against the dense
    queries transposed [V, Q] -> [Q, N] f32, over blocks of documents whose
    [NB, P, Q] gather fits the budget."""
    q = qd_t.shape[1]
    nb = max(1, _GATHER_TILE_BUDGET // (max(q, 1) * didx.shape[1] * 4))
    out = []
    for lo in range(0, didx.shape[0], nb):
        g = qd_t[didx[lo: lo + nb].long()]  # [NB, P, Q]
        out.append(torch.bmm(dval[lo: lo + nb, None, :], g)[:, 0].T)
    return torch.cat(out, dim=1)


class SparseIndex:
    """Append-only sparse corpus with exact dot-product top-k search.

    `device`: the backend.  None picks the device backend on the engine's
    device when an engine is attached and the host backend otherwise; False
    the host backend; True the device backend on the engine's device (the
    GPU without an engine); a device name or `torch.device` the device
    backend there ("cpu" runs the device backend's torch code on the CPU).
    `nnz_width` caps the terms a document keeps on the device backend (its
    heaviest; default k_encode).  `mesh` dp-shards the device backend's rows
    (it needs the device backend); on a multi-process mesh every process
    makes the same calls (parallel/distributed.py's serving plane).
    Thread-safe: one lock covers adds and searches."""

    def __init__(self, engine=None, *, k_encode: int = 256, device=None,
                 nnz_width: int | None = None, mesh=None):
        if engine is not None and not engine.config.mlm_head:
            raise ValueError("model has no MLM head (not a SPLADE checkpoint)")
        self.engine = engine
        self.mesh = mesh
        self.k_encode = int(k_encode)
        self.n_vocab = int(engine.config.n_vocab) if engine is not None else 0
        if device is None:
            device = engine is not None
        self.device = device is not False
        self.torch_device = None  # where the device backend's rows live
        if device is True:
            self.torch_device = engine.device if engine is not None else resolve_device()
        elif self.device:
            self.torch_device = torch.device(device)
        if mesh is not None and not self.device:
            raise ValueError("mesh sharding requires device=True")
        if mesh is not None:
            self.torch_device = mesh.device(0, 0)
        self.nnz_width = int(nnz_width or self.k_encode)
        kd = (self.nnz_width,)
        # the device backend's padded rows: term ids [Kd] int32, weights [Kd] f32
        self._rows = (ShardedRows(mesh, {"idx": (kd, torch.int32), "val": (kd, torch.float32)},
                                  self.torch_device) if self.device else None)
        self._n_dev = 0  # rows committed to the device backend
        self._lock = threading.Lock()
        self._indices: list[np.ndarray] = []  # per-document int32 term ids
        self._values: list[np.ndarray] = []  # per-document f32 weights
        # the host backend's flat arrays, rebuilt on the first search after an add
        self._flat: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None

    def __len__(self) -> int:
        return len(self._indices)

    # --- building -----------------------------------------------------------
    def add(self, texts: Sequence[str]) -> int:
        """Encode (`encode_sparse(k=k_encode)`) and append documents;
        returns the corpus size."""
        if self.engine is None:
            raise RuntimeError("index was loaded without an engine")
        return self.add_vectors(self.engine.encode_sparse(texts, k=self.k_encode))

    def add_vectors(self, pairs: Sequence[tuple[np.ndarray, np.ndarray]]) -> int:
        """Append (term ids, weights) pairs."""
        clean = []
        for idx, val in pairs:
            idx = np.ascontiguousarray(idx, np.int32)
            val = np.ascontiguousarray(val, np.float32)
            if idx.shape != val.shape or idx.ndim != 1:
                raise ValueError(f"sparse vector must be two aligned 1-D arrays, got "
                                 f"{idx.shape} / {val.shape}")
            if idx.size and int(idx.min()) < 0:
                # -1 is the wire's pad slot, not a term
                raise ValueError("negative term id in sparse vector (trim the -1 pad "
                                 "slots before add_vectors)")
            clean.append((idx, val))
        with self._lock:
            base = len(self._indices)
            if self.device and clean:
                self._commit_device(self._pad_pairs(clean), base)
            for idx, val in clean:
                if idx.size:
                    self.n_vocab = max(self.n_vocab, int(idx.max()) + 1)
                self._indices.append(idx)
                self._values.append(val)
            self._flat = None
            return len(self._indices)

    def _commit_device(self, padded: tuple[np.ndarray, np.ndarray], base: int) -> None:
        """Write padded rows (ids, weights [m, Kd]) at device rows base..
        (caller holds the lock).  The multi-process leader broadcasts them
        first, and its followers replay this with the same rows."""
        di, dv = (torch.from_numpy(np.ascontiguousarray(a)) for a in padded)
        need = base + len(di)
        self._rows.put(range(base, need), idx=di, val=dv)
        self._n_dev = max(self._n_dev, need)

    def _pad_pairs(self, pairs) -> tuple[np.ndarray, np.ndarray]:
        """Pairs -> padded [n, Kd] rows sorted by weight, descending (the
        order a dot product ignores and the candidates mode's prefix
        needs); a document with more than Kd terms keeps its Kd heaviest."""
        kd = self.nnz_width
        di = np.zeros((len(pairs), kd), np.int32)
        dv = np.zeros((len(pairs), kd), np.float32)
        for i, (idx, val) in enumerate(pairs):
            order = np.argsort(-val, kind="stable")[:kd]
            di[i, : len(order)] = idx[order]
            dv[i, : len(order)] = val[order]
        return di, dv

    def _vocab_pad(self) -> int:
        """Width of the dense query: the engine's vocabulary, or the
        corpus's rounded up to 1024."""
        if self.engine is not None:
            return int(self.engine.config.n_vocab)
        return max(1024, -(-self.n_vocab // 1024) * 1024)

    def _flattened(self):
        """(indices, values, doc ids) over the corpus, for the host backend."""
        if self._flat is None:
            counts = np.array([len(i) for i in self._indices], np.int64)
            self._flat = (
                np.concatenate(self._indices) if counts.sum() else np.zeros(0, np.int32),
                np.concatenate(self._values) if counts.sum() else np.zeros(0, np.float32),
                np.repeat(np.arange(len(self._indices), dtype=np.int64), counts),
            )
        return self._flat

    # --- search ---------------------------------------------------------------
    def search(self, texts: Sequence[str], k: int = 10, candidates: int | None = None):
        """Encode queries and search: -> (ids [Q, k] int32, scores [Q, k]
        f32) by descending score, id -1 / -inf past the corpus.
        `candidates` enables the two-stage mode (see search_vectors)."""
        if self.engine is None:
            raise RuntimeError("index was loaded without an engine")
        pairs = self.engine.encode_sparse(texts, k=self.k_encode)
        return self.search_vectors(pairs, k, candidates=candidates)

    def search_vectors(self, pairs: Sequence[tuple[np.ndarray, np.ndarray]], k: int = 10,
                       candidates: int | None = None, prefix: int = 8):
        """`candidates=C` (device backend): every document is scored by its
        `prefix` heaviest terms, and the C best are scored again with their
        whole rows, so every returned score is an exact dot product; the
        prefix decides only which documents are considered."""
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        if candidates is not None and not self.device:
            raise ValueError("two-stage candidates mode needs the device index")
        if candidates is not None and self.mesh is not None:
            raise ValueError("two-stage candidates mode is single-device; use exact "
                             "search on a mesh")
        if self.device:
            return self._search_device(pairs, k, candidates, prefix)
        with self._lock:
            n = len(self._indices)
            if n == 0:
                raise RuntimeError("empty index")
            flat_idx, flat_val, doc_ids = self._flattened()
            n_vocab = self.n_vocab
        out_i = np.full((len(pairs), k), -1, np.int32)
        out_s = np.full((len(pairs), k), -np.inf, np.float32)
        kk = min(k, n)
        qd = np.zeros(n_vocab, np.float32)
        for qi, (idx, val) in enumerate(pairs):
            idx = np.asarray(idx, np.int64)
            val = np.asarray(val, np.float32)
            # terms past the corpus vocabulary match nothing; -1 is a pad slot
            keep = (idx >= 0) & (idx < n_vocab)
            idx, val = idx[keep], val[keep]
            qd[idx] = val
            scores = np.bincount(doc_ids, weights=flat_val * qd[flat_idx],
                                 minlength=n).astype(np.float32)
            qd[idx] = 0.0
            top = np.argpartition(-scores, kk - 1)[:kk]
            top = top[np.argsort(-scores[top], kind="stable")]
            out_i[qi, :kk] = top
            out_s[qi, :kk] = scores[top]
        return out_i, out_s

    def _search_device(self, pairs, k: int, candidates: int | None, prefix: int):
        with self._lock:
            if self._n_dev == 0:
                raise RuntimeError("empty index")
            w = max([len(np.asarray(idx)) for idx, _ in pairs], default=0)
            q_idx = np.full((len(pairs), w), -1, np.int32)
            q_val = np.zeros((len(pairs), w), np.float32)
            for qi, (idx, val) in enumerate(pairs):
                q_idx[qi, : len(idx)] = np.asarray(idx, np.int64).clip(-1, 2**31 - 1)
                q_val[qi, : len(idx)] = val
            scores, ids = self._run_device_search(q_idx, q_val, k, candidates, prefix)
        return pad_to_k(ids, scores, k)

    def _dense_queries(self, q_idx: np.ndarray, q_val: np.ndarray, dev) -> torch.Tensor:
        """The [Q, vocab] f32 queries of padded terms (ids [Q, W], -1 on the
        pad slots; terms past the vocabulary match nothing)."""
        vocab = self._vocab_pad()
        qi = torch.from_numpy(np.ascontiguousarray(q_idx, np.int64))
        keep = (qi >= 0) & (qi < vocab)
        rows = torch.arange(len(qi))[:, None].expand_as(qi)[keep]
        qd = torch.zeros(len(qi), vocab, dtype=torch.float32, device=dev)
        qd.index_put_((rows.to(dev), qi[keep].to(dev)),
                      torch.from_numpy(np.ascontiguousarray(q_val, np.float32))[keep].to(dev),
                      accumulate=True)
        return qd

    def _run_device_search(self, q_idx: np.ndarray, q_val: np.ndarray, k: int,
                           candidates: int | None = None, prefix: int = 8):
        """Padded query terms -> (scores, ids) [Q, min(k, n)] on the device
        (caller holds the lock).  The multi-process leader broadcasts the
        terms first."""
        n = self._n_dev
        kk = min(k, n)
        with exact_f32():
            if candidates is None:
                def top(f, k):
                    qd = self._dense_queries(q_idx, q_val, f["idx"].device)
                    return select_topk(_gathered_scores(qd.T, f["idx"], f["val"]), k)

                return self._rows.top_k(n, kk, len(q_idx), top)
            # the candidates mode runs on one shard (a mesh refuses it)
            ((_, f),) = self._rows.shards(n)
            didx, dval = f["idx"], f["val"]
            qd = self._dense_queries(q_idx, q_val, didx.device)
            c = max(kk, min(int(candidates), n))
            p = max(1, min(int(prefix), self.nnz_width))
            first = _gathered_scores(qd.T, didx[:, :p], dval[:, :p])
            return self._rescore(qd, select_topk(first, c)[1], didx, dval, kk)

    @staticmethod
    def _rescore(qd, cand, didx, dval, k: int):
        """Stage 2 of the candidates mode: the candidates' [Q, C] whole-row
        dot products, top-k over the candidate axis (ties by the earlier
        candidate, as the JAX package's `lax.top_k` there), mapped back to
        document ids; in query slices whose [Qc, C, Kd] gather fits the
        budget."""
        q, c = cand.shape
        kd = didx.shape[1]
        step = max(1, _GATHER_TILE_BUDGET // (c * kd * 4))
        scores, ids = [], []
        for lo in range(0, max(q, 1), step):
            ci = cand[lo: lo + step]
            g = torch.gather(qd[lo: lo + step], 1, didx[ci].reshape(len(ci), c * kd).long())
            s, j = select_topk((dval[ci] * g.reshape(len(ci), c, kd)).sum(-1), k)
            scores.append(s)
            ids.append(torch.where(j >= 0, torch.gather(ci, 1, j.clamp_min(0)), -1))
        return torch.cat(scores), torch.cat(ids)

    # --- persistence ------------------------------------------------------------
    def save(self, path: str) -> None:
        """The corpus as one compressed .npz: the CSR triple (`indices`,
        `values`, `indptr`) and `n_vocab`, the JAX package's layout."""
        with self._lock:
            counts = np.array([len(i) for i in self._indices], np.int64)
            indptr = np.zeros(len(counts) + 1, np.int64)
            np.cumsum(counts, out=indptr[1:])
            np.savez_compressed(
                path,
                indices=(np.concatenate(self._indices) if counts.sum()
                         else np.zeros(0, np.int32)),
                values=(np.concatenate(self._values) if counts.sum()
                        else np.zeros(0, np.float32)),
                indptr=indptr,
                n_vocab=np.int64(self.n_vocab),
            )

    def load(self, path: str) -> int:
        """Append the documents of a saved index; returns the corpus size."""
        with np.load(path) as data:
            indices = np.asarray(data["indices"], np.int32)
            values = np.asarray(data["values"], np.float32)
            indptr = np.asarray(data["indptr"], np.int64)
            n_vocab = int(data["n_vocab"])
        total = self.add_vectors([(indices[a:b], values[a:b])
                                  for a, b in zip(indptr[:-1], indptr[1:])])
        with self._lock:
            self.n_vocab = max(self.n_vocab, n_vocab)
        return total
