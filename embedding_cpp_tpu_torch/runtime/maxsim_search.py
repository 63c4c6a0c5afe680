"""On-device late-interaction (MaxSim) retrieval index.

The JAX package's `runtime/maxsim_search.py` on torch.  `Engine.maxsim`
encodes every document again for every query; this index keeps the
corpus's token states on the device and scores whole query batches:

    score(q, d) = sum over real query tokens of
                  max over real document tokens of cosine(q_i, d_j)

(ColBERT's MaxSim, Khattab & Zaharia 2020).  Token vectors are unit rows
from ingest on, documents are padded or cut to `doc_maxlen` tokens ([N, Sd,
E] states and an [N, Sd] mask), and the exact search runs over blocks of
documents whose [Q, Sq, NB, Sd] f32 similarity fits a 256 MiB budget, so
the whole similarity never exists at once.  `candidates=C` ranks the corpus
by its pooled rows (the unit mean of each document's token vectors, kept
current by every commit) and scores only the C best with exact MaxSim.
The corpus rows are runtime/search.py's `ShardedRows`: dp-sharded over
`mesh`, else one shard on the engine's device.  The exact search keeps
each shard's top-k and merges them (`merge_topk`); the candidates mode
merges the shards' pooled-row candidates, and each candidate is scored on
the shard that holds it.
"""
from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from .search import (
    ShardedRows,
    exact_f32,
    index_dtype,
    pad_to_k,
    select_topk,
    unit,
)

# bytes of one [Q, Sq, NB, Sd] f32 similarity block (the JAX package's budget)
_SIM_TILE_BUDGET = 256 << 20
_HOST_BLOCK = 4096  # documents an add_token_vectors commit moves at once


def _maxsim(qn: torch.Tensor, qm: torch.Tensor, docs: torch.Tensor, dmask: torch.Tensor,
            pattern: str) -> torch.Tensor:
    """Unit query tokens [Q, Sq, E] (mask [Q, Sq]) against document tokens
    (`pattern` "qte,nse->qtns": [NB, Sd, E] shared by every query, or
    "qte,qcse->qtcs": [Q, C, Sd, E] per query) -> [Q, NB or C] f32 MaxSim
    scores; a document with no real token scores -inf."""
    sim = torch.einsum(pattern, qn, docs.float())
    mask = dmask[None, None] if pattern.endswith("qtns") else dmask[:, None]
    best = sim.masked_fill_(~mask, -torch.inf).amax(dim=-1)
    # the sum over query tokens runs along contiguous rows, so that equal
    # documents get equal scores wherever they sit in the block
    return torch.where(qm[:, :, None] > 0, best, 0.0).transpose(1, 2).contiguous().sum(dim=-1)


class MaxSimIndex:
    """Token-level corpus with batched MaxSim top-k search, resident on the
    engine's device.

    doc_maxlen: the document token budget Sd (ColBERT's doc_maxlen; longer
    documents are cut).  dtype="bfloat16" halves the corpus bytes; the
    similarities are f32.  `capacity` sizes the corpus ahead.  `mesh`
    dp-shards the corpus rows; a multi-process mesh is refused, as the JAX
    package does (its followers would each add every request again).
    Thread-safe: one lock covers adds and searches."""

    def __init__(self, engine, *, doc_maxlen: int = 256, dtype: str = "bfloat16",
                 mesh=None, capacity: int = 0):
        if mesh is not None and mesh.multiprocess:
            raise RuntimeError("MaxSimIndex is single-controller only")
        self.engine = engine
        self.mesh = mesh
        self.doc_maxlen = int(doc_maxlen)
        if self.doc_maxlen < 1:
            raise ValueError(f"doc_maxlen must be positive, got {doc_maxlen}")
        self.dtype = index_dtype(dtype)
        self.device = mesh.device(0, 0) if mesh is not None else engine.device
        sd, e = self.doc_maxlen, self.n_embd
        # token states [Sd, E], their mask [Sd] and the pooled row [E] f32
        self._rows = ShardedRows(mesh, {"corpus": ((sd, e), self.dtype),
                                        "cmask": ((sd,), torch.bool),
                                        "pooled": ((e,), torch.float32)}, self.device)
        self._n = 0
        self._lock = threading.Lock()
        if capacity:
            self._rows.reserve(int(capacity))

    def __len__(self) -> int:
        return self._n

    @property
    def n_embd(self) -> int:
        """Token vector width: ColBERT's projection, else the encoder's."""
        return self.engine.config.colbert_dim or self.engine.config.n_embd


    # --- building -----------------------------------------------------------
    def add(self, texts: Sequence[str]) -> int:
        """Encode the documents and append their token states; returns the
        corpus size.  The states go from the forward into the corpus on the
        device (`Engine.token_states_device`).  ColBERT checkpoints frame
        [CLS] [D] tokens [SEP] cut to doc_maxlen before the forward, and
        leave their punctuation skiplist out of scoring; other models take
        the document prompt, and their states are cut to doc_maxlen."""
        texts = list(texts)
        if self.engine.config.colbert_dim > 0:
            token_lists = self.engine.colbert_doc_tokens(texts, cap=self.doc_maxlen)
            skip = self.engine.colbert_skiplist()
        else:
            prefix = self.engine.document_prompt_prefix()
            if prefix:
                texts = [prefix + t for t in texts]
            token_lists = self.engine.tokenize_batch(texts)
            skip = frozenset()
        keep_rows = [np.asarray([t not in skip for t in toks], bool) for toks in token_lists]
        sd = self.doc_maxlen
        with self._lock:
            base = self._n
            self._rows.reserve(base + len(texts))
            for positions, dev, mask, lens in self.engine.token_states_device(token_lists):
                keep = np.zeros(mask.shape, bool)
                for r, p in enumerate(positions):
                    keep[r, : lens[r]] = keep_rows[p]
                keep = torch.from_numpy(keep).to(self.device)
                s = min(dev.shape[1], sd)  # states cut or padded to Sd
                sn = torch.zeros((len(positions), sd, self.n_embd), device=self.device)
                sn[:, :s] = (unit(dev) * keep[..., None])[:, :s]
                m = torch.zeros((len(positions), sd), dtype=torch.bool, device=self.device)
                m[:, :s] = keep[:, :s]
                self._rows.put(np.asarray(positions) + base, corpus=sn, cmask=m,
                               pooled=unit(sn.sum(dim=1)))
            self._n = base + len(texts)
            return self._n

    def add_token_vectors(self, states: Sequence[np.ndarray]) -> int:
        """Append per-document token matrices ([len_i, E] each; rows are
        made unit here, and cut to doc_maxlen)."""
        states = [np.asarray(s, np.float32) for s in states]
        for i, s in enumerate(states):
            if s.ndim != 2 or s.shape[1] != self.n_embd:
                raise ValueError(f"document {i}: expected [tokens, {self.n_embd}], "
                                 f"got {s.shape}")
            if s.shape[0] == 0:
                raise ValueError(f"document {i} has no token vectors")
        sd, e = self.doc_maxlen, self.n_embd
        with self._lock:
            base = self._n
            self._rows.reserve(base + len(states))
            for lo in range(0, len(states), _HOST_BLOCK):
                chunk = states[lo: lo + _HOST_BLOCK]
                blk = np.zeros((len(chunk), sd, e), np.float32)
                msk = np.zeros((len(chunk), sd), bool)
                for i, s in enumerate(chunk):
                    s = s[:sd]
                    blk[i, : len(s)] = s / np.maximum(np.linalg.norm(s, axis=-1, keepdims=True),
                                                      1e-12)
                    msk[i, : len(s)] = True
                blk = torch.from_numpy(blk).to(self.device, self.dtype)
                msk = torch.from_numpy(msk).to(self.device)
                # pooled from the stored rows, summed in the corpus dtype
                pooled = unit((blk * msk[..., None].to(blk.dtype)).sum(dim=1))
                self._rows.put(range(base + lo, base + lo + len(chunk)), corpus=blk,
                               cmask=msk, pooled=pooled)
            self._n = base + len(states)
            return self._n

    # --- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        """The token states as f16 (`token_states`) and their masks
        (`token_masks`) in an .npz, the JAX package's layout."""
        with self._lock:
            n = self._n
            if n == 0:
                states = np.zeros((0, self.doc_maxlen, self.n_embd), np.float16)
                masks = np.zeros((0, self.doc_maxlen), bool)
            else:
                states = self._rows.gather(n, "corpus").float().cpu().numpy().astype(np.float16)
                masks = self._rows.gather(n, "cmask").cpu().numpy()
        np.savez_compressed(path, token_states=states, token_masks=masks)

    def load(self, path: str) -> int:
        """Append the documents of a saved index (doc_maxlen may differ:
        rows are cut again); returns the corpus size."""
        with np.load(path) as data:
            states = np.asarray(data["token_states"], np.float32)
            masks = np.asarray(data["token_masks"], bool)
        docs = [s[m] for s, m in zip(states, masks)]
        if any(len(d) == 0 for d in docs):
            raise ValueError("saved index contains an empty document")
        return self.add_token_vectors(docs)

    # --- querying ------------------------------------------------------------
    def search(self, queries: Sequence[str], k: int = 10, candidates: int | None = None):
        """Texts -> (ids [n, k] int32, scores [n, k] f32), id -1 / -inf past
        the corpus.  ColBERT checkpoints frame queries with [Q] and [MASK]
        augmentation (every query_maxlen vector scores); other models take
        the query prompt.  `candidates` enables the two-stage mode."""
        queries = list(queries)
        if self.engine.config.colbert_dim:
            states = self.engine.colbert_query_vectors(queries)
        else:
            prefix = self.engine.query_prompt_prefix()
            if prefix:
                queries = [prefix + t for t in queries]
            states = self.engine.token_states_tokens(self.engine.tokenize_batch(queries))
        return self.search_token_vectors(states, k, candidates=candidates)

    def search_token_vectors(self, states: Sequence[np.ndarray], k: int = 10,
                             candidates: int | None = None):
        """Query token matrices [len_i, E] -> (ids, scores).  `candidates=C`:
        the pooled rows' cosine picks C documents a query, and exact MaxSim
        scores only those; every returned score is exact."""
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        states = [np.asarray(s, np.float32) for s in states]
        for i, s in enumerate(states):
            if s.ndim != 2 or s.shape[1] != self.n_embd or not len(s):
                raise ValueError(f"query {i}: expected [tokens>0, {self.n_embd}], "
                                 f"got {s.shape}")
        with self._lock:
            n = self._n
            if n == 0:
                raise ValueError("index is empty")
            kk = min(k, n)
            sq = -(-max((len(s) for s in states), default=1) // 32) * 32
            q = np.zeros((len(states), sq, self.n_embd), np.float32)
            qm = np.zeros((len(states), sq), np.int32)
            for i, s in enumerate(states):
                q[i, : len(s)] = s
                qm[i, : len(s)] = 1
            qn = unit(torch.from_numpy(q).to(self.device))
            qm = torch.from_numpy(qm).to(self.device)
            with exact_f32():
                scores, ids = self._search_shards(qn, qm, kk, candidates)
        return pad_to_k(ids, scores, k)

    def _exact(self, qn, qm, corpus, cmask) -> torch.Tensor:
        """[Q, N] exact MaxSim scores over blocks of the similarity budget."""
        nb = max(1, _SIM_TILE_BUDGET // (max(len(qn), 1) * qn.shape[1] * self.doc_maxlen * 4))
        return torch.cat([_maxsim(qn, qm, corpus[lo: lo + nb], cmask[lo: lo + nb],
                                  "qte,nse->qtns")
                          for lo in range(0, len(corpus), nb)], dim=1)

    def _search_shards(self, qn, qm, k: int, candidates: int | None):
        """Every shard's top-k merged.  With `candidates` (C): the pooled
        query (unit mean of its unit tokens) against the pooled rows picks
        C documents (the shards' candidates merged: equal cosines by the
        lower id), exact MaxSim scores each on the shard that holds it
        (`_candidate_scores`), and the top k of each query's [C] (ties by
        the earlier candidate, as the JAX package's `lax.top_k` there) map
        back to document ids.  Any mesh gives the one-shard result."""
        rows, n = self._rows, self._n
        dev = lambda f: f["corpus"].device  # noqa: E731
        if candidates is None:
            return rows.top_k(n, k, len(qn), lambda f, kk: select_topk(self._exact(
                qn.to(dev(f)), qm.to(dev(f)), f["corpus"], f["cmask"]), kk))
        c = max(k, min(int(candidates), n))
        qpool = unit((qn * (qm[..., None] > 0)).sum(dim=1))
        cand = rows.top_k(n, c, len(qn), lambda f, kk: select_topk(
            qpool.to(dev(f)) @ f["pooled"].T, kk))[1]
        scores = torch.full(cand.shape, -torch.inf, device=qn.device)
        dp = rows.dp
        for g, f in rows.shards(n):
            if f["corpus"] is None:
                continue
            own = (cand % dp == g).to(dev(f))
            local = torch.where(own, cand.to(dev(f)) // dp, 0)
            s = self._candidate_scores(qn.to(dev(f)), qm.to(dev(f)), local, f["corpus"],
                                       f["cmask"])
            scores = torch.where(own.to(qn.device), s.to(qn.device), scores)
        return _pick(scores, cand, k)

    def _candidate_scores(self, qn, qm, cand, corpus, cmask) -> torch.Tensor:
        """[Q, C] exact MaxSim of each query's candidate rows `cand`, in
        query slices whose gathered [Qc, C, Sd, E] tokens fit the budget."""
        c = cand.shape[1]
        step = max(1, _SIM_TILE_BUDGET // (c * self.doc_maxlen * self.n_embd * 4))
        return torch.cat([_maxsim(qn[lo: lo + step], qm[lo: lo + step], corpus[ci], cmask[ci],
                                  "qte,qcse->qtcs")
                          for lo in range(0, max(len(qn), 1), step)
                          for ci in (cand[lo: lo + step],)])


def _pick(scores: torch.Tensor, cand: torch.Tensor, k: int):
    """The top k of candidate scores [Q, C] -> (scores, document ids)."""
    s, j = select_topk(scores, k)
    return s, torch.where(j >= 0, torch.gather(cand, 1, j.clamp_min(0)), -1)
