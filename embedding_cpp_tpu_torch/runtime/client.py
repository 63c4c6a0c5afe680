"""Python client of the embedding server's TCP protocol
(`runtime/server.py`): the JAX package's `EmbeddingClient`, over the port's
own frame constants.

`embed_raw` speaks the ggml-compatible raw mode (connect, read the int32
n_embd, send a text, read n_embd f32); `embed` sends length-framed TPE2
batches, and the other methods the rerank, sparse, MaxSim, index and
search frames.  A request the server refuses raises RuntimeError with its
message.
"""
from __future__ import annotations

import socket
import struct
from typing import Sequence

import numpy as np

from .server import (
    MAGIC,
    MAGIC_ENCODE_I8,
    MAGIC_HYBRID_INDEX,
    MAGIC_HYBRID_SEARCH,
    MAGIC_INDEX,
    MAGIC_MAXSIM,
    MAGIC_MAXSIM_INDEX,
    MAGIC_MAXSIM_SEARCH,
    MAGIC_RERANK,
    MAGIC_SEARCH,
    MAGIC_SPARSE,
    MAGIC_SPARSE_INDEX,
    MAGIC_SPARSE_SEARCH,
)


class EmbeddingClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8080):
        self.sock = socket.create_connection((host, port))
        (self.n_embd,) = struct.unpack("<i", self._read_exactly(4))

    def _read_exactly(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed connection")
            buf += chunk
        return buf

    def embed(
        self, texts: str | Sequence[str], wire: str = "f32"
    ) -> np.ndarray:
        """Batched, length-framed (TPE2).  `wire="int8"` requests the
        int8-compressed reply (a quarter of the f32 bytes; the codes are
        decoded here, so the return value is always f32)."""
        if isinstance(texts, str):
            texts = [texts]
        if wire not in ("f32", "int8"):
            raise ValueError(f"wire must be f32/int8, got {wire!r}")
        self._send_texts(MAGIC_ENCODE_I8 if wire == "int8" else MAGIC, texts)
        (count,) = struct.unpack("<I", self._read_exactly(4))
        self._check_error(count)
        if wire == "int8":
            scales = np.frombuffer(self._read_exactly(count * 4), np.float32)
            codes = np.frombuffer(
                self._read_exactly(count * self.n_embd), np.int8
            ).reshape(count, self.n_embd)
            return codes.astype(np.float32) * scales[:, None]
        data = self._read_exactly(count * self.n_embd * 4)
        return np.frombuffer(data, np.float32).reshape(count, self.n_embd).copy()

    def _send_texts(self, magic: bytes, texts: Sequence[str],
                    prefix: bytes = b"") -> None:
        payload = [magic, prefix, struct.pack("<I", len(texts))]
        for t in texts:
            raw = t.encode("utf-8")
            payload.append(struct.pack("<I", len(raw)))
            payload.append(raw)
        self.sock.sendall(b"".join(payload))

    def _check_error(self, head: int) -> None:
        if head == 0xFFFFFFFF:
            (ln,) = struct.unpack("<I", self._read_exactly(4))
            raise RuntimeError(
                f"server error: {self._read_exactly(ln).decode('utf-8')}"
            )

    def index(self, texts: Sequence[str]) -> int:
        """Embed texts into the server's on-device vector index; returns the
        total indexed count.  The vectors never leave the device."""
        return self._index_like(MAGIC_INDEX, texts)

    def search(self, queries: Sequence[str], k: int = 10):
        """Top-k over the server's on-device index: returns
        (indices [n, k] int32, scores [n, k] f32); only ids and scores cross
        the wire."""
        return self._search_like(MAGIC_SEARCH, queries, k)

    def _index_like(self, magic: bytes, texts: Sequence[str]) -> int:
        self._send_texts(magic, list(texts))
        (total,) = struct.unpack("<I", self._read_exactly(4))
        self._check_error(total)
        return total

    def _search_like(self, magic: bytes, queries: Sequence[str], k: int):
        self._send_texts(magic, list(queries), struct.pack("<I", k))
        (n,) = struct.unpack("<I", self._read_exactly(4))
        self._check_error(n)
        (kk,) = struct.unpack("<I", self._read_exactly(4))
        idx = np.frombuffer(
            self._read_exactly(4 * n * kk), np.int32
        ).reshape(n, kk).copy()
        scores = np.frombuffer(
            self._read_exactly(4 * n * kk), np.float32
        ).reshape(n, kk).copy()
        return idx, scores

    def sparse_index(self, texts: Sequence[str]) -> int:
        """SPLADE-encode texts into the server's sparse index (\\x01TPY);
        returns the total indexed count.  Needs an MLM-head model."""
        return self._index_like(MAGIC_SPARSE_INDEX, texts)

    def sparse_search(self, queries: Sequence[str], k: int = 10):
        """Exact sparse dot-product top-k over the server's sparse index
        (\\x01TPZ): (indices [n, k] int32, scores [n, k] f32; -1/-inf
        padding past the corpus)."""
        return self._search_like(MAGIC_SPARSE_SEARCH, queries, k)

    def hybrid_index(self, texts: Sequence[str]) -> int:
        """Add texts to BOTH the dense and sparse indexes (\\x01TPF, the
        hybrid-search corpus contract)."""
        return self._index_like(MAGIC_HYBRID_INDEX, texts)

    def hybrid_search(self, queries: Sequence[str], k: int = 10):
        """Dense + sparse retrieval fused by reciprocal rank (\\x01TPG):
        (indices [n, k], RRF scores [n, k]; -1/0.0 padding)."""
        return self._search_like(MAGIC_HYBRID_SEARCH, queries, k)

    def maxsim_index(self, texts: Sequence[str]) -> int:
        """Encode texts' TOKEN states into the server's on-device
        late-interaction index (\\x01TPJ); returns the total indexed count.
        Token states never leave the device."""
        return self._index_like(MAGIC_MAXSIM_INDEX, texts)

    def maxsim_search(self, queries: Sequence[str], k: int = 10):
        """Batched MaxSim top-k over the server's token-state index
        (\\x01TPK): (indices [n, k] int32, scores [n, k] f32 MaxSim sums;
        -1/-inf padding past the corpus)."""
        return self._search_like(MAGIC_MAXSIM_SEARCH, queries, k)

    def rerank(self, query: str, documents: Sequence[str],
               top_n: int | None = None):
        """Cross-encoder rerank against a classification-head model:
        returns (indices [m] int32 descending by relevance, scores [m] f32
        sigmoid).  The server refuses cleanly (error frame) when its model
        has no head."""
        q = query.encode("utf-8")
        self._send_texts(
            MAGIC_RERANK, list(documents),
            struct.pack("<II", top_n or 0, len(q)) + q,
        )
        (m,) = struct.unpack("<I", self._read_exactly(4))
        self._check_error(m)
        idx = np.frombuffer(self._read_exactly(4 * m), np.int32).copy()
        scores = np.frombuffer(self._read_exactly(4 * m), np.float32).copy()
        return idx, scores

    def encode_sparse(self, texts: Sequence[str], k: int = 256):
        """SPLADE sparse vectors from an MLM-head model: one
        (int32 term ids, f32 weights) pair per text (\\x01TPW).  The server
        refuses cleanly (error frame) for dense models."""
        self._send_texts(MAGIC_SPARSE, list(texts), struct.pack("<I", k))
        (n,) = struct.unpack("<I", self._read_exactly(4))
        self._check_error(n)
        out = []
        for _ in range(n):
            (nnz,) = struct.unpack("<I", self._read_exactly(4))
            idx = np.frombuffer(self._read_exactly(4 * nnz), np.int32).copy()
            val = np.frombuffer(self._read_exactly(4 * nnz), np.float32).copy()
            out.append((idx, val))
        return out

    def maxsim(self, query: str, documents: Sequence[str],
               top_n: int | None = None):
        """Late-interaction MaxSim rerank (\\x01TPX; any model, no head
        needed): (indices [m] int32 descending, scores [m] f32 raw MaxSim
        sums)."""
        q = query.encode("utf-8")
        self._send_texts(
            MAGIC_MAXSIM, list(documents),
            struct.pack("<II", top_n or 0, len(q)) + q,
        )
        (m,) = struct.unpack("<I", self._read_exactly(4))
        self._check_error(m)
        idx = np.frombuffer(self._read_exactly(4 * m), np.int32).copy()
        scores = np.frombuffer(self._read_exactly(4 * m), np.float32).copy()
        return idx, scores

    def stats(self) -> dict:
        """Server metrics snapshot (TPES)."""
        import json

        self.sock.sendall(b"TPES")
        (n,) = struct.unpack("<I", self._read_exactly(4))
        return json.loads(self._read_exactly(n))

    def health(self) -> bool:
        self.sock.sendall(b"TPEH")
        (n,) = struct.unpack("<I", self._read_exactly(4))
        return self._read_exactly(n) == b"ok"

    def embed_raw(self, text: str) -> np.ndarray:
        """Reference-protocol single request (no framing)."""
        self.sock.sendall(text.encode("utf-8"))
        data = self._read_exactly(self.n_embd * 4)
        return np.frombuffer(data, np.float32).copy()

    def close(self) -> None:
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
