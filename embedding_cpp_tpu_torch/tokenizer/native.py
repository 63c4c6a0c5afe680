"""ctypes binding to the C++ tokenizer engines of `native/tokenizer`:
WordPiece (the BERT family), byte-level BPE (RoBERTa, ModernBERT) and
SentencePiece Unigram (DeBERTa-v3, XLM-R, ALBERT).

C ABI (`native/tokenizer/tokenizer.cpp`):
    void*   tpuembed_tokenizer_new(const char* json, size_t len);  // NULL: rejected
    void    tpuembed_tokenizer_free(void*);
    int32_t tpuembed_model_kind(void*);          // 0 WordPiece, 1 BPE, 2 Unigram
    int32_t tpuembed_encode(void*, const char* text, size_t len,
                            int32_t* out, int32_t cap);   // n, or -needed
    int64_t tpuembed_encode_batch(void*, const char** texts, const int64_t* lens,
                                  int32_t n, int32_t n_threads, int32_t* out,
                                  int64_t cap, int64_t* offsets);  // total, or -needed
    int32_t tpuembed_id_to_token(void*, int32_t id, char* out, int32_t cap);

The library is the port's own build (`utils/native_build.py`).  Every
encode call allocates its own output buffer, so one instance serves
several threads at once.  `encode_batch` runs the library's thread pool
outside the GIL and returns one int32 array per text.
"""
from __future__ import annotations

import ctypes
import json
import os
from typing import Sequence

import numpy as np

from ..utils import native_build
from .bpe import unicode_to_bytes
from .wordpiece import decode_wordpiece

_lib = None
_ENCODE_CAP = 8192  # ids a single encode call tries first
_TOKEN_CAP = 512  # bytes of a token string


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = native_build.load("tokenizer")
        lib.tpuembed_tokenizer_new.restype = ctypes.c_void_p
        lib.tpuembed_tokenizer_new.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.tpuembed_tokenizer_free.argtypes = [ctypes.c_void_p]
        lib.tpuembed_model_kind.restype = ctypes.c_int32
        lib.tpuembed_model_kind.argtypes = [ctypes.c_void_p]
        lib.tpuembed_encode.restype = ctypes.c_int32
        lib.tpuembed_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.tpuembed_encode_batch.restype = ctypes.c_int64
        lib.tpuembed_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        lib.tpuembed_id_to_token.restype = ctypes.c_int32
        lib.tpuembed_id_to_token.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p,
                                             ctypes.c_int32]
        _lib = lib
    return _lib


class NativeTokenizer:
    """A tokenizer.json's engine in C++; `ValueError` when the library
    refuses the json (a malformed blob, or a shape it does not handle)."""

    def __init__(self, tokenizer_json: bytes | str):
        if isinstance(tokenizer_json, str):
            tokenizer_json = tokenizer_json.encode("utf-8")
        self._lib = _load()
        self._handle = self._lib.tpuembed_tokenizer_new(tokenizer_json, len(tokenizer_json))
        if not self._handle:
            raise ValueError("native tokenizer rejected tokenizer.json")
        self.kind = self._lib.tpuembed_model_kind(self._handle)
        self._blob = tokenizer_json  # read again for the decoders' settings
        self._added_ids: set[int] | None = None
        self._metaspace: tuple[str, str] | None = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.tpuembed_tokenizer_free(self._handle)
            self._handle = None

    def encode(self, text: str) -> list[int]:
        raw = text.encode("utf-8")
        cap = _ENCODE_CAP
        while True:
            buf = (ctypes.c_int32 * cap)()
            n = self._lib.tpuembed_encode(self._handle, raw, len(raw), buf, cap)
            if n >= 0:
                return list(buf[:n])
            cap = -n  # the buffer was short: the library says how long

    def encode_batch(self, texts: Sequence[str], n_threads: int | None = None
                     ) -> list[np.ndarray]:
        """One int32 array of ids per text, tokenized by the library's
        thread pool (at most 8 threads)."""
        n = len(texts)
        if n == 0:
            return []
        if n_threads is None:
            n_threads = min(8, os.cpu_count() or 1)
        raws = [t.encode("utf-8") for t in texts]
        arr = (ctypes.c_char_p * n)(*raws)
        lens = (ctypes.c_int64 * n)(*[len(r) for r in raws])
        offsets = (ctypes.c_int64 * (n + 1))()
        cap = max(_ENCODE_CAP, sum(len(r) for r in raws) + 2 * n)
        while True:
            out = (ctypes.c_int32 * cap)()
            total = self._lib.tpuembed_encode_batch(self._handle, arr, lens, n, n_threads,
                                                    out, cap, offsets)
            if total >= 0:
                break
            cap = -total
        flat = np.ctypeslib.as_array(out, shape=(cap,))[:total].copy()
        offs = np.ctypeslib.as_array(offsets, shape=(n + 1,))
        return [flat[offs[i]: offs[i + 1]] for i in range(n)]

    def id_to_token(self, token_id: int) -> str:
        """The token of an id; "" for an id outside the vocabulary."""
        out = ctypes.create_string_buffer(_TOKEN_CAP)
        n = self._lib.tpuembed_id_to_token(self._handle, int(token_id), out, _TOKEN_CAP)
        if n < 0:  # a token longer than the buffer
            out = ctypes.create_string_buffer(-n)
            n = self._lib.tpuembed_id_to_token(self._handle, int(token_id), out, -n)
        return out.raw[:n].decode("utf-8", errors="replace") if n > 0 else ""

    def decode(self, ids) -> str:
        """Ids -> text by the json's decoder: ByteLevel (BPE), Metaspace
        (Unigram) or WordPiece."""
        if self.kind == 1:
            return self._decode_byte_level(ids)
        if self.kind == 2:
            return self._decode_metaspace(ids)
        return decode_wordpiece(self.id_to_token, ids)

    def _spec(self) -> dict:
        try:
            return json.loads(self._blob)
        except ValueError:
            return {}

    def _decode_metaspace(self, ids) -> str:
        """The replacement character -> space, the first token's leading
        separator stripped unless prepend_scheme is "never"."""
        if self._metaspace is None:
            pre = self._spec().get("pre_tokenizer") or {}
            scheme = pre.get("prepend_scheme")
            if scheme is None:
                scheme = "always" if pre.get("add_prefix_space", True) else "never"
            self._metaspace = (pre.get("replacement", "▁"), scheme)
        rep, scheme = self._metaspace
        out: list[str] = []
        for n, i in enumerate(ids):
            piece = self.id_to_token(int(i)).replace(rep, " ")
            if n == 0 and scheme != "never" and piece.startswith(" "):
                piece = piece[1:]
            out.append(piece)
        return "".join(out)

    def _decode_byte_level(self, ids) -> str:
        """Token characters back to bytes; added tokens pass through as
        they are."""
        if self._added_ids is None:
            self._added_ids = {int(t["id"]) for t in self._spec().get("added_tokens", [])}
        u2b = unicode_to_bytes()
        out: list[str] = []
        raw = bytearray()
        for i in ids:
            i = int(i)
            tok = self.id_to_token(i)
            if i in self._added_ids:
                if raw:
                    out.append(raw.decode("utf-8", errors="replace"))
                    raw = bytearray()
                out.append(tok)
                continue
            for ch in tok:
                b = u2b.get(ch)
                if b is not None:
                    raw.append(b)
                else:  # not a byte-mapped character (a malformed vocabulary)
                    raw.extend(ch.encode("utf-8"))
        if raw:
            out.append(raw.decode("utf-8", errors="replace"))
        return "".join(out)
