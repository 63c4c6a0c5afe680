"""ctypes client over the native C ABI (`native/capi/tpuembed.h`, the
library of `native/capi`) against the port's embedding server: the port's copy
of the JAX package's `examples/sample_dylib.py`, with `examples/dylib.cpp`
beside it as the C driver.

The ABI streams embeddings from an engine server over the framed
protocol.  Its spawn mode (`tpe_load_from_file`) starts the JAX package's
server, so this example starts the port's own server
(`runtime/server.py`) as a subprocess and attaches with `tpe_connect`, or
attaches to a running one (`--connect`).  The library is compiled on
first use from `native/capi/tpuembed_capi.cpp` with the flags of
native/Makefile, by `utils/shared_libs.py` (which compiles every other
`native/` source too, through `utils/native_build.py`), into a
directory git ignores (`embedding_cpp_tpu_torch/_build/capi/` by default);
with `--demo`, `dylib.cpp` is compiled there with `g++ -O2 ... -ldl` and
run against the same server.

    python -m embedding_cpp_tpu_torch.examples.sample_dylib model.gguf [--device cpu] [--demo]
    python -m embedding_cpp_tpu_torch.examples.sample_dylib --connect HOST:PORT [--demo]

It prints the sentences' cosine matrix and, last, one JSON line (n_embd,
the matrix, the demo's output, and the server's device: the card's name
and power limit where it started the server on the card).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
ROOT = _PKG.parent
BUILD = _PKG / "_build" / "capi"
SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "A fast auburn fox leaps above the sleepy hound.",
    "Quantum entanglement cannot transmit information.",
]

_P, _I32, _F32 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_float
_STRS, _IDS, _FLOATS = (ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
                        ctypes.POINTER(ctypes.c_float))
# (restype, argtypes) of each tpuembed.h entry the client calls
_SIGNATURES = {
    "tpe_connect": (_P, [ctypes.c_char_p, ctypes.c_int]),
    "tpe_free": (None, [_P]),
    "tpe_n_embd": (_I32, [_P]),
    "tpe_n_max_tokens": (_I32, [_P]),
    "tpe_last_error": (ctypes.c_char_p, [_P]),
    "tpe_encode_batch": (ctypes.c_int, [_P, _I32, _STRS, _FLOATS]),
    "tpe_tokenize": (_I32, [_P, ctypes.c_char_p, _IDS, _I32]),
    "tpe_eval_batch": (ctypes.c_int, [_P, _I32, _IDS, _IDS, _FLOATS]),
    "tpe_vocab_id_to_token": (_I32, [_P, _I32, ctypes.c_char_p, _I32]),
    **{name: (_I32, [_P, _I32, _STRS]) for name in (
        "tpe_index", "tpe_sparse_index", "tpe_hybrid_index", "tpe_maxsim_index")},
    **{name: (_I32, [_P, _I32, _STRS, _I32, _IDS, _FLOATS]) for name in (
        "tpe_search", "tpe_sparse_search", "tpe_hybrid_search", "tpe_maxsim_search")},
    **{name: (_I32, [_P, ctypes.c_char_p, _I32, _STRS, _I32, _IDS, _FLOATS])
       for name in ("tpe_rerank", "tpe_maxsim")},
    "tpe_encode_sparse": (_I32, [_P, _I32, _STRS, _I32, _IDS, _FLOATS, _IDS]),
}


def _texts(strings):
    return (ctypes.c_char_p * len(strings))(*[t.encode() for t in strings])


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


class TpuEmbedModel:
    """The reference's BertModel ctypes wrapper over tpuembed.h, attached
    to a running server (`tpe_connect`)."""

    def __init__(self, host: str, port: int, lib_path: str):
        self.lib = ctypes.cdll.LoadLibrary(lib_path)
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.restype, fn.argtypes = res, args
        self.ctx = self.lib.tpe_connect(host.encode(), port)
        if not self.ctx:
            raise RuntimeError(f"tpe_connect to {host}:{port} failed")
        self.n_embd = self.lib.tpe_n_embd(self.ctx)

    def close(self) -> None:
        if getattr(self, "ctx", None):
            self.lib.tpe_free(self.ctx)
            self.ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _check(self, rc: int) -> int:
        """rc, or the library's last error raised where rc < 0."""
        if rc < 0:
            raise RuntimeError(self.lib.tpe_last_error(self.ctx).decode())
        return rc

    @property
    def n_max_tokens(self) -> int:
        return self.lib.tpe_n_max_tokens(self.ctx)

    def encode(self, sentences):
        """Sentences -> [n, n_embd] f32 (one sentence -> [n_embd])."""
        one = isinstance(sentences, str)
        sentences = [sentences] if one else list(sentences)
        out = np.zeros((len(sentences), self.n_embd), np.float32)
        if self.lib.tpe_encode_batch(self.ctx, len(sentences), _texts(sentences),
                                     _ptr(out, _FLOATS)) != 0:
            self._check(-1)
        return out[0] if one else out

    def tokenize(self, text: str) -> list[int]:
        """bert_tokenize: the framed token ids."""
        cap = max(16, self.n_max_tokens or 512)
        out = (ctypes.c_int32 * cap)()
        n = self._check(self.lib.tpe_tokenize(self.ctx, text.encode(), out, cap))
        return list(out[:min(n, cap)])

    def eval_tokens(self, id_lists) -> np.ndarray:
        """bert_eval_batch: pre-tokenized ids -> [n, n_embd]."""
        n = len(id_lists)
        lens = np.array([len(t) for t in id_lists], np.int32)
        flat = np.array([i for t in id_lists for i in t], np.int32)
        out = np.zeros((n, self.n_embd), np.float32)
        if self.lib.tpe_eval_batch(self.ctx, n, _ptr(lens, _IDS), _ptr(flat, _IDS),
                                   _ptr(out, _FLOATS)) != 0:
            self._check(-1)
        return out

    def id_to_token(self, token_id: int) -> str:
        buf = ctypes.create_string_buffer(256)
        self._check(self.lib.tpe_vocab_id_to_token(self.ctx, token_id, buf, 256))
        return buf.value.decode()

    def _index(self, fn, sentences) -> int:
        return self._check(fn(self.ctx, len(sentences), _texts(sentences)))

    def _search(self, fn, queries, k: int):
        n = len(queries)
        idx = np.zeros((n, k), np.int32)
        scores = np.zeros((n, k), np.float32)
        kr = self._check(fn(self.ctx, n, _texts(queries), k, _ptr(idx, _IDS),
                            _ptr(scores, _FLOATS)))
        # the entries are packed for kr columns
        return idx.reshape(-1)[:n * kr].reshape(n, kr), scores.reshape(-1)[:n * kr].reshape(n, kr)

    def index(self, sentences) -> int:
        """Into the server's on-device vector index; the total indexed."""
        return self._index(self.lib.tpe_index, sentences)

    def search(self, queries, k: int = 5):
        """Top-k over the on-device index: (ids [n, k'], scores [n, k'])."""
        return self._search(self.lib.tpe_search, queries, k)

    def sparse_index(self, sentences) -> int:
        return self._index(self.lib.tpe_sparse_index, sentences)

    def sparse_search(self, queries, k: int = 5):
        return self._search(self.lib.tpe_sparse_search, queries, k)

    def hybrid_index(self, sentences) -> int:
        return self._index(self.lib.tpe_hybrid_index, sentences)

    def hybrid_search(self, queries, k: int = 5):
        return self._search(self.lib.tpe_hybrid_search, queries, k)

    def maxsim_index(self, sentences) -> int:
        return self._index(self.lib.tpe_maxsim_index, sentences)

    def maxsim_search(self, queries, k: int = 5):
        return self._search(self.lib.tpe_maxsim_search, queries, k)

    def _rank(self, fn, query: str, documents, top_n):
        n = len(documents)
        cap = min(top_n, n) if top_n else n
        idx = np.zeros(cap, np.int32)
        scores = np.zeros(cap, np.float32)
        m = self._check(fn(self.ctx, query.encode(), n, _texts(documents), top_n or 0,
                           _ptr(idx, _IDS), _ptr(scores, _FLOATS)))
        return idx[:m], scores[:m]

    def rerank(self, query: str, documents, top_n=None):
        """Cross-encoder rerank (a model with a classification head):
        (indices, sigmoid scores) descending."""
        return self._rank(self.lib.tpe_rerank, query, documents, top_n)

    def maxsim(self, query: str, documents, top_n=None):
        """Late-interaction MaxSim rerank: (indices, raw scores) descending."""
        return self._rank(self.lib.tpe_maxsim, query, documents, top_n)

    def encode_sparse(self, sentences, k: int = 256):
        """SPLADE vectors (an MLM-head model): (term ids, weights) a sentence."""
        n = len(sentences)
        ids = np.zeros((n, k), np.int32)
        ws = np.zeros((n, k), np.float32)
        nnz = np.zeros(n, np.int32)
        if self.lib.tpe_encode_sparse(self.ctx, n, _texts(sentences), k, _ptr(ids, _IDS),
                                      _ptr(ws, _FLOATS), _ptr(nnz, _IDS)) != 0:
            self._check(-1)
        return [(ids[i, :nnz[i]].copy(), ws[i, :nnz[i]].copy()) for i in range(n)]


def build_library(build_dir: Path = BUILD) -> Path:
    """The C ABI library compiled from native/capi (read only) into
    `build_dir` with native/Makefile's flags, once for each version of its
    source and header; its path."""
    from ..utils.native_build import CXX_FLAGS, NATIVE, compiler
    from ..utils.shared_libs import SharedLibraries, Source

    capi = NATIVE / "capi"
    libs = SharedLibraries({"capi": Source(capi / "tpuembed_capi.cpp", (capi / "tpuembed.h",),
                                           CXX_FLAGS)}, compiler, Path(build_dir).resolve(),
                           prefix="libtpuembed_")
    libs.build(["capi"])
    return libs.lib_path("capi")


def build_demo(build_dir: Path = BUILD) -> Path:
    """dylib.cpp compiled with `g++ -O2 ... -ldl` into `build_dir`."""
    from ..utils.native_build import compiler

    exe = Path(build_dir).resolve() / "dylib_demo"
    exe.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([compiler(), "-O2", "-o", str(exe), str(Path(__file__).parent /
                                                               "dylib.cpp"), "-ldl"],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"building dylib.cpp failed:\n{r.stdout}\n{r.stderr}")
    return exe


def run_demo(exe: Path, lib: Path, host: str, port: int) -> str:
    """The C driver against the server; its standard output."""
    r = subprocess.run([str(exe), str(lib), host, str(port)], capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"dylib_demo failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    return r.stdout


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_server(model: str, port: int, device: str | None, dtype: str, log_path: Path,
                 timeout: float = 600.0) -> subprocess.Popen:
    """The port's server (`runtime/server.py`, f32 output) over `model` on
    127.0.0.1:`port`, returned once it accepts connections."""
    log_path.parent.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "embedding_cpp_tpu_torch.runtime.server", "-m", str(model),
           "--host", "127.0.0.1", "--port", str(port), "--dtype", dtype,
           "--output-dtype", "float32", *(["--device", device] if device else [])]
    proc = subprocess.Popen(cmd, cwd=str(ROOT), stdout=open(log_path, "w"),
                            stderr=subprocess.STDOUT)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"the server exited ({proc.returncode}):\n"
                               f"{log_path.read_text()[-3000:]}")
        try:
            socket.create_connection(("127.0.0.1", port), 0.5).close()
            return proc
        except OSError:
            time.sleep(0.2)
    proc.kill()
    raise RuntimeError(f"the server did not listen within {timeout} s")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", nargs="?", help="GGUF file: start the port's server over it")
    p.add_argument("--connect", metavar="HOST:PORT", help="attach to a running server")
    p.add_argument("--device", default=None,
                   help="the started server's device (default: the GPU, which it then needs)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16",
                   help="the started server's activations")
    p.add_argument("--build-dir", default=str(BUILD))
    p.add_argument("--demo", action="store_true", help="also build and run dylib.cpp")
    args = p.parse_args(argv)
    if (args.model is None) == (args.connect is None):
        p.error("give a model file or --connect HOST:PORT")

    from ..utils.profiling import device_block

    lib = build_library(Path(args.build_dir))
    proc = None
    try:
        if args.connect:
            host, port = args.connect.rsplit(":", 1)
            port, device = int(port), f"the server at {args.connect}"
        else:
            from ..runtime.engine import resolve_device

            dev = resolve_device(args.device)  # no card and no --device: raises here
            host, port = "127.0.0.1", _free_port()
            proc = start_server(args.model, port, str(dev), args.dtype,
                                Path(args.build_dir) / "server.log")
            device = device_block(dev)
        with TpuEmbedModel(host, port, str(lib)) as model:
            vecs = model.encode(SENTENCES)
        sims = vecs @ vecs.T
        print(f"n_embd = {vecs.shape[1]}")
        for i, s in enumerate(SENTENCES):
            print(f"[{i}] {s}")
        print("cosine similarity matrix:")
        print(np.array_str(sims, precision=4))
        demo = run_demo(build_demo(Path(args.build_dir)), lib, host, port) if args.demo else None
        if demo:
            print(demo, end="")
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    result = {"n_embd": int(vecs.shape[1]), "sentences": SENTENCES,
              "embeddings": vecs.tolist(), "cosine": sims.tolist(), "demo": demo,
              "device": device}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
