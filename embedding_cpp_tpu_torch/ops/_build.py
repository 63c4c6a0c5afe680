"""Builds the package's CUDA sources with nvcc and loads them with ctypes.

Each `csrc/*.cu` compiles on first use, one nvcc process per source, into
its own shared library with a plain C interface under `_build/` (a
directory git ignores), named by a hash of the source, every shared header
`csrc/*.cuh` and the flags, so an edited source or header rebuilds.  No PyTorch headers are compiled, which keeps a
build to seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("q4_matmul.cu", "attention_bse.cu", "attention_long.cu", "deberta_attention.cu",
           "attention_headpack.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        str(Path(home) / "bin" / "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{Path(name).stem}-{digest}.so"


def build(names=SOURCES, *, force: bool = False,
          ptxas_verbose: bool = False) -> dict[str, dict]:
    """Compile every listed source whose library is missing (every one with
    `force`), all nvcc processes started together.  Returns {name:
    {"seconds", "log"}} for the sources compiled in this call; raises with
    nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists() and not force:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(CSRC / name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    results, failures = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc {name} failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        results[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>`, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
