"""Builds the package's CUDA sources with nvcc and loads them with ctypes.

Each `csrc/*.cu` compiles on first use, one nvcc process per source, into
its own shared library with a plain C interface under `_build/` (a
directory git ignores), named by a hash of the source, every shared header
`csrc/*.cuh` and the flags (`utils/shared_libs.py`), so an edited source or
header rebuilds.  No PyTorch headers are compiled, which keeps a build to
seconds.
"""
from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

from ..utils.shared_libs import SharedLibraries, Source

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("q4_matmul.cu", "attention_bse.cu", "attention_long.cu", "deberta_attention.cu",
           "attention_headpack.cu", "layer_norm.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


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


_HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
LIBRARIES = SharedLibraries({name: Source(CSRC / name, _HEADERS, NVCC_FLAGS) for name in SOURCES},
                            _nvcc, BUILD_DIR)
lib_path = LIBRARIES.lib_path


def build(names=SOURCES, *, force: bool = False,
          ptxas_verbose: bool = False) -> dict[str, dict]:
    """Compile every listed source whose library is missing (every one with
    `force`), all nvcc processes started together.  Returns {name:
    {"seconds", "log"}} for the sources compiled in this call; raises with
    nvcc's output on failure."""
    return LIBRARIES.build(names, force=force,
                           extra_flags=("-Xptxas", "-v") if ptxas_verbose else ())


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>`, built first if missing."""
    return LIBRARIES.load(name)


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
