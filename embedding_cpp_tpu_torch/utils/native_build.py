"""Builds the repo's host C++ libraries (`native/`) for the port and loads
them with ctypes.

The three sources are compiled where they stand, read-only, with the flags
of `native/Makefile`: the tokenizer (`native/tokenizer/tokenizer.cpp`, with
its `json.hpp` and `unicode_tables.h`), the quant codec
(`native/gguf/codec.cpp`, also `-ffp-contract=off`, which its bit-parity
with the numpy codecs needs) and the JSON renderer
(`native/jsonfmt/jsonfmt.cpp`).  Each compiles on first use into the
port's `_build/` (a directory git ignores), by the builder of
`utils/shared_libs.py`.  The compiler is `$CXX`, else `g++`, else `c++`;
with none, or when the build fails, `load` raises with the compiler's
output, and the failure is remembered for the process.

The port builds its own copies: it never loads the Makefile's output
directory and takes no library path from the environment.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

from .shared_libs import SharedLibraries, Source

_PKG = Path(__file__).resolve().parents[1]
NATIVE = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"
# native/Makefile's CXXFLAGS, and -shared
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-Wno-unused-parameter",
             "-shared")


def compiler() -> str:
    """The C++ compiler's path: $CXX, else g++, else c++."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        path = name and shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler found (set CXX, or install g++)")


def compiler_version(cxx: str | None = None) -> str:
    """The first line of `<compiler> --version`."""
    out = subprocess.run([cxx or compiler(), "--version"], capture_output=True, text=True,
                         timeout=60)
    return (out.stdout or out.stderr).strip().splitlines()[0]


LIBRARIES = SharedLibraries({
    "tokenizer": Source(NATIVE / "tokenizer" / "tokenizer.cpp",
                        (NATIVE / "tokenizer" / "json.hpp",
                         NATIVE / "tokenizer" / "unicode_tables.h"), CXX_FLAGS),
    "codec": Source(NATIVE / "gguf" / "codec.cpp", (), CXX_FLAGS + ("-ffp-contract=off",)),
    "jsonfmt": Source(NATIVE / "jsonfmt" / "jsonfmt.cpp", (), CXX_FLAGS),
}, compiler, BUILD_DIR, prefix="libtpuembed_")
lib_path = LIBRARIES.lib_path
build = LIBRARIES.build
loaded = LIBRARIES.loaded


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name` ("tokenizer", "codec" or "jsonfmt"), built
    first if missing.  Raises ImportError, with the cause, when it cannot
    be built; a failure is not retried in this process."""
    try:
        return LIBRARIES.load(name)
    except RuntimeError as e:
        raise ImportError(f"native {e}") from e
