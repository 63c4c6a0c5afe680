"""Compiles shared libraries from source on first use and loads them with
ctypes: the one builder behind the CUDA kernels (`ops/_build.py`, nvcc)
and the host C++ libraries (`utils/native_build.py`).

Each library is named by a hash of its source, its headers and its flags,
so an edited source or header rebuilds.  The compilers of one `build` call
start together; each writes a temporary file that is renamed into place,
under a file lock, so processes that start together build a library once.
A failed build raises with the compiler's output, and `load` remembers the
failure for the process.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable


@dataclass(frozen=True)
class Source:
    path: Path
    headers: tuple[Path, ...] = ()
    flags: tuple[str, ...] = ()


class SharedLibraries:
    """The libraries `sources` names ({name: Source}), compiled by the
    compiler `compiler()` returns into `build_dir` as
    `<prefix><stem of name>-<hash>.so`."""

    def __init__(self, sources: dict[str, Source], compiler: Callable[[], str],
                 build_dir: Path, prefix: str = ""):
        self.sources = sources
        self.compiler = compiler
        self.build_dir = build_dir
        self.prefix = prefix
        self._lock = threading.Lock()
        self._libs: dict[str, ctypes.CDLL] = {}
        self._failed: dict[str, str] = {}

    def lib_path(self, name: str) -> Path:
        src = self.sources[name]
        h = hashlib.sha256(src.path.read_bytes())
        for header in src.headers:
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(src.flags).encode())
        return self.build_dir / f"{self.prefix}{Path(name).stem}-{h.hexdigest()[:16]}.so"

    def build(self, names: Iterable[str] | None = None, *, force: bool = False,
              extra_flags: tuple[str, ...] = ()) -> dict[str, dict]:
        """Compile every listed library that is missing (every one with
        `force`; all of them by default), the compilers started together.
        Returns {name: {"seconds", "log"}} for the libraries compiled in
        this call; raises with the compiler's output on failure."""
        names = tuple(self.sources) if names is None else tuple(names)
        self.build_dir.mkdir(parents=True, exist_ok=True)
        cc = self.compiler()
        with open(self.build_dir / f".{self.prefix or 'lib'}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building
            procs = {}
            for name in names:
                out = self.lib_path(name)
                if out.exists() and not force:
                    continue
                src = self.sources[name]
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [cc, *src.flags, *extra_flags, "-o", str(tmp), str(src.path)]
                procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True),
                               tmp, out, time.perf_counter())
            results, failures = {}, []
            for name, (proc, tmp, out, t0) in procs.items():
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    failures.append(f"{Path(cc).name} {self.sources[name].path.name} failed "
                                    f"({proc.returncode}):\n{log}")
                    continue
                os.replace(tmp, out)
                results[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if failures:
            raise RuntimeError("\n".join(failures))
        return results

    def load(self, name: str) -> ctypes.CDLL:
        """The loaded library `name`, built first if missing.  Raises
        RuntimeError when it cannot be built or loaded; a failure is not
        retried in this process."""
        with self._lock:
            lib = self._libs.get(name)
            if lib is not None:
                return lib
            if name in self._failed:
                raise RuntimeError(self._failed[name])
            try:
                path = self.lib_path(name)
                if not path.exists():
                    self.build([name])
                lib = self._libs[name] = ctypes.CDLL(str(path))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                self._failed[name] = f"library {name} unavailable: {e}"
                raise RuntimeError(self._failed[name]) from e
            return lib

    def loaded(self) -> dict[str, str]:
        """{name: path} of the libraries this process has loaded."""
        with self._lock:
            return {name: lib._name for name, lib in self._libs.items()}
