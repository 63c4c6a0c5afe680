"""Builds the JAX package's native libraries (`make -C native`) once, when
this module is collected, so the tests that look for `native/build/` find
it whatever order they run in.

`native/build/` is git-ignored, so a clean checkout starts without it, and
`tests/test_native_codec.py`'s fixture used to build it partway through a
run: under `-n 6 --dist loadfile`, whether the bpe tokenizer, C API,
jsonfmt and tokenizer tests that need the libraries passed or skipped
depended on which worker reached them first.  Some of them decide at
import (`tests/test_capi.py`'s module mark, `tests/test_jsonfmt.py`'s
`skipif`), so the build must come before those modules are collected:
pytest collects a directory's entries in name order, depth first, and
this module's directory sorts before every `tests/test_*.py`.  Every
xdist worker collects every module, so the build runs once, under a file
lock in the temp directory (the workers collect at once), with a 120 s
limit, and only where `make` and `g++` exist and a library is missing.  A failed or timed-out build is recorded, not raised:
without a toolchain those tests skip as before.
"""
import ctypes
import fcntl
import shutil
import subprocess
import tempfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BUILD = ROOT / "native" / "build"
LIBRARIES = ("libtpuembed_tokenizer.so", "libtpuembed_codec.so", "libtpuembed_capi.so",
             "libtpuembed_jsonfmt.so")


def _missing() -> list[str]:
    return [name for name in LIBRARIES if not (BUILD / name).is_file()]


def _toolchain() -> bool:
    return bool(shutil.which("make") and shutil.which("g++"))


def prebuild(timeout: float = 120.0) -> str:
    """Build native/ where a library is missing and a toolchain exists;
    returns what happened ("present", "built", "no toolchain" or why the
    build failed)."""
    if not _missing():
        return "present"
    if not _toolchain():
        return "no toolchain"
    try:
        with open(Path(tempfile.gettempdir()) / "tpuembed_native_prebuild.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # another worker may be building
            if not _missing():
                return "present"
            r = subprocess.run(["make", "-C", str(ROOT / "native")], capture_output=True,
                               text=True, timeout=timeout)
    except (OSError, subprocess.SubprocessError) as e:
        return f"build failed: {e}"
    if r.returncode or _missing():
        return f"build failed (make exit {r.returncode}): {r.stderr[-500:]}"
    return "built"


PREBUILD = prebuild()


def test_native_libraries_load_where_a_compiler_exists():
    if not _toolchain():
        pytest.skip("no C++ toolchain (make, g++)")
    assert not _missing(), PREBUILD
    for name in LIBRARIES:
        ctypes.CDLL(str(BUILD / name))
