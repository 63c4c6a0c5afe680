"""Helpers shared by the port's tests of the host C++ libraries and of the
serving surfaces: the compiler check, the JAX package's bindings pointed at
a built library, and a server on a background event loop."""
import asyncio
import contextlib
import importlib
import os
import shutil
import socket
import threading
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# library -> (the JAX package's binding, its path variable, native/build's file)
_JAX_BINDINGS = {
    "tokenizer": ("embedding_cpp_tpu.tokenizer.native", "TPUEMBED_TOKENIZER_LIB",
                  "libtpuembed_tokenizer.so"),
    "codec": ("embedding_cpp_tpu.gguf.native_codec", "TPUEMBED_CODEC_LIB",
              "libtpuembed_codec.so"),
    "jsonfmt": ("embedding_cpp_tpu.utils.jsonfmt", "TPUEMBED_JSONFMT_LIB",
                "libtpuembed_jsonfmt.so"),
}


def has_compiler() -> bool:
    return any(shutil.which(c) for c in (os.environ.get("CXX"), "g++", "c++") if c)


needs_compiler = pytest.mark.skipif(not has_compiler(), reason="no C++ compiler")


@contextlib.contextmanager
def jax_native(name: str):
    """The JAX package's binding of library `name` ("tokenizer", "codec" or
    "jsonfmt") loading `native/build/`'s copy where `make -C native` built
    it, else the port's build of the same source with the same flags.
    Yields the binding's module."""
    from embedding_cpp_tpu_torch.utils import native_build

    module_name, env, filename = _JAX_BINDINGS[name]
    module = importlib.import_module(module_name)
    path = ROOT / "native" / "build" / filename
    if not path.is_file():
        native_build.load(name)
        path = native_build.lib_path(name)
    saved = {a: getattr(module, a) for a in ("_lib", "_lib_failed") if hasattr(module, a)}
    old_env = os.environ.get(env)
    os.environ[env] = str(path)
    module._lib = None
    if "_lib_failed" in saved:
        module._lib_failed = False
    try:
        yield module
    finally:
        for a, v in saved.items():
            setattr(module, a, v)
        if old_env is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = old_env


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextlib.contextmanager
def serving(make_coro, *ports: int):
    """Run `make_coro()` (a server coroutine) on an event loop in a thread
    until every port in `ports` accepts; cancelled on exit."""
    loop = asyncio.new_event_loop()
    holder = {}

    def main():
        asyncio.set_event_loop(loop)
        holder["task"] = loop.create_task(make_coro())
        try:
            loop.run_until_complete(holder["task"])
        except asyncio.CancelledError:
            pass
        finally:
            loop.close()

    t = threading.Thread(target=main, daemon=True)
    t.start()
    for port in ports:
        for _ in range(200):
            try:
                socket.create_connection(("127.0.0.1", port), 0.2).close()
                break
            except OSError:
                time.sleep(0.05)
        else:
            raise RuntimeError(f"server did not listen on {port}")
    try:
        yield
    finally:
        loop.call_soon_threadsafe(holder["task"].cancel)
        t.join(timeout=10)
        assert not t.is_alive()
