"""The port's TCP server over a CPU engine on a free local port: the int32
n_embd handshake, a raw-mode text, and a TPE2 batch, each equal to
`engine.encode`."""
import asyncio
import contextlib
import socket
import struct
import threading
import time
from dataclasses import replace

import numpy as np
import pytest

from embedding_cpp_tpu_torch import Engine
from embedding_cpp_tpu_torch.models import MINILM_L6
from embedding_cpp_tpu_torch.runtime.server import serve

CONFIG = replace(MINILM_L6, n_vocab=300, n_embd=64, n_head=4, n_ff=128,
                 n_layer=2, n_ctx=128)


@contextlib.contextmanager
def serve_in_thread(engine):
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    loop = asyncio.new_event_loop()
    ready = threading.Event()
    holder = {}

    def main():
        asyncio.set_event_loop(loop)
        holder["task"] = loop.create_task(serve(engine, "127.0.0.1", port))
        loop.call_soon(ready.set)
        try:
            loop.run_until_complete(holder["task"])
        except asyncio.CancelledError:
            pass
        finally:
            loop.close()

    t = threading.Thread(target=main, daemon=True)
    t.start()
    assert ready.wait(10)
    for _ in range(100):
        try:
            socket.create_connection(("127.0.0.1", port), 0.2).close()
            break
        except OSError:
            time.sleep(0.05)
    try:
        yield port
    finally:
        loop.call_soon_threadsafe(holder["task"].cancel)
        t.join(timeout=10)
        assert not t.is_alive()


def _recv(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "connection closed"
        buf += chunk
    return buf


@pytest.fixture(scope="module")
def engine():
    return Engine.synthetic(CONFIG, "q4_0", device="cpu")


def test_handshake_raw_and_tpe2(engine):
    texts = ["hello world", "the quick brown fox jumps over the lazy dog", "a"]
    want = engine.encode(texts)
    with serve_in_thread(engine) as port, socket.create_connection(
            ("127.0.0.1", port), 10) as s:
        (n_embd,) = struct.unpack("<i", _recv(s, 4))
        assert n_embd == engine.n_embd == 64

        s.sendall(texts[0].encode())
        raw = np.frombuffer(_recv(s, 4 * n_embd), np.float32)
        np.testing.assert_allclose(raw, want[0], rtol=0, atol=1e-6)

        body = b"".join(struct.pack("<I", len(t.encode())) + t.encode() for t in texts)
        s.sendall(b"TPE2" + struct.pack("<I", len(texts)) + body)
        (count,) = struct.unpack("<I", _recv(s, 4))
        assert count == 3
        vecs = np.frombuffer(_recv(s, 4 * count * n_embd), np.float32).reshape(count, n_embd)
        np.testing.assert_allclose(vecs, want, rtol=0, atol=1e-6)


def test_malformed_frame_gets_an_error_frame(engine):
    with serve_in_thread(engine) as port, socket.create_connection(
            ("127.0.0.1", port), 10) as s:
        _recv(s, 4)
        s.sendall(b"TPE2" + struct.pack("<I", 1 << 20))  # count over the cap
        (flag,) = struct.unpack("<I", _recv(s, 4))
        assert flag == 0xFFFFFFFF
        (ln,) = struct.unpack("<I", _recv(s, 4))
        assert b"malformed" in _recv(s, ln)
