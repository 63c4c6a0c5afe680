"""The port's TCP server over a CPU engine on a free local port: the int32
n_embd handshake, a raw-mode text, and a TPE2 batch, each equal to
`engine.encode` (a synthetic MiniLM-shaped engine, a tiny-nomic GGUF and a
tiny CLS-pooled Q8_0 GGUF); the rerank frame over a DeBERTa cross-encoder,
equal to `engine.rerank`, and its error frames."""
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
from embedding_cpp_tpu_torch.models import DEBERTA_V3_BASE, MINILM_L6
from embedding_cpp_tpu_torch.runtime.server import MAGIC_RERANK, serve

CONFIG = replace(MINILM_L6, n_vocab=300, n_embd=64, n_head=4, n_ff=128,
                 n_layer=2, n_ctx=128)
RERANKER = replace(DEBERTA_V3_BASE, n_vocab=300, n_embd=64, n_head=4, n_ff=128,
                   n_layer=2, n_ctx=128, rel_attn_buckets=32, rel_attn_max_dist=128,
                   n_labels=1, head_activation="gelu")


@contextlib.contextmanager
def serve_in_thread(engine, **serve_kw):
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    loop = asyncio.new_event_loop()
    ready = threading.Event()
    holder = {}

    def main():
        asyncio.set_event_loop(loop)
        holder["task"] = loop.create_task(serve(engine, "127.0.0.1", port, **serve_kw))
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


@pytest.fixture(scope="module")
def nomic_engine(tmp_path_factory):
    """The JAX package's tiny-nomic preset in a Q4_0 GGUF (WordPiece vocab)."""
    from embedding_cpp_tpu.cli.make_test_model import make_test_model

    path = str(tmp_path_factory.mktemp("gguf") / "tiny-nomic-q4_0.gguf")
    make_test_model(path, "tiny-nomic", "q4_0", seed=0)
    return Engine.from_gguf(path, device="cpu")


@pytest.fixture(scope="module")
def q8_engine(tmp_path_factory):
    """A tiny CLS-pooled BERT in a Q8_0 GGUF (bge-large's pooling and
    weight type at 64 wide), written by the JAX package."""
    from embedding_cpp_tpu.models.config import BertConfig as JConfig
    from embedding_cpp_tpu.models.convert import FTYPE_NAMES, write_bert_gguf
    from embedding_cpp_tpu.models.params import random_state_dict
    from embedding_cpp_tpu.tokenizer.testvocab import build_tokenizer_json

    config = JConfig(n_vocab=1000, n_ctx=128, n_embd=64, n_layer=2, n_head=4, n_ff=256,
                     pooling="cls", name="tiny-q8-cls")
    path = str(tmp_path_factory.mktemp("gguf") / "tiny-q8_0.gguf")
    write_bert_gguf(path, config, random_state_dict(config, seed=0),
                    build_tokenizer_json(config.n_vocab), FTYPE_NAMES["q8_0"])
    return Engine.from_gguf(path, device="cpu")


def test_handshake_raw_and_tpe2(engine):
    _check_raw_and_tpe2(engine)


def test_nomic_gguf_served_raw_and_tpe2(nomic_engine):
    assert nomic_engine.config.arch == "nomic-bert"
    _check_raw_and_tpe2(nomic_engine)


def test_q8_cls_gguf_served_raw_and_tpe2(q8_engine):
    assert q8_engine.config.pooling == "cls"
    assert q8_engine.params["layers"]["ffn_up_w"].qtype.name == "Q8_0"
    _check_raw_and_tpe2(q8_engine)


def _check_raw_and_tpe2(engine):
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


@pytest.fixture(scope="module")
def reranker():
    return Engine.synthetic(RERANKER, "q4_0", device="cpu")


def _rerank_frame(query: str, docs: list[str], top_n: int) -> bytes:
    body = b"".join(struct.pack("<I", len(d.encode())) + d.encode() for d in docs)
    return (MAGIC_RERANK + struct.pack("<II", top_n, len(query.encode())) + query.encode()
            + struct.pack("<I", len(docs)) + body)


def _error(s) -> bytes:
    (ln,) = struct.unpack("<I", _recv(s, 4))
    return _recv(s, ln)


@pytest.mark.parametrize("top_n", [0, 2])
def test_rerank_frame_equals_engine_rerank(reranker, top_n):
    query = "the quick brown fox"
    docs = ["the lazy dog", "a quick brown fox jumps over the dog", "hello world",
            "welcome back soon"]
    want = reranker.rerank(query, docs, top_n=top_n or None)
    with serve_in_thread(reranker) as port, socket.create_connection(
            ("127.0.0.1", port), 10) as s:
        _recv(s, 4)
        s.sendall(_rerank_frame(query, docs, top_n))
        (m,) = struct.unpack("<I", _recv(s, 4))
        assert m == len(want) == (top_n or len(docs))
        idx = np.frombuffer(_recv(s, 4 * m), np.int32)
        scores = np.frombuffer(_recv(s, 4 * m), np.float32)
        # the connection stays usable: a second request on it
        s.sendall(_rerank_frame(query, docs[:1], 0))
        assert struct.unpack("<I", _recv(s, 4))[0] == 1
        _recv(s, 8)
    assert idx.tolist() == [r["index"] for r in want]
    np.testing.assert_allclose(scores, [r["relevance_score"] for r in want], rtol=0, atol=1e-6)
    assert np.all(np.diff(scores) <= 0) and np.all((scores > 0) & (scores < 1))


def test_rerank_frame_errors_keep_the_connection(reranker, engine):
    with serve_in_thread(reranker, max_pending=3) as port, socket.create_connection(
            ("127.0.0.1", port), 10) as s:
        _recv(s, 4)
        s.sendall(_rerank_frame("q", [], 0))  # no documents
        assert struct.unpack("<I", _recv(s, 4))[0] == 0xFFFFFFFF
        assert b"no documents" in _error(s)
        s.sendall(_rerank_frame("q", ["a", "b", "c", "d"], 0))  # over the pending cap
        assert struct.unpack("<I", _recv(s, 4))[0] == 0xFFFFFFFF
        assert b"OverloadedError" in _error(s)
        s.sendall(_rerank_frame("q", ["a", "b"], 0))
        assert struct.unpack("<I", _recv(s, 4))[0] == 2
        _recv(s, 16)
    with serve_in_thread(engine) as port, socket.create_connection(
            ("127.0.0.1", port), 10) as s:
        _recv(s, 4)
        s.sendall(_rerank_frame("q", ["a"], 0))  # an embedding model has no head
        assert struct.unpack("<I", _recv(s, 4))[0] == 0xFFFFFFFF
        assert b"classification head" in _error(s)
