"""The port's TCP server over a CPU engine on a free local port: the int32
n_embd handshake, a raw-mode text, and a TPE2 batch, each equal to
`engine.encode` (a synthetic MiniLM-shaped engine, a tiny-nomic GGUF and a
tiny CLS-pooled Q8_0 GGUF); the rerank frame over a DeBERTa cross-encoder,
equal to `engine.rerank`, and its error frames.  The reference's bert.h
frames (meta, health, tokenize, vocab, eval, int8 encode, stats) against
the reference's own server over one GGUF, the sparse (\x01TPW, on a
tiny-splade GGUF) and MaxSim (\x01TPX) frames against the reference's
server, and each frame the port does not serve yet answered by an error
frame on a connection that stays usable."""
import asyncio
import contextlib
import json
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


# --- the reference's bert.h frames, against the reference's own server -------

TEXTS = ["hello world", "the quick brown fox jumps over the lazy dog", "a",
         "Hello, World!  Ünïcödé 中文"]
ATOL_F32 = 2e-5  # the f32 bar of the engine parity tests


@pytest.fixture(scope="module")
def engine_pair(tmp_path_factory):
    """The port's and the reference's CPU engines over one tiny f32 GGUF
    written by the JAX package (same weights, vocab and name)."""
    from embedding_cpp_tpu.cli.make_test_model import make_test_model
    from embedding_cpp_tpu.runtime.engine import Engine as JEngine

    path = str(tmp_path_factory.mktemp("gguf") / "tiny-f32.gguf")
    make_test_model(path, "tiny", "f32", seed=0)
    return Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)


@contextlib.contextmanager
def both_servers(engine_pair):
    """Connected sockets (port, reference), handshakes read."""
    from conftest import serve_in_thread as serve_reference

    ours, theirs = engine_pair
    with serve_in_thread(ours) as p1, serve_reference(theirs) as p2, \
            socket.create_connection(("127.0.0.1", p1), 30) as s1, \
            socket.create_connection(("127.0.0.1", p2), 30) as s2:
        for s in (s1, s2):
            s.settimeout(60)
            assert struct.unpack("<i", _recv(s, 4))[0] == 64
        yield s1, s2


def _texts_body(texts) -> bytes:
    return struct.pack("<I", len(texts)) + b"".join(
        struct.pack("<I", len(t.encode())) + t.encode() for t in texts)


def _len_prefixed(s) -> bytes:
    (ln,) = struct.unpack("<I", _recv(s, 4))
    assert ln != 0xFFFFFFFF, _error(s)
    return _recv(s, ln)


def _token_lists(s) -> list[list[int]]:
    (n,) = struct.unpack("<I", _recv(s, 4))
    assert n != 0xFFFFFFFF, _error(s)
    out = []
    for _ in range(n):
        (k,) = struct.unpack("<I", _recv(s, 4))
        out.append(np.frombuffer(_recv(s, 4 * k), np.int32).tolist())
    return out


def _f32_reply(s, n_embd: int = 64) -> np.ndarray:
    (n,) = struct.unpack("<I", _recv(s, 4))
    assert n != 0xFFFFFFFF, _error(s)
    return np.frombuffer(_recv(s, 4 * n * n_embd), np.float32).reshape(n, n_embd)


def _i8_reply(s, n_embd: int = 64) -> tuple[np.ndarray, np.ndarray]:
    (n,) = struct.unpack("<I", _recv(s, 4))
    assert n != 0xFFFFFFFF, _error(s)
    scale = np.frombuffer(_recv(s, 4 * n), np.float32)
    codes = np.frombuffer(_recv(s, n * n_embd), np.int8).reshape(n, n_embd)
    return scale, codes


def test_meta_health_tokenize_vocab_replies_are_byte_equal(engine_pair):
    ids = [0, 1, 2, 3, 5, 150, 999, 1000, 5000, 2**31 + 7]
    with both_servers(engine_pair) as socks:
        replies = []
        for s in socks:
            s.sendall(b"\x01TPM")
            meta = _len_prefixed(s)
            s.sendall(b"TPEH")
            health = _recv(s, 6)
            s.sendall(b"\x01TPT" + _texts_body(TEXTS))
            toks = _token_lists(s)
            vocab = []
            for i in ids:
                s.sendall(b"\x01TPV" + struct.pack("<I", i))
                vocab.append(_len_prefixed(s))
            replies.append((meta, health, toks, vocab))
    assert replies[0] == replies[1]
    meta, health, toks, vocab = replies[0]
    ours, _ = engine_pair
    assert json.loads(meta) == {"n_embd": 64, "n_max_tokens": ours.config.n_ctx,
                                "name": ours.config.name}
    assert health == struct.pack("<I", 2) + b"ok"
    assert toks == [ours.tokenize(t) for t in TEXTS]
    assert vocab[-2:] == [b"", b""]  # unknown ids: empty tokens
    assert [v.decode() for v in vocab[:-2]] == [ours.id_to_token(i) for i in ids[:-2]]


def test_eval_and_int8_replies_meet_the_f32_bar(engine_pair):
    ours, _ = engine_pair
    id_lists = [ours.tokenize(t) for t in TEXTS] + [[2, 3]]
    eval_body = struct.pack("<I", len(id_lists)) + b"".join(
        struct.pack("<I", len(ids)) + np.asarray(ids, np.int32).tobytes() for ids in id_lists)
    with both_servers(engine_pair) as socks:
        got = []
        for s in socks:
            s.sendall(b"\x01TPI" + eval_body)
            ev = _f32_reply(s)
            s.sendall(b"TPE2" + _texts_body(TEXTS))
            enc = _f32_reply(s)
            s.sendall(b"\x01TP8" + _texts_body(TEXTS))
            got.append((ev, enc, _i8_reply(s)))
    (ev, enc, (scale, codes)), (ev_ref, enc_ref, (scale_ref, codes_ref)) = got
    np.testing.assert_allclose(ev, ev_ref, rtol=0, atol=ATOL_F32)
    np.testing.assert_allclose(ev, ours.embed_tokens(id_lists), rtol=0, atol=1e-6)
    np.testing.assert_allclose(enc, enc_ref, rtol=0, atol=ATOL_F32)
    # each server's int8 reply is its own f32 reply quantized, byte for byte
    from embedding_cpp_tpu.runtime.server import _quantize_i8_np

    want_codes, want_scale = _quantize_i8_np(enc_ref)
    assert codes_ref.tobytes() == want_codes.tobytes()
    assert scale_ref.tobytes() == want_scale.tobytes()
    want_codes, want_scale = _quantize_i8_np(enc)
    assert codes.tobytes() == want_codes.tobytes()
    assert scale.tobytes() == want_scale.tobytes()
    # across servers: the scales at the f32 bar, the codes within the one
    # step an f32-bar difference can flip at a rounding boundary
    np.testing.assert_allclose(scale, scale_ref, rtol=0, atol=ATOL_F32)
    assert np.abs(codes.astype(int) - codes_ref).max() <= 1
    np.testing.assert_allclose(codes * scale[:, None], codes_ref * scale_ref[:, None],
                               rtol=0, atol=scale_ref.max() + ATOL_F32)


def test_stats_reply_has_the_reference_layout(engine_pair):
    with both_servers(engine_pair) as socks:
        snaps = []
        for s in socks:
            s.sendall(b"TPE2" + _texts_body(TEXTS[:2]))
            _f32_reply(s)
            s.sendall(b"TPES")
            snaps.append(json.loads(_len_prefixed(s)))
    ours, theirs = snaps
    assert set(ours) >= {"uptime_s", "counters", "timers_s", "timer_counts", "server"}
    assert set(ours["server"]) == set(theirs["server"])
    assert ours["server"]["connections"] >= 1 and ours["server"]["requests"] >= 1
    assert ours["server"]["sentences"] >= 2 and ours["server"]["batches"] >= 1
    for key in ("sentences", "tokens", "batches", "padded_slots"):
        assert ours["counters"][key] > 0, key
    assert ours["timer_counts"]["eval"] >= 1


def _ranked(s) -> tuple[list[int], np.ndarray]:
    (m,) = struct.unpack("<I", _recv(s, 4))
    assert m != 0xFFFFFFFF, _error(s)
    return np.frombuffer(_recv(s, 4 * m), np.int32).tolist(), np.frombuffer(
        _recv(s, 4 * m), np.float32)


def _sparse_reply(s) -> list[tuple[np.ndarray, np.ndarray]]:
    (n,) = struct.unpack("<I", _recv(s, 4))
    assert n != 0xFFFFFFFF, _error(s)
    out = []
    for _ in range(n):
        (m,) = struct.unpack("<I", _recv(s, 4))
        out.append((np.frombuffer(_recv(s, 4 * m), np.int32),
                    np.frombuffer(_recv(s, 4 * m), np.float32)))
    return out


@pytest.mark.parametrize("top_n", [0, 3])
def test_maxsim_frame_matches_the_reference(engine_pair, top_n):
    """\x01TPX (MaxSim rerank over any model's token states): the rerank
    layout in, indices and raw MaxSim scores out, as the reference's
    server answers, and equal to Engine.maxsim_rerank; an empty document
    list gets the error frame."""
    query, docs = "the quick brown fox", TEXTS + ["hello world again"]
    frame = (b"\x01TPX" + struct.pack("<II", top_n, len(query.encode())) + query.encode()
             + _texts_body(docs))
    with both_servers(engine_pair) as socks:
        replies = []
        for s in socks:
            s.sendall(frame)
            replies.append(_ranked(s))
            s.sendall(b"\x01TPX" + struct.pack("<II", 0, 1) + b"q" + _texts_body([]))
            assert struct.unpack("<I", _recv(s, 4))[0] == 0xFFFFFFFF
            assert b"no documents" in _error(s)
    (idx, scores), (idx_ref, scores_ref) = replies
    assert idx == idx_ref and len(idx) == (top_n or len(docs))
    np.testing.assert_allclose(scores, scores_ref, rtol=0, atol=ATOL_F32)
    ours, _ = engine_pair
    want = ours.maxsim_rerank(query, docs, top_n=top_n or None)
    assert idx == [r["index"] for r in want]
    np.testing.assert_allclose(scores, [r["relevance_score"] for r in want], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def splade_pair(tmp_path_factory):
    from embedding_cpp_tpu.cli.make_test_model import make_test_model
    from embedding_cpp_tpu.runtime.engine import Engine as JEngine

    path = str(tmp_path_factory.mktemp("gguf") / "tiny-splade.gguf")
    make_test_model(path, "tiny-splade", "f32", seed=0)
    return Engine.from_gguf(path, device="cpu"), JEngine.from_gguf(path)


@pytest.mark.parametrize("k", [1, 16, 300])
def test_sparse_frame_matches_the_reference(splade_pair, k):
    """\x01TPW (SPLADE): u32 k | texts in, per text u32 n | n ids | n
    weights out, as the reference's server answers (ids as sets: top-k
    orders ties freely) and equal to Engine.encode_sparse."""
    frame = b"\x01TPW" + struct.pack("<I", k) + _texts_body(TEXTS)
    with both_servers(splade_pair) as socks:
        replies = []
        for s in socks:
            s.sendall(frame)
            replies.append(_sparse_reply(s))
    ours, _ = splade_pair
    want = ours.encode_sparse(TEXTS, k=k)
    for (gi, gv), (ri, rv), (wi, wv) in zip(*replies, want):
        assert 0 < len(gi) <= k and set(gi.tolist()) == set(ri.tolist())
        g = dict(zip(gi.tolist(), gv.tolist()))
        np.testing.assert_allclose([g[i] for i in ri.tolist()], rv, rtol=0, atol=ATOL_F32)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)


def test_sparse_frame_on_a_dense_model_errors_and_the_connection_stays(engine):
    want = engine.encode(TEXTS[:2])
    with serve_in_thread(engine) as port, socket.create_connection(
            ("127.0.0.1", port), 10) as s:
        _recv(s, 4)
        s.sendall(b"\x01TPW" + struct.pack("<I", 16) + _texts_body(["a"])
                  + b"TPE2" + _texts_body(TEXTS[:2]))
        assert struct.unpack("<I", _recv(s, 4))[0] == 0xFFFFFFFF
        assert b"no MLM head" in _error(s)
        np.testing.assert_allclose(_f32_reply(s), want, rtol=0, atol=1e-6)


# each unserved magic with a payload of its documented layout
_TEXTS = _texts_body(["a document", "another one"])
UNSERVED_FRAMES = {
    "index": b"\x01TPB" + _TEXTS,
    "search": b"\x01TPS" + struct.pack("<I", 3) + _TEXTS,
    "sparse_index": b"\x01TPY" + _TEXTS,
    "sparse_search": b"\x01TPZ" + struct.pack("<I", 3) + _TEXTS,
    "hybrid_index": b"\x01TPF" + _TEXTS,
    "hybrid_search": b"\x01TPG" + struct.pack("<I", 3) + _TEXTS,
    "maxsim_index": b"\x01TPJ" + _TEXTS,
    "maxsim_search": b"\x01TPK" + struct.pack("<I", 3) + _TEXTS,
}


def test_the_unserved_frames_are_the_index_search_and_hybrid_ones():
    from embedding_cpp_tpu_torch.runtime.server import UNSERVED

    assert sorted(UNSERVED) == sorted(f[:4] for f in UNSERVED_FRAMES.values())
    assert len(UNSERVED) == 8 and not {b"\x01TPW", b"\x01TPX"} & set(UNSERVED)


@pytest.mark.parametrize("frame", sorted(UNSERVED_FRAMES))
def test_unserved_frame_gets_an_error_and_the_connection_stays(engine, frame):
    from embedding_cpp_tpu_torch.runtime.server import UNSERVED, _MAGICS

    data = UNSERVED_FRAMES[frame]
    assert data[:4] in UNSERVED and data[:4] in _MAGICS
    want = engine.encode(TEXTS[:2])
    with serve_in_thread(engine) as port, socket.create_connection(
            ("127.0.0.1", port), 10) as s:
        _recv(s, 4)
        # the whole frame and a TPE2 frame behind it, in one send: the
        # server must read the first to its end to find the second
        s.sendall(data + b"TPE2" + _texts_body(TEXTS[:2]))
        assert struct.unpack("<I", _recv(s, 4))[0] == 0xFFFFFFFF
        assert _error(s).startswith(b"NotImplementedError: ")
        np.testing.assert_allclose(_f32_reply(s), want, rtol=0, atol=1e-6)


def test_unknown_control_frame_is_refused_not_embedded(engine):
    with serve_in_thread(engine) as port, socket.create_connection(
            ("127.0.0.1", port), 10) as s:
        _recv(s, 4)
        s.sendall(b"\x01ZZZ hello")
        assert struct.unpack("<I", _recv(s, 4))[0] == 0xFFFFFFFF
        assert b"unknown frame magic" in _error(s)
        assert s.recv(1) == b""  # the stream cannot be resynchronized: closed


def test_text_that_is_not_utf8_closes_the_connection(engine):
    """A text that does not decode fails the frame before its end: the
    stream cannot be read further, so the error frame comes and the
    connection closes."""
    with serve_in_thread(engine) as port, socket.create_connection(
            ("127.0.0.1", port), 10) as s:
        _recv(s, 4)
        s.sendall(b"TPE2" + struct.pack("<II", 2, 2) + b"\xff\xfe" + struct.pack("<I", 1) + b"a")
        assert struct.unpack("<I", _recv(s, 4))[0] == 0xFFFFFFFF
        assert b"not UTF-8" in _error(s)
        assert s.recv(1) == b""


def _eval_frame(id_lists) -> bytes:
    return b"\x01TPI" + struct.pack("<I", len(id_lists)) + b"".join(
        struct.pack("<I", len(ids)) + np.asarray(ids, np.int32).tobytes() for ids in id_lists)


@pytest.mark.parametrize("bad", ["n_vocab", "minus_one", "below_minus_n_vocab", "int32_max"])
def test_eval_frame_with_an_id_outside_the_vocab_gets_an_error(engine, bad):
    """An id outside 0..n_vocab-1 is refused with the error frame before
    anything launches (on the card an out-of-range gather would lose the
    process's CUDA context), and the connection stays usable."""
    n = engine.config.n_vocab
    wrong = {"n_vocab": n, "minus_one": -1, "below_minus_n_vocab": -n - 1,
             "int32_max": 2**31 - 1}[bad]
    want = engine.encode(TEXTS[:2])
    with serve_in_thread(engine) as port, socket.create_connection(
            ("127.0.0.1", port), 10) as s:
        _recv(s, 4)
        s.sendall(_eval_frame([[2, 5, 3], [2, wrong, 3]]) + b"TPE2" + _texts_body(TEXTS[:2]))
        assert struct.unpack("<I", _recv(s, 4))[0] == 0xFFFFFFFF
        assert _error(s) == f"ValueError: token id {wrong} outside 0..{n - 1}".encode()
        np.testing.assert_allclose(_f32_reply(s), want, rtol=0, atol=1e-6)
        s.sendall(_eval_frame([[2, 5, 3]]))  # a valid eval frame on the same socket
        np.testing.assert_allclose(_f32_reply(s), engine.embed_tokens([[2, 5, 3]]),
                                   rtol=0, atol=1e-6)
