"""The port's TCP server over a CPU engine on a free local port: the int32
n_embd handshake, a raw-mode text, and a TPE2 batch, each equal to
`engine.encode` (a synthetic MiniLM-shaped engine, a tiny-nomic GGUF and a
tiny CLS-pooled Q8_0 GGUF); the rerank frame over a DeBERTa cross-encoder,
equal to `engine.rerank`, and its error frames.  The reference's bert.h
frames (meta, health, tokenize, vocab, eval, int8 encode, stats) against
the reference's own server over one GGUF, the sparse (\x01TPW, on a
tiny-splade GGUF) and MaxSim (\x01TPX) frames against the reference's
server, and the index, search and hybrid frames against the reference's
server and against the direct index calls."""
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
    """The tiny-nomic preset in a Q4_0 GGUF (WordPiece vocab), written by
    the port's make_test_model."""
    from embedding_cpp_tpu_torch.cli.make_test_model import make_test_model

    path = str(tmp_path_factory.mktemp("gguf") / "tiny-nomic-q4_0.gguf")
    make_test_model(path, "tiny-nomic", "q4_0", seed=0)
    return Engine.from_gguf(path, device="cpu")


@pytest.fixture(scope="module")
def q8_engine(tmp_path_factory):
    """A tiny CLS-pooled BERT in a Q8_0 GGUF (bge-large's pooling and
    weight type at 64 wide), written by the port."""
    from embedding_cpp_tpu_torch.models.config import BertConfig
    from embedding_cpp_tpu_torch.models.convert import FTYPE_NAMES, write_bert_gguf
    from embedding_cpp_tpu_torch.models.params import random_state_dict
    from embedding_cpp_tpu_torch.tokenizer.testvocab import build_tokenizer_json

    config = BertConfig(n_vocab=1000, n_ctx=128, n_embd=64, n_layer=2, n_head=4, n_ff=256,
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


# the index frames, and the search frames with the index frame each needs
INDEX_DOCS = ["the quick brown fox jumps over the lazy dog", "hello world", "a",
              "hello world again", "Hello, World!  Ünïcödé 中文", "hello world",
              "partly cloudy skies over the town"]
QUERIES = ["hello world", "a lazy fox", "skies"]
SERVED_FRAMES = {  # frame -> (magic, the index magic its search needs, the pair)
    "index": (b"\x01TPB", None, "engine_pair"),
    "search": (b"\x01TPS", b"\x01TPB", "engine_pair"),
    "sparse_index": (b"\x01TPY", None, "splade_pair"),
    "sparse_search": (b"\x01TPZ", b"\x01TPY", "splade_pair"),
    "hybrid_index": (b"\x01TPF", None, "splade_pair"),
    "hybrid_search": (b"\x01TPG", b"\x01TPF", "splade_pair"),
    "maxsim_index": (b"\x01TPJ", None, "engine_pair"),
    "maxsim_search": (b"\x01TPK", b"\x01TPJ", "engine_pair"),
}


def _search_reply(s) -> tuple[np.ndarray, np.ndarray]:
    n, k = struct.unpack("<II", _recv(s, 8))
    assert n != 0xFFFFFFFF, _recv(s, k)
    ids = np.frombuffer(_recv(s, 4 * n * k), np.int32).reshape(n, k)
    return ids, np.frombuffer(_recv(s, 4 * n * k), np.float32).reshape(n, k)


def _u32(s) -> int:
    (v,) = struct.unpack("<I", _recv(s, 4))
    assert v != 0xFFFFFFFF, _error(s)
    return v


def test_every_frame_of_the_reference_is_served():
    """The port's server reads every magic the reference's server reads,
    and no other."""
    from embedding_cpp_tpu.runtime import server as reference
    from embedding_cpp_tpu_torch.runtime.server import _MAGICS

    theirs = {v for k, v in vars(reference).items() if k.startswith("MAGIC")}
    assert set(_MAGICS) == theirs and len(_MAGICS) == len(theirs) == 19
    assert {f[0] for f in SERVED_FRAMES.values()} <= set(_MAGICS)


@pytest.mark.parametrize("frame", sorted(SERVED_FRAMES))
def test_index_frame_matches_the_reference(request, frame):
    """Each index, search and hybrid frame answered as the reference's
    server answers it: an index frame's total (twice, and a TPE2 frame
    behind it in the same send, so the frame is read to its end); a search
    frame first the error frame (no index yet), then after its index frame
    `u32 n | u32 k | ids | scores` at k 3 and at k past the corpus (id -1,
    score -inf there), ids equal, scores at the f32 bar (RRF scores
    exactly)."""
    magic, index_magic, pair = SERVED_FRAMES[frame]
    pair = request.getfixturevalue(pair)
    with both_servers(pair) as socks:
        replies = []
        for s in socks:
            got = []
            if index_magic is None:
                s.sendall(magic + _texts_body(INDEX_DOCS) + b"TPE2" + _texts_body(TEXTS[:2]))
                got.append(_u32(s))
                got.append(_f32_reply(s).shape)
                s.sendall(magic + _texts_body(INDEX_DOCS[:3]))
                got.append(_u32(s))
            else:
                s.sendall(magic + struct.pack("<I", 3) + _texts_body(QUERIES))
                assert struct.unpack("<I", _recv(s, 4))[0] == 0xFFFFFFFF
                got.append(_error(s).split(b":")[0])
                s.sendall(index_magic + _texts_body(INDEX_DOCS))
                got.append(_u32(s))
                for k in (3, 10):
                    s.sendall(magic + struct.pack("<I", k) + _texts_body(QUERIES))
                    got.append(_search_reply(s))
            replies.append(got)
    ours, theirs = replies
    if index_magic is None:
        assert ours == theirs == [7, (2, 64), 10]
        return
    assert ours[:2] == theirs[:2] == [b"RuntimeError", 7]
    atol = 0.0 if magic == b"\x01TPG" else ATOL_F32
    for (ids, scores), (ids_ref, scores_ref), k in zip(ours[2:], theirs[2:], (3, 10)):
        assert ids.shape == (3, k)
        np.testing.assert_array_equal(ids, ids_ref)
        np.testing.assert_allclose(scores, scores_ref, rtol=0, atol=atol)
    ids, scores = ours[3]
    if magic == b"\x01TPG":  # RRF: -1 / 0.0 past the fused candidates
        assert np.all((ids >= 0) | (scores == 0.0))
    else:
        assert np.all(ids[:, 7:] == -1) and np.all(np.isneginf(scores[:, 7:]))
        assert np.all(ids[:, :7] >= 0) and np.all(np.diff(scores[:, :7], axis=1) <= 0)


def test_search_frames_equal_the_direct_index_calls(engine_pair, splade_pair):
    """\x01TPS / \x01TPK / \x01TPZ / \x01TPG replies equal VectorIndex,
    MaxSimIndex, SparseIndex and rrf_fuse called directly on the same
    documents."""
    from embedding_cpp_tpu_torch.runtime.maxsim_search import MaxSimIndex
    from embedding_cpp_tpu_torch.runtime.search import VectorIndex
    from embedding_cpp_tpu_torch.runtime.sparse_search import SparseIndex, rrf_fuse

    dense, splade = engine_pair[0], splade_pair[0]
    want = {}
    for magic, cls, eng in ((b"\x01TPS", VectorIndex, dense), (b"\x01TPK", MaxSimIndex, dense),
                            (b"\x01TPZ", SparseIndex, splade)):
        index = cls(eng)
        index.add(INDEX_DOCS)
        want[magic] = index.search(QUERIES, 4)
    d, sp = VectorIndex(splade), SparseIndex(splade)
    d.add(INDEX_DOCS)
    sp.add(INDEX_DOCS)
    want[b"\x01TPG"] = rrf_fuse([d.search(QUERIES, 4)[0], sp.search(QUERIES, 4)[0]], 4)
    for eng, index_magic, magic in ((dense, b"\x01TPB", b"\x01TPS"),
                                    (dense, b"\x01TPJ", b"\x01TPK"),
                                    (splade, b"\x01TPY", b"\x01TPZ"),
                                    (splade, b"\x01TPF", b"\x01TPG")):
        with serve_in_thread(eng) as port, socket.create_connection(("127.0.0.1", port), 30) as s:
            _recv(s, 4)
            s.sendall(index_magic + _texts_body(INDEX_DOCS))
            assert _u32(s) == len(INDEX_DOCS)
            s.sendall(magic + struct.pack("<I", 4) + _texts_body(QUERIES))
            ids, scores = _search_reply(s)
        np.testing.assert_array_equal(ids, want[magic][0])
        np.testing.assert_array_equal(scores, want[magic][1])


def test_hybrid_frames_refuse_a_desynced_corpus(splade_pair):
    """An index frame after a hybrid one leaves the dense index longer than
    the sparse one: \x01TPF and \x01TPG then refuse, as the reference's
    server does, and the connection stays usable."""
    with both_servers(splade_pair) as socks:
        for s in socks:
            s.sendall(b"\x01TPF" + _texts_body(INDEX_DOCS))
            assert _u32(s) == 7
            s.sendall(b"\x01TPB" + _texts_body(["one more"]))
            assert _u32(s) == 8
            for frame in (b"\x01TPF" + _texts_body(["x"]),
                          b"\x01TPG" + struct.pack("<I", 2) + _texts_body(["hello"])):
                s.sendall(frame)
                assert struct.unpack("<I", _recv(s, 4))[0] == 0xFFFFFFFF
                assert b"hybrid corpus desync" in _error(s)
            s.sendall(b"\x01TPZ" + struct.pack("<I", 2) + _texts_body(["hello world"]))
            ids, _ = _search_reply(s)
            assert ids[0, 0] in (1, 5)


def test_hybrid_index_fails_first_on_a_model_without_mlm_head(engine_pair):
    """On a dense model the hybrid index frame fails before either index
    changes: the dense index is not built, and a plain index frame after
    it counts from 0."""
    with both_servers(engine_pair) as socks:
        for s in socks:
            s.sendall(b"\x01TPF" + _texts_body(INDEX_DOCS))
            assert struct.unpack("<I", _recv(s, 4))[0] == 0xFFFFFFFF
            assert b"no MLM head" in _error(s)
            s.sendall(b"\x01TPS" + struct.pack("<I", 2) + _texts_body(["hello"]))
            assert struct.unpack("<I", _recv(s, 4))[0] == 0xFFFFFFFF
            assert b"no index built" in _error(s)
            s.sendall(b"\x01TPB" + _texts_body(INDEX_DOCS[:2]))
            assert _u32(s) == 2


def test_concurrent_hybrid_adds_keep_both_indexes_aligned(splade_pair):
    """More threads than cores run hybrid index adds at once (a short switch
    interval): both indexes end with every document once, and the dense row
    at each id belongs to the text whose sparse vector sits at that id."""
    import concurrent.futures
    import os
    import sys

    from embedding_cpp_tpu_torch.runtime.server import ContinuousBatcher

    ours, _ = splade_pair
    workers = (os.cpu_count() or 4) + 4
    texts = [f"document number {i} about topic {i % 5}" for i in range(2 * workers)]
    b = ContinuousBatcher(ours)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
            futures = [ex.submit(b.hybrid_index_texts, [t]) for t in texts]
            totals = sorted(f.result(timeout=120) for f in futures)
    finally:
        sys.setswitchinterval(prev)
    assert totals == list(range(1, len(texts) + 1))
    assert len(b.index) == len(b.sparse_index) == len(texts)
    sparse = [tuple(i.tolist()) for i, _ in ours.encode_sparse(texts, k=256)]
    dense = ours.encode_documents(texts)
    rows = b.index._rows.gather(len(texts), "vectors").float().numpy()
    for doc_id, stored in enumerate(b.sparse_index._indices):
        text = sparse.index(tuple(stored.tolist()))
        assert int(np.argmax(dense @ rows[doc_id])) == text


def test_hybrid_add_leaves_both_indexes_unchanged_when_the_encode_fails(splade_pair):
    """The sparse encode runs before either append: when it raises, the
    dense and the sparse index keep their documents."""
    from embedding_cpp_tpu_torch.runtime.server import ContinuousBatcher

    ours, _ = splade_pair
    b = ContinuousBatcher(ours)
    assert b.hybrid_index_texts(INDEX_DOCS[:3]) == 3
    boom = RuntimeError("encode failed")

    def failing(*a, **kw):
        raise boom

    b.sparse_index.engine = type("E", (), {"encode_sparse": staticmethod(failing)})()
    with pytest.raises(RuntimeError, match="encode failed"):
        b.hybrid_index_texts(INDEX_DOCS[3:])
    assert len(b.index) == len(b.sparse_index) == 3


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
