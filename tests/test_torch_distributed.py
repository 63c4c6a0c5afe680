"""The port's multi-process runtime (`parallel/distributed.py`) on the CPU:
two OS processes joined over gloo (`torch.distributed`), each with 4 mesh
slots (2 dp rows x 2 tp slots, so every tp pair is in one process and the
mesh is dp 4 x tp 2), the layout of the JAX package's
tests/test_distributed.py.

- The worker (tests/torch_distributed_worker.py, run once for the module):
  the identical-inputs forward and the per-process stream equal the JAX
  package's single-device forward and the port's (2e-5); `fetch_local`
  gives each process its rows in dp order; `log_once` after a `barrier`
  prints from process 0 alone; the Engine, the VectorIndex
  (with save / load and the leader's OP_SAVE) and the SparseIndex under the
  leader-follower plane give the single-process results.
- The token-list codec is the JAX package's byte for byte; the CLI flags
  and their refusal are the JAX package's.
- Each process's share of the cards (`card_share`), the data plane's
  backend, and the serving mesh of `server --tp` on 2 processes of a
  4-card host: each process on its own two cards (card handles only; no
  card is touched).
- The server with `--coordinator` (2 processes, 2 tp slots each) answers a
  TPE2 frame and an HTTP `/v1/embeddings` request with the bytes of a
  single-process server over the same mesh shape (f32 output), and within
  2e-5 of one device, and its vector index (built and searched over TCP:
  the leader broadcasts every commit and search) the same ids and scores;
  SIGTERM to the leader releases the follower, which exits 0.

The worker run takes ~6 s and the servers ~15 s here.
"""
import argparse
import http.client
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from embedding_cpp_tpu.gguf import GGUFFileType
from embedding_cpp_tpu.models.bert import ComputeOptions as JOpts
from embedding_cpp_tpu.models.bert import bert_embed_batch as jax_embed_batch
from embedding_cpp_tpu.models.config import BertConfig as JConfig
from embedding_cpp_tpu.models.params import random_params as jax_random_params
from embedding_cpp_tpu.parallel import distributed as jdist
from embedding_cpp_tpu_torch.models import BertConfig, ComputeOptions
from embedding_cpp_tpu_torch.parallel import distributed as dist
from embedding_cpp_tpu_torch.runtime.engine import Engine
from embedding_cpp_tpu_torch.runtime.search import VectorIndex
from embedding_cpp_tpu_torch.runtime.sparse_search import SparseIndex

ROOT = Path(__file__).resolve().parents[1]
ATOL, RTOL = 2e-5, 1e-4
CFG = BertConfig(n_vocab=256, n_ctx=64, n_embd=128, n_layer=2, n_head=4, n_ff=256,
                 name="dist-test", mlm_head=True)
OPTS = ComputeOptions(dtype="float32")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def worker_outputs(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("torch-dist")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_distributed_worker.py"),
                               str(pid), "2", str(port), str(outdir)],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for pid in (0, 1)]
    try:
        logs = []
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
            assert "data plane gloo" in out
            logs.append(out)
        # log_once: process 0 alone prints
        assert [o.count("every raw forward written") for o in logs] == [1, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outdir


@pytest.fixture(scope="module")
def single():
    return Engine.synthetic(CFG, "q4_0", opts=OPTS, device="cpu")


def _reference():
    jcfg = JConfig(n_vocab=256, n_ctx=64, n_embd=128, n_layer=2, n_head=4, n_ff=256,
                   name="dist-test")
    params = jax_random_params(jcfg, GGUFFileType.MOSTLY_Q4_0, seed=0)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, size=(8, 16)).astype(np.int32)
    mask = np.ones((8, 16), np.int32)
    mask[:, 12:] = 0
    return np.asarray(jax_embed_batch(params, ids, mask, jcfg, JOpts(dtype="float32")))


TOKEN_LISTS = [[2] + row.tolist() + [3]
               for row in np.random.default_rng(1).integers(4, 256, size=(12, 9))]


def test_identical_inputs_and_per_process_streams(worker_outputs):
    ref = _reference()
    np.testing.assert_allclose(np.load(worker_outputs / "out_bcast.npy"), ref, atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(np.load(worker_outputs / "out_stream.npy"), ref, atol=ATOL,
                               rtol=RTOL)


def test_fetch_local_gives_each_process_its_rows(worker_outputs):
    local0, local1 = (np.load(worker_outputs / f"local_rows_{p}.npy") for p in (0, 1))
    assert local0.shape[0] == local1.shape[0] == 4
    np.testing.assert_allclose(np.concatenate([local0, local1]), _reference(), atol=ATOL,
                               rtol=RTOL)


def test_engine_and_indexes_under_the_leader_follower_plane(worker_outputs, single):
    np.testing.assert_allclose(np.load(worker_outputs / "engine_out.npy"),
                               single.embed_tokens(TOKEN_LISTS), atol=ATOL, rtol=RTOL)
    vecs = np.random.default_rng(7).standard_normal((37, 128)).astype(np.float32)
    one = VectorIndex(single)
    one.add_vectors(vecs)
    i, s = one.search_vectors(vecs[:5], k=3)
    rt = np.load(worker_outputs / "index_roundtrip.npz")
    lead = np.load(worker_outputs / "leader_index_results.npz")
    for got_i, got_s in ((rt["i1"], rt["s1"]), (rt["i2"], rt["s2"]), (lead["li"], lead["ls"])):
        assert np.array_equal(got_i, i)
        np.testing.assert_allclose(got_s, s, atol=1e-6)
    assert np.array_equal(i[:, 0], np.arange(5))
    for name in ("dist_index_0", "dist_index_1", "leader_index"):
        with np.load(worker_outputs / f"{name}.npz") as f:
            np.testing.assert_allclose(f["vectors"], one._snapshot_rows(), atol=0)
    pairs = single.sparse_tokens(TOKEN_LISTS, k=16)
    sp = np.load(worker_outputs / "sparse_leader_results.npz")
    for j, (ids, w) in enumerate(pairs):
        assert set(sp[f"pair_i{j}"].tolist()) == set(ids.tolist())
        np.testing.assert_allclose(np.sort(sp[f"pair_v{j}"]), np.sort(w), atol=1e-5)
    idx = SparseIndex(single)
    idx.add_vectors([(sp[f"pair_i{j}"], sp[f"pair_v{j}"]) for j in range(len(pairs))])
    ri, rs = idx.search_vectors([(sp[f"pair_i{j}"], sp[f"pair_v{j}"]) for j in range(3)], k=4)
    assert np.array_equal(sp["si"], ri)
    np.testing.assert_allclose(sp["ss"], rs, atol=1e-6)


@pytest.mark.parametrize("lists", [[[1, 2, 3], [], [7]], [[5] * 100], [[]], []])
def test_token_list_codec_is_the_jax_one(lists):
    ours = dist._encode_token_lists(lists)
    ref = jdist._encode_token_lists(lists)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    assert ours.tobytes() == ref.tobytes()
    assert dist._decode_token_lists(ours) == jdist._decode_token_lists(ref) == lists


def test_cli_flags_are_the_jax_ones():
    def parse(mod, argv):
        p = argparse.ArgumentParser()
        mod.add_args(p)
        return vars(p.parse_args(argv))

    argv = ["--coordinator", "h:1", "--num-processes", "3", "--process-id", "2"]
    assert parse(dist, argv) == parse(jdist, argv)
    assert parse(dist, []) == parse(jdist, [])
    assert dist.OP_STOP == jdist.OP_STOP and dist.OP_SPARSE_SEARCH == jdist.OP_SPARSE_SEARCH
    assert dist._HEADER_SHAPE == jdist._HEADER_SHAPE
    bad = argparse.Namespace(coordinator=None, num_processes=2, process_id=0)
    with pytest.raises(SystemExit, match="--num-processes > 1 requires --coordinator"):
        dist.init_from_args(bad)
    assert not dist.init_from_args(argparse.Namespace(coordinator=None, num_processes=1))
    assert (dist.process_count(), dist.process_index(), dist.backend()) == (1, 0, None)


# --- each process's share of the cards ---------------------------------------------
CARDS = ["GPU-a", "GPU-b", "GPU-c", "GPU-d"]


def test_card_share_gives_each_process_its_own_cards():
    """Every process sees the same 4 cards: each takes its half, in
    process order; one card each (its own CUDA_VISIBLE_DEVICES): each takes
    its own; cards seen by some processes only, or too few to share, raise."""
    assert [dist.card_share([CARDS] * 2, r) for r in (0, 1)] == [[0, 1], [2, 3]]
    assert [dist.card_share([CARDS] * 4, r) for r in range(4)] == [[0], [1], [2], [3]]
    assert [dist.card_share([[c] for c in CARDS], r) for r in range(4)] == [[0]] * 4
    assert dist.card_share([CARDS[:2], CARDS[2:]], 1) == [0, 1]
    with pytest.raises(ValueError, match="overlapping but different cards"):
        dist.card_share([CARDS[:3], CARDS[2:]], 0)
    with pytest.raises(ValueError, match="cannot be shared by 2 processes"):
        dist.card_share([CARDS[:1]] * 2, 0)


@pytest.mark.parametrize("seen, backend", [
    ([CARDS[:2], CARDS[2:]], "nccl"),
    ([CARDS[:1], CARDS[:1]], "gloo"),
    ([CARDS[:2], None], "gloo"),
])
def test_backend_is_nccl_only_where_no_card_is_shared(monkeypatch, seen, backend):
    monkeypatch.setattr(dist, "_all_gather", lambda obj: seen)
    assert dist.choose_backend(["cpu"]) == backend


def test_a_two_process_serving_mesh_puts_each_process_on_its_own_cards(monkeypatch):
    """`server --tp 2` on a host of 4 cards in 2 processes: each process's
    mesh slots are its own two cards (dp 2 over the processes)."""
    import torch

    from embedding_cpp_tpu_torch.runtime import server

    visible = [torch.device("cuda", i) for i in range(4)]
    slots = []
    for rank in (0, 1):
        share = [visible[i] for i in dist.card_share([CARDS] * 2, rank)]
        world = dist._World(rank, 2, None, None, share)
        monkeypatch.setattr(dist, "_WORLD", world)
        assert dist.local_devices() == share
        args = argparse.Namespace(dp=0, tp=2, device=None)
        mesh = server._mesh_from_args(argparse.ArgumentParser(), args)
        assert mesh.shape == {"dp": 2, "tp": 2} and mesh.dp_offset == rank
        slots.append([str(d) for d in mesh.devices.flat])
    assert slots == [["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]]


# --- the server with --coordinator --------------------------------------------------
TEXTS = ["hello world", "the quick brown fox", "distributed serving", "a"]


def _start(model: str, extra: list[str], pid: int | None = None) -> tuple:
    port, http_port = _free_port(), _free_port()
    cmd = [sys.executable, "-m", "embedding_cpp_tpu_torch.runtime.server", "-m", model,
           "--host", "127.0.0.1", "--port", str(port), "--http-port", str(http_port),
           "--device", "cpu", "--dtype", "float32", "--output-dtype", "float32", *extra]
    return port, http_port, cmd


def _wait(port: int, procs: list) -> None:
    deadline = time.time() + 120
    while time.time() < deadline:
        for p in procs:
            if p.poll() is not None:
                pytest.fail(f"server process died:\n{p.communicate()[0][-4000:]}")
        try:
            socket.create_connection(("127.0.0.1", port), 0.5).close()
            return
        except OSError:
            time.sleep(0.2)
    pytest.fail("server never came up")


def _recv(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "connection closed"
        buf += chunk
    return buf


def _tpe2(port: int) -> bytes:
    body = b"".join(struct.pack("<I", len(t.encode())) + t.encode() for t in TEXTS)
    with socket.create_connection(("127.0.0.1", port), 30) as s:
        (n_embd,) = struct.unpack("<i", _recv(s, 4))
        s.sendall(b"TPE2" + struct.pack("<I", len(TEXTS)) + body)
        head = _recv(s, 4)
        return head + _recv(s, struct.unpack("<I", head)[0] * n_embd * 4)


def _http(port: int) -> list:
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    c.request("POST", "/v1/embeddings", json.dumps({"input": TEXTS}),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    assert r.status == 200
    return [d["embedding"] for d in json.loads(r.read())["data"]]


def _stop(procs: list) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        if not p.stdout.closed:
            p.communicate(timeout=30)


def test_server_with_coordinator_answers_as_one_process(tmp_path):
    from embedding_cpp_tpu_torch.cli.make_test_model import make_test_model

    model = str(tmp_path / "tiny.gguf")
    make_test_model(model, "tiny", "q4_0", seed=0)
    coord = _free_port()
    port, http_port, cmd = _start(model, ["--tp", "2", "--coordinator", f"127.0.0.1:{coord}",
                                          "--num-processes", "2"])
    procs = [subprocess.Popen(cmd + ["--process-id", str(pid)], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    sport, shttp, scmd = _start(model, ["--dp", "2", "--tp", "2"])
    solo = subprocess.Popen(scmd, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        _wait(port, procs)
        _wait(sport, [solo])
        got, want = _tpe2(port), _tpe2(sport)
        assert got == want
        vecs = np.frombuffer(got[4:], np.float32).reshape(len(TEXTS), -1)
        one = Engine.from_gguf(model, device="cpu", opts=OPTS)
        np.testing.assert_allclose(vecs, one.encode(TEXTS), atol=ATOL, rtol=RTOL)
        assert _http(http_port) == _http(shttp)
        # the leader's index: its commits and searches replayed by the follower
        corpus = [f"distributed document {i}" for i in range(10)]
        from embedding_cpp_tpu_torch.runtime.client import EmbeddingClient

        with EmbeddingClient("127.0.0.1", port) as c, EmbeddingClient("127.0.0.1", sport) as sc:
            assert c.index(corpus) == sc.index(corpus) == 10
            got_i, got_s = c.search([corpus[4], corpus[8]], k=3)
            want_i, want_s = sc.search([corpus[4], corpus[8]], k=3)
        assert np.array_equal(got_i, want_i) and list(got_i[:, 0]) == [4, 8]
        assert np.array_equal(got_s, want_s)
        procs[0].send_signal(signal.SIGTERM)
        assert procs[0].wait(timeout=60) == 0
        assert procs[1].wait(timeout=60) == 0, "the follower was not released"
        logs = [p.communicate()[0] for p in procs]
        assert "data plane gloo" in logs[0] and "follower process 1 of 2 ready" in logs[1]
    finally:
        _stop(procs + [solo])

