"""Serving throughput benchmark: concurrent clients against the server.

The port's copy of the JAX package's `benchmarks/serving.py`.  The
reference serves ONE client at a time (`listen(fd, 1)`,
examples/server.cpp:92) and evaluates one sentence per request; here N
concurrent connections feed the continuous batcher, which merges their
requests into shared device batches.  This measures end-to-end served
sentences/s (tokenize + embed + framing) over the framed TCP protocol
(`--wire f32|int8`) or `POST /v1/embeddings` (`--protocol http`).  The
server (`runtime.server.serve`) runs in this process on its own event-loop
thread and stops when the run ends.  Every run also holds one request's
replies against `Engine.encode` of the same texts (`min_cosine_vs_encode`).

`--device` picks where the engine runs (the GPU by default; `cpu` runs the
kernels' plain PyTorch versions); with `--dp` / `--tp` the engine runs on a
mesh (`parallel.mesh.make_mesh`) of the visible cards, or, with
`--device`, of dp x tp slots on that one device, which run in turn.

    python -m embedding_cpp_tpu_torch.benchmarks.serving [--clients 4] [--batch 64] \\
        [--sentences 2048] [--device cpu]
"""
from __future__ import annotations

import argparse
import asyncio
import base64
import contextlib
import http.client
import json
import socket
import sys
import threading
import time
from pathlib import Path

import numpy as np


def free_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


@contextlib.contextmanager
def serving(engine, **serve_kw):
    """`runtime.server.serve` over `engine` on a free local port (with
    `serve`'s keywords: `http_port`, more models), on its own event-loop
    thread; yields the TCP port once every port accepts, and stops the
    server on exit."""
    from ..runtime.server import serve

    port = free_port()
    loop = asyncio.new_event_loop()
    holder = {}

    def run():
        asyncio.set_event_loop(loop)
        holder["task"] = loop.create_task(serve(engine, "127.0.0.1", port, **serve_kw))
        try:
            loop.run_until_complete(holder["task"])
        except asyncio.CancelledError:
            pass
        finally:
            loop.close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        for p in (port, serve_kw.get("http_port") or port):
            for _ in range(200):
                try:
                    socket.create_connection(("127.0.0.1", p), 1.0).close()
                    break
                except OSError:
                    time.sleep(0.05)
            else:
                raise RuntimeError("server did not start")
        yield port
    finally:
        loop.call_soon_threadsafe(holder["task"].cancel)
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("server thread did not stop")


def embed_http(conn, texts, encoding: str) -> np.ndarray:
    """POST /v1/embeddings on a kept-alive connection -> [n, n_embd] f32."""
    conn.request("POST", "/v1/embeddings",
                 json.dumps({"input": list(texts), "encoding_format": encoding}),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    body = json.loads(r.read())
    if r.status != 200:
        raise RuntimeError(f"HTTP {r.status}: {body}")
    if encoding == "base64":
        return np.stack([np.frombuffer(base64.b64decode(d["embedding"]), np.float32)
                         for d in body["data"]])
    return np.asarray([d["embedding"] for d in body["data"]], np.float32)


def _min_cosine(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.min(np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1)
                                                  * np.linalg.norm(want, axis=-1))))


def _mesh(args, device):
    from ..parallel.mesh import make_mesh

    if not (args.dp or args.tp > 1):
        return None
    if args.device is not None:  # dp x tp slots on the one device
        n = (args.dp or 1) * args.tp
        return make_mesh(dp=args.dp or 1, tp=args.tp, devices=[device] * n)
    return make_mesh(dp=args.dp or None, tp=args.tp)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--batch", type=int, default=64, help="sentences per client request")
    p.add_argument("--sentences", type=int, default=2048, help="sentences per client")
    p.add_argument("--preset", default="minilm-l6")
    p.add_argument("--ftype", default="q4_0")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--output-dtype", default="float32",
                   choices=["float32", "float16", "bfloat16", "int8"],
                   help="engine device->host transfer dtype (the wire stays "
                        "f32 unless --wire int8)")
    p.add_argument("--dp", type=int, default=0,
                   help="serve from a dp(xtp) mesh (0 = single device)")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--wire", choices=["f32", "int8"], default="f32",
                   help="client-side reply compression (tcp protocol)")
    p.add_argument("--protocol", choices=["tcp", "http"], default="tcp",
                   help="drive the framed TCP protocol or the HTTP/JSON "
                        "endpoint (POST /v1/embeddings)")
    p.add_argument("--http-encoding", choices=["float", "base64"], default="float",
                   help="HTTP reply encoding (base64 skips JSON float "
                        "formatting — much cheaper for large batches)")
    p.add_argument("--json-out", help="also write the JSON result to a file")
    p.add_argument("--overhead-ab", action="store_true",
                   help="same-run serving-tax A/B: alternate direct "
                        "Engine.encode vs through-server rounds on one "
                        "workload; reports the ratio")
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the plain PyTorch "
                        "versions of the kernels)")
    args = p.parse_args(argv)

    from ..cli.make_test_model import PRESETS
    from ..models.bert import ComputeOptions
    from ..runtime.client import EmbeddingClient
    from ..runtime.engine import Engine, resolve_device
    from ..utils.profiling import device_block
    from .bench import synthetic_sentences

    device = resolve_device(args.device)
    mesh = _mesh(args, device)
    engine = Engine.synthetic(
        PRESETS[args.preset], ftype=args.ftype, device=device, mesh=mesh,
        opts=ComputeOptions(dtype=args.dtype, output_dtype=args.output_dtype),
    )
    texts = synthetic_sentences(args.sentences)
    chunks = [texts[i: i + args.batch] for i in range(0, len(texts), args.batch)]
    http_port = free_port() if args.protocol == "http" else None
    # the replies of one request against the engine's own call: int8 codes
    # (the wire's or the engine's) are one step in 127 of a row's largest value
    want = engine.encode(chunks[0])
    common = {"clients": args.clients, "batch": args.batch,
              "sentences_per_client": args.sentences, "wire": args.wire,
              "protocol": args.protocol, "platform": engine.device.type,
              "device": device_block(engine.device)}

    with serving(engine, http_port=http_port) as port:
        if args.overhead_ab:
            # warm both paths on the exact shapes, then interleave A/B rounds
            # within this one run so host-clock drift hits both sides
            warm = EmbeddingClient("127.0.0.1", port)
            cos = _min_cosine(warm.embed(chunks[0], wire=args.wire), want)

            def run_direct() -> float:
                t0 = time.perf_counter()
                for c in chunks:
                    engine.encode(c)
                return len(texts) / (time.perf_counter() - t0)

            def run_server_path() -> float:
                t0 = time.perf_counter()
                for c in chunks:
                    warm.embed(c, wire=args.wire)
                return len(texts) / (time.perf_counter() - t0)

            run_direct()
            run_server_path()
            direct, served = [], []
            for _ in range(args.rounds):
                direct.append(run_direct())
                served.append(run_server_path())
            warm.close()
            d, s = float(np.median(direct)), float(np.median(served))
            result = {
                "metric": f"serving_tax_{args.preset}_{args.ftype}_b{args.batch}",
                "direct_sentences_per_sec": round(d, 1),
                "served_sentences_per_sec": round(s, 1),
                "tax_pct": round(100.0 * (1.0 - s / d), 1),
                "rounds": args.rounds,
                "direct_all": [round(x, 1) for x in direct],
                "served_all": [round(x, 1) for x in served],
                "min_cosine_vs_encode": cos, **common,
            }
        else:
            if args.protocol == "http":
                def connect():
                    return http.client.HTTPConnection("127.0.0.1", http_port, timeout=600)

                def embed(conn, chunk):
                    return embed_http(conn, chunk, args.http_encoding)
            else:
                def connect():
                    return EmbeddingClient("127.0.0.1", port)

                def embed(conn, chunk):
                    return conn.embed(chunk, wire=args.wire)

            # warmup: the shapes this traffic will hit (the kernels build at
            # first use), and the replies against the engine's call
            warm = connect()
            cos = _min_cosine(embed(warm, chunks[0]), want)
            for c in chunks:
                embed(warm, c)
            warm.close()

            done, errors = [], []

            def client_main():
                try:
                    conn = connect()
                    n = sum(len(embed(conn, c)) for c in chunks)
                    conn.close()
                    done.append(n)
                except Exception as e:  # re-raised below, on the main thread
                    errors.append(e)

            t0 = time.perf_counter()
            threads = [threading.Thread(target=client_main) for _ in range(args.clients)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            dt = time.perf_counter() - t0
            if errors:
                raise errors[0]
            total = int(np.sum(done))
            print(f"# {args.clients} clients x {args.sentences} sentences "
                  f"(batch {args.batch}): {total} served in {dt:.2f}s", file=sys.stderr)
            mesh_tag = f"_dp{mesh.dp}_tp{mesh.tp}" if mesh is not None else ""
            if args.protocol == "http":
                mesh_tag += "_http"
                if args.http_encoding != "float":
                    mesh_tag += f"_{args.http_encoding}"
            od_tag = "" if args.output_dtype == "float32" else f"_{args.output_dtype}"
            result = {
                "metric": f"served_sentences_per_sec_{args.preset}_{args.ftype}"
                          f"{mesh_tag}{od_tag}",
                "value": round(total / dt, 1),
                "unit": "sentences/s",
                "served": total,
                "seconds": dt,
                "min_cosine_vs_encode": cos, **common,
            }
    print(json.dumps(result))
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
