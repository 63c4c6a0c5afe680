"""Embedding TCP server over the port's Engine.

The encode and rerank surfaces of the JAX package's `runtime/server.py`,
on one port:

1. **ggml-compat raw mode**: on connect the server sends `n_embd` as a
   little-endian int32; each client message is raw UTF-8 text (one read,
   at most 32 KiB, is one message) and each reply is `n_embd` raw f32.
2. **TPE2 framed**: a message starting with b"TPE2" is
   `magic | u32 count | count * (u32 len | utf8 bytes)`; the reply is
   `u32 count | count * n_embd * f32`, or on failure
   `u32 0xFFFFFFFF | u32 len | message`.
3. **rerank** (a model with a classification head): b"\x01TPR" |
   `u32 top_n (0 = all) | u32 len | query utf8 | u32 n | n * (u32 len |
   utf8 doc)`; the reply is `u32 m | m * i32 index | m * f32 sigmoid score`,
   descending, or the error frame.

Encode requests from all connections merge into device batches through
one continuous batcher (a short micro-batching window); rerank requests
run `Engine.rerank` on an executor thread under the same pending budget.
"""
from __future__ import annotations

import argparse
import asyncio
import struct
import sys

import numpy as np

MAGIC = b"TPE2"
MAGIC_RERANK = b"\x01TPR"
_MAGICS = (MAGIC, MAGIC_RERANK)
RAW_CHUNK = 1 << 15  # the ggml-compat message cap
MAX_ITEMS = 1 << 16  # texts per request
MAX_TEXT_BYTES = 16 << 20  # per text
MAX_REQUEST_BYTES = 64 << 20  # aggregate text payload per request


class ProtocolError(Exception):
    pass


class OverloadedError(RuntimeError):
    """Backpressure: the batcher's pending-sentence budget is exhausted."""


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ProtocolError(f"malformed frame: {what}")


class ContinuousBatcher:
    """Merge pending encode requests across connections into device batches."""

    def __init__(self, engine, max_batch: int = 256, window_ms: float = 2.0,
                 max_pending: int = 16384):
        self.engine = engine
        self.max_batch = max_batch
        self.window = window_ms / 1000.0
        self.max_pending = max_pending
        self._pending = 0
        self.queue: asyncio.Queue = asyncio.Queue()
        self._task: asyncio.Task | None = None

    async def start(self) -> None:
        self._task = asyncio.create_task(self._run())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    def try_reserve(self, n: int) -> None:
        """Admission control: reserve `n` sentences against the pending
        budget (encode requests and reranks on executor threads alike), or
        raise OverloadedError.  Call from the event loop only, and
        `release` in a finally."""
        if n > self.max_pending:
            raise OverloadedError(
                f"request too large: {n} sentences exceed the pending cap "
                f"{self.max_pending}; split the request"
            )
        if self._pending + n > self.max_pending:
            raise OverloadedError(
                f"server overloaded: {self._pending} sentences pending "
                f"(cap {self.max_pending})"
            )
        self._pending += n

    def release(self, n: int) -> None:
        self._pending -= n

    async def encode(self, texts: list[str]) -> np.ndarray:
        n = len(texts)
        self.try_reserve(n)
        try:
            fut = asyncio.get_running_loop().create_future()
            await self.queue.put((texts, fut))
            return await fut
        finally:
            self.release(n)

    async def rerank(self, query: str, docs: list[str], top_n: int | None) -> list[dict]:
        """`Engine.rerank` on an executor thread, admitted against the
        pending budget."""
        self.try_reserve(len(docs))
        try:
            return await asyncio.get_running_loop().run_in_executor(
                None, lambda: self.engine.rerank(query, docs, top_n=top_n))
        finally:
            self.release(len(docs))

    async def _run(self) -> None:
        # pipeline depth 2: batch N+1 is planned while batch N computes
        sem = asyncio.Semaphore(2)
        inflight: set[asyncio.Task] = set()
        loop = asyncio.get_running_loop()
        try:
            while True:
                texts, fut = await self.queue.get()
                jobs = [(texts, fut)]
                total = len(texts)
                deadline = loop.time() + self.window
                while total < self.max_batch:
                    timeout = deadline - loop.time()
                    if timeout <= 0:
                        break
                    try:
                        t, f = await asyncio.wait_for(self.queue.get(), timeout)
                    except asyncio.TimeoutError:
                        break
                    jobs.append((t, f))
                    total += len(t)
                await sem.acquire()
                task = asyncio.create_task(self._run_batch(jobs, sem))
                inflight.add(task)
                task.add_done_callback(inflight.discard)
        finally:
            for task in inflight:
                task.cancel()

    async def _run_batch(self, jobs, sem: asyncio.Semaphore) -> None:
        flat = [text for texts, _ in jobs for text in texts]
        try:
            vecs = await asyncio.get_running_loop().run_in_executor(
                None, self.engine.encode, flat
            )
            off = 0
            for texts, fut in jobs:
                if not fut.cancelled():
                    fut.set_result(vecs[off : off + len(texts)])
                off += len(texts)
        except Exception as e:  # every waiter of the batch gets the error
            for _, fut in jobs:
                if not fut.cancelled():
                    fut.set_exception(e)
        finally:
            sem.release()


async def _read_head(reader: asyncio.StreamReader) -> bytes:
    """Accumulate the 4-byte frame head across TCP segments while the bytes
    so far can still start a magic; return early when they cannot (raw
    mode is then served without waiting for a 4th byte)."""
    head = b""
    while len(head) < 4:
        chunk = await reader.read(4 - len(head))
        if not chunk:
            return head
        head += chunk
        if not any(m.startswith(head) for m in _MAGICS):
            return head
    return head


async def _read_texts(reader: asyncio.StreamReader) -> list[str]:
    (count,) = struct.unpack("<I", await reader.readexactly(4))
    _check(count <= MAX_ITEMS, f"count {count}")
    texts, total = [], 0
    for _ in range(count):
        (ln,) = struct.unpack("<I", await reader.readexactly(4))
        _check(ln <= MAX_TEXT_BYTES, f"text length {ln}")
        total += ln
        _check(total <= MAX_REQUEST_BYTES, f"request payload {total}")
        texts.append((await reader.readexactly(ln)).decode("utf-8"))
    return texts


def _error_frame(writer: asyncio.StreamWriter, e: Exception) -> None:
    msg = f"{type(e).__name__}: {e}".encode("utf-8")[:4096]
    writer.write(struct.pack("<I", 0xFFFFFFFF) + struct.pack("<I", len(msg)) + msg)


async def handle_client(reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                        batcher: ContinuousBatcher, n_embd: int) -> None:
    try:
        writer.write(struct.pack("<i", n_embd))  # handshake
        await writer.drain()
        while True:
            head = await _read_head(reader)
            if not head:
                break
            if head == MAGIC:
                texts = await _read_texts(reader)
                try:
                    vecs = await batcher.encode(texts)
                except Exception as e:  # request-level failure, connection stays
                    _error_frame(writer, e)
                else:
                    writer.write(struct.pack("<I", len(vecs)))
                    writer.write(np.ascontiguousarray(vecs, np.float32).tobytes())
            elif head == MAGIC_RERANK:
                (top_n,) = struct.unpack("<I", await reader.readexactly(4))
                _check(top_n <= MAX_ITEMS, f"top_n {top_n}")
                (qlen,) = struct.unpack("<I", await reader.readexactly(4))
                _check(0 < qlen <= MAX_TEXT_BYTES, f"query length {qlen}")
                query = (await reader.readexactly(qlen)).decode("utf-8")
                docs = await _read_texts(reader)
                try:
                    if not docs:
                        raise ValueError("no documents")
                    ranked = await batcher.rerank(query, docs, top_n or None)
                except Exception as e:  # request-level failure, connection stays
                    _error_frame(writer, e)
                else:
                    writer.write(struct.pack("<I", len(ranked)))
                    writer.write(np.asarray([r["index"] for r in ranked], np.int32).tobytes())
                    writer.write(np.asarray([r["relevance_score"] for r in ranked],
                                            np.float32).tobytes())
            else:
                # raw mode: one read == one message; the unframed protocol has
                # no error representation, so a failure drops the connection
                rest = await reader.read(RAW_CHUNK - len(head))
                text = (head + rest).decode("utf-8", errors="replace")
                try:
                    vecs = await batcher.encode([text])
                except Exception as e:
                    print(f"raw-mode request failed: {e!r}", file=sys.stderr)
                    break
                writer.write(np.ascontiguousarray(vecs[0], np.float32).tobytes())
            await writer.drain()
    except ProtocolError as e:
        # the stream is desynchronized: report once, then drop the connection
        _error_frame(writer, e)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        pass
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except ConnectionError:
            pass


async def serve(engine, host: str = "0.0.0.0", port: int = 8080,
                max_batch: int = 256, window_ms: float = 2.0,
                max_pending: int = 16384) -> None:
    batcher = ContinuousBatcher(engine, max_batch, window_ms, max_pending=max_pending)
    await batcher.start()
    server = await asyncio.start_server(
        lambda r, w: handle_client(r, w, batcher, engine.n_embd), host, port
    )
    print(f"server listening on {host}:{port} (n_embd={engine.n_embd})",
          file=sys.stderr)
    try:
        async with server:
            await server.serve_forever()
    finally:
        await batcher.stop()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-m", "--model", required=True, help="GGUF model path")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the "
                        "plain PyTorch versions of the kernels)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--output-dtype", choices=["float32", "int8"], default="int8",
                   help="embedding transfer encoding off the device (replies stay f32)")
    p.add_argument("--packing", choices=["auto", "always", "never"], default="auto",
                   help="pack short sentences many to a row (auto), every text "
                        "that fits a row (always) or none (never)")
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("--window-ms", type=float, default=2.0)
    p.add_argument("--max-pending", type=int, default=16384)
    args = p.parse_args(argv)

    from ..models.bert import ComputeOptions
    from .engine import Engine

    engine = Engine.from_gguf(
        args.model, device=args.device, packing=args.packing,
        opts=ComputeOptions(dtype=args.dtype, output_dtype=args.output_dtype),
    )
    asyncio.run(serve(engine, args.host, args.port, args.max_batch,
                      args.window_ms, max_pending=args.max_pending))


if __name__ == "__main__":
    main()
