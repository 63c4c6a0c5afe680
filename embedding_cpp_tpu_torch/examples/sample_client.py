"""Semantic-search demo against the embedding server.

The port's copy of the JAX package's `examples/sample_client.py` (the
reference's examples/sample_client.py behavior): embed a corpus of lines
over the socket, then query from standard input for the top-k most similar
lines by cosine similarity, computed here.  Uses the framed (TPE2) batch
protocol by default; pass --raw for the reference's one-message-per-
sentence protocol.  It runs no model itself, so it takes no --device: the
server's decides.

    python -m embedding_cpp_tpu_torch.runtime.server -m model.gguf --port 8080 &
    python -m embedding_cpp_tpu_torch.examples.sample_client --port 8080
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..runtime.client import EmbeddingClient


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--texts", default=str(Path(__file__).parent / "sample_client_texts.txt"))
    p.add_argument("--raw", action="store_true", help="reference wire protocol")
    p.add_argument("-k", type=int, default=3)
    args = p.parse_args(argv)

    lines = [ln.strip() for ln in open(args.texts, encoding="utf-8") if ln.strip()]
    with EmbeddingClient(args.host, args.port) as client:
        print(f"connected: n_embd={client.n_embd}; embedding {len(lines)} lines...")
        if args.raw:
            corpus = np.stack([client.embed_raw(ln) for ln in lines])
        else:
            corpus = client.embed(lines)
        print("ready. type a query (empty line to quit):")
        for query in sys.stdin:
            query = query.strip()
            if not query:
                break
            qv = client.embed([query])[0]
            sims = corpus @ qv
            top = np.argsort(-sims)[: args.k]
            for i in top:
                print(f"  {sims[i]:+.4f}  {lines[i]}")


if __name__ == "__main__":
    main()
