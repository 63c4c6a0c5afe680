"""Semantic search demo: embed a corpus once, answer queries by cosine.

The port's copy of the JAX package's `examples/semantic_search.py` (the
analog of the reference's examples/sample_client.py flow: embed
sample_client_texts.txt, then top-k per query).  Two modes:

- in-process (default): Engine + the on-device VectorIndex — the corpus
  embeds in one packed call, stays on the device, and each query fetches
  only k ids + scores (the reference pulls every corpus vector to the
  client);
- remote (--server host:port): the same index/search through a running
  embedding server's \\x01TPB / \\x01TPS frames.

Queries are read from standard input, one a line (an empty line ends).

Usage:
    python -m embedding_cpp_tpu_torch.examples.semantic_search <model.gguf> [corpus.txt] \\
        [-k 5] [--device cpu]
    python -m embedding_cpp_tpu_torch.examples.semantic_search --server 127.0.0.1:8080
    echo "how do plants make food" | python -m embedding_cpp_tpu_torch.examples.semantic_search m.gguf
"""
import argparse
import os
import sys
import time

DEFAULT_CORPUS = os.path.join(os.path.dirname(__file__), "sample_client_texts.txt")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", nargs="?", help="GGUF model path")
    p.add_argument("corpus", nargs="?", default=DEFAULT_CORPUS,
                   help="one sentence per line")
    p.add_argument("-k", type=int, default=5, help="results per query")
    p.add_argument("--server", metavar="HOST:PORT",
                   help="search through a running embedding server instead "
                        "of loading a model in-process")
    p.add_argument("--device", default=None,
                   help="torch device of the in-process engine (default: the GPU; "
                        "'cpu' runs the plain PyTorch versions of the kernels)")
    args = p.parse_args(argv)
    if not args.server and not args.model:
        p.error("either a model path or --server is required")

    with open(args.corpus) as f:
        corpus = [line.strip() for line in f if line.strip()]

    t0 = time.perf_counter()
    base = 0  # our corpus's offset within the (server-global) index
    if args.server:
        from ..runtime.client import EmbeddingClient

        host, _, port = args.server.rpartition(":")
        client = EmbeddingClient(host or "127.0.0.1", int(port))
        # the server index persists across clients: returned ids are global,
        # our texts start at total - len(corpus)
        base = client.index(corpus) - len(corpus)
        search = client.search
    else:
        from ..runtime.engine import Engine
        from ..runtime.search import VectorIndex

        engine = Engine.from_gguf(args.model, device=args.device)
        index = VectorIndex(engine)
        index.add(corpus)
        search = index.search
    dt = time.perf_counter() - t0
    print(f"indexed {len(corpus)} sentences in {dt:.2f}s "
          f"({len(corpus) / dt:.0f}/s) — embeddings stay on device", file=sys.stderr)

    interactive = sys.stdin.isatty()
    if interactive:
        print("query (empty line to quit):", file=sys.stderr)
    for line in sys.stdin:
        q = line.strip()
        if not q:
            break
        idx, scores = search([q], args.k)
        for rank, (i, s) in enumerate(zip(idx[0], scores[0]), 1):
            local = i - base
            text = (corpus[local] if 0 <= local < len(corpus)
                    else f"<index entry {i} from another client>")
            print(f"{rank}. [{s:+.4f}] {text}")
        if interactive:
            print("query (empty line to quit):", file=sys.stderr)
    if args.server:
        client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
