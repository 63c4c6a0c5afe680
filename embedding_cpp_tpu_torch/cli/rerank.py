"""CLI: rerank documents against a query with a cross-encoder GGUF model.

    python -m embedding_cpp_tpu_torch.cli.rerank -m reranker.gguf \\
        -q "where is the dog" -d "the dog sat on the mat" -d "cats drink milk"

Documents can also come from a file (--docs-file, one per line; '-' reads
stdin).  The model must carry a classification head; an embedding model
is refused.  `--device`: the GPU by default, `cpu` runs the kernels' plain
PyTorch versions.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-m", "--model", required=True, help="path to GGUF model")
    p.add_argument("-q", "--query", required=True)
    p.add_argument("-d", "--document", action="append", default=[],
                   help="document to score (repeatable)")
    p.add_argument("--docs-file", help="file with one document per line ('-' = stdin)")
    p.add_argument("--top-n", type=int, default=None)
    p.add_argument("--raw-scores", action="store_true",
                   help="print raw logits instead of sigmoid scores")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the plain PyTorch "
                        "versions of the kernels)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    args = p.parse_args(argv)

    docs = list(args.document)
    if args.docs_file:
        f = sys.stdin if args.docs_file == "-" else open(args.docs_file)
        with f:
            docs.extend(line.rstrip("\n") for line in f if line.strip())
    if not docs:
        p.error("no documents (use -d or --docs-file)")

    from ..models.bert import ComputeOptions
    from ..runtime.engine import Engine

    t0 = time.perf_counter()
    engine = Engine.from_gguf(args.model, device=args.device,
                              opts=ComputeOptions(dtype=args.dtype))
    t_load = time.perf_counter() - t0

    t1 = time.perf_counter()
    ranked = engine.rerank(args.query, docs, top_n=args.top_n,
                           activation=None if args.raw_scores else "sigmoid")
    t_eval = time.perf_counter() - t1

    width = len(str(len(docs) - 1))
    for r in ranked:
        doc = docs[r["index"]]
        if len(doc) > 72:
            doc = doc[:69] + "..."
        print(f"{r['relevance_score']:+.6f}  [{r['index']:>{width}}] {doc}")
    print(f"load time = {t_load*1000:8.2f} ms", file=sys.stderr)
    print(f"rerank    = {t_eval*1000:8.2f} ms ({len(docs)} documents, "
          "includes the kernels' build on first call)", file=sys.stderr)


if __name__ == "__main__":
    main()
