"""Sparse (SPLADE) + hybrid retrieval demo over an MLM-head model.

The port's copy of the JAX package's `examples/sparse_retrieval.py`: the
three sparse surfaces the reference has no analog for (bert.h:41-92 is
dense pooled vectors only):

- Engine.encode_sparse: |V|-dim sparse lexical vectors as (term id, weight)
  pairs, with the vocab terms resolved so the expansion is readable;
- SparseIndex: exact sparse dot-product top-k over a corpus;
- hybrid retrieval: dense cosine + sparse SPLADE rankings fused by
  reciprocal rank (rrf_fuse), no score calibration needed.

Queries are read from standard input, one a line; on a terminal the demo
asks one ("what do plants eat").

Usage:
    python -m embedding_cpp_tpu_torch.cli.make_test_model /tmp/splade.gguf --preset tiny-splade
    python -m embedding_cpp_tpu_torch.examples.sparse_retrieval /tmp/splade.gguf [corpus.txt] \\
        [-k 3] [--device cpu]
"""
import argparse
import os
import sys

DEFAULT_CORPUS = os.path.join(os.path.dirname(__file__), "sample_client_texts.txt")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", help="GGUF model path (MLM-head / SPLADE)")
    p.add_argument("corpus", nargs="?", default=DEFAULT_CORPUS,
                   help="one document per line")
    p.add_argument("-k", type=int, default=3, help="results per query")
    p.add_argument("--terms", type=int, default=8,
                   help="expansion terms to print per text")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the plain PyTorch "
                        "versions of the kernels)")
    args = p.parse_args(argv)

    from ..runtime.engine import Engine
    from ..runtime.search import VectorIndex
    from ..runtime.sparse_search import SparseIndex, rrf_fuse

    engine = Engine.from_gguf(args.model, device=args.device)
    if not engine.config.mlm_head:
        print("model has no MLM head — convert with --sparse "
              "(needs a *ForMaskedLM / SPLADE checkpoint)", file=sys.stderr)
        return 1
    with open(args.corpus) as f:
        docs = [line.strip() for line in f if line.strip()]
    print(f"corpus: {len(docs)} documents")

    # 1. readable sparse expansion of the first document
    (ids, weights), = engine.encode_sparse(docs[:1], k=args.terms)
    expansion = ", ".join(
        f"{engine.id_to_token(int(t))}:{w:.2f}" for t, w in zip(ids, weights)
    )
    print(f"\nsparse expansion of {docs[0]!r}:\n  {expansion}")

    # 2. build both indexes over the same corpus (identical doc ids)
    dense = VectorIndex(engine)
    dense.add(docs)
    sparse = SparseIndex(engine)
    sparse.add(docs)

    for query in (sys.stdin if not sys.stdin.isatty() else ["what do plants eat"]):
        query = query.strip()
        if not query:
            continue
        d_idx, d_scores = dense.search([query], args.k)
        s_idx, s_scores = sparse.search([query], args.k)
        f_idx, f_scores = rrf_fuse([d_idx, s_idx], args.k)
        print(f"\nquery: {query!r}")
        for name, idx, scores in (("dense", d_idx, d_scores),
                                  ("sparse", s_idx, s_scores),
                                  ("hybrid", f_idx, f_scores)):
            rows = "; ".join(
                f"[{int(i)}] {docs[int(i)][:40]!r} ({float(s):.3f})"
                for i, s in zip(idx[0], scores[0]) if i >= 0
            )
            print(f"  {name:6s}: {rows}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
