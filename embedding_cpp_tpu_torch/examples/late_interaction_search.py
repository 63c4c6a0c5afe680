"""Late-interaction (ColBERT-style MaxSim) retrieval demo.

The port's copy of the JAX package's `examples/late_interaction_search.py`:
the token-level retrieval surfaces the reference has no analog for
(bert.h:41-92 is dense pooled vectors only):

- MaxSimIndex: corpus TOKEN states resident on the device, batched MaxSim
  top-k in one call (runtime/maxsim_search.py);
- Engine.maxsim_rerank: re-encode-per-query MaxSim, the rerank shape;
- ColBERT checkpoints (config.colbert_dim > 0) automatically get the
  checkpoint's semantics on both surfaces: [Q]/[D] marker framing,
  [MASK] query augmentation, per-token projection, punctuation skiplist.

Usage:
    python -m embedding_cpp_tpu_torch.cli.make_test_model /tmp/colbert.gguf --preset tiny-colbert
    python -m embedding_cpp_tpu_torch.examples.late_interaction_search /tmp/colbert.gguf \\
        [corpus.txt] [-k 3] [--device cpu]

Any encoder family works (generic token states when the checkpoint is not
ColBERT-format).
"""
import argparse
import os
import sys

DEFAULT_CORPUS = os.path.join(os.path.dirname(__file__), "sample_client_texts.txt")
QUERIES = ["how is the weather today?", "a quick brown animal"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("model", help="GGUF model path (any encoder; ColBERT "
                                 "checkpoints use their own framing)")
    p.add_argument("corpus", nargs="?", default=DEFAULT_CORPUS,
                   help="one document per line")
    p.add_argument("-k", type=int, default=3)
    p.add_argument("--doc-maxlen", type=int, default=128,
                   help="per-document token budget (ColBERT doc_maxlen)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' runs the plain PyTorch "
                        "versions of the kernels)")
    args = p.parse_args(argv)

    from ..runtime.engine import Engine
    from ..runtime.maxsim_search import MaxSimIndex

    engine = Engine.from_gguf(args.model, device=args.device)
    with open(args.corpus) as f:
        docs = [ln.strip() for ln in f if ln.strip()]
    mode = ("ColBERT checkpoint (markers + MASK augmentation + skiplist)"
            if engine.config.colbert_dim else "generic token states")
    print(f"indexing {len(docs)} documents — {mode}")

    index = MaxSimIndex(engine, doc_maxlen=args.doc_maxlen)
    index.add(docs)

    ids, scores = index.search(QUERIES, k=args.k)
    for qi, q in enumerate(QUERIES):
        print(f"\nquery: {q!r}")
        for rank, (i, s) in enumerate(zip(ids[qi], scores[qi]), 1):
            if i < 0:
                break
            print(f"  {rank}. [{s:7.3f}] {docs[i]}")

    # the rerank shape over a candidate subset: same scores, re-encoded
    ranked = engine.maxsim_rerank(QUERIES[0], docs[: args.k + 2], top_n=args.k)
    print(f"\nmaxsim_rerank over the first {args.k + 2} docs:")
    for r in ranked:
        print(f"  [{r['relevance_score']:7.3f}] {docs[r['index']]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
