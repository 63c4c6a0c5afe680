"""The library's documented entry points as scripts (the JAX package's
`examples/`, on the port): semantic search, sparse and hybrid retrieval,
late-interaction search and the server's sample client.  Each runs as
`python -m embedding_cpp_tpu_torch.examples.<name>`; the corpus they use by
default is this folder's `sample_client_texts.txt`."""
