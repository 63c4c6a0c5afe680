"""Measurement and evaluation scripts of the port, each runnable as
`python -m embedding_cpp_tpu_torch.benchmarks.<name>` (the card by default,
`--device cpu` where the script runs a model): the kernel A/B suite
(`kernels`), the index timings (`indexes`), the MTEB-protocol evaluation
(`tasks`, `run_eval`, `print_tables`), the headline (`bench`), served
throughput (`serving`), dp x tp scaling (`scaling`) and the dense, sparse
and MaxSim retrieval benchmarks (`search`, `sparse`, `maxsim_bench`);
`profiles` holds the serving-shaped inputs they share."""
