"""The benchmark of the PyTorch/CUDA port (`embedding_cpp_tpu_torch`).

`python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` on the card and prints one JSON line.
Everything a cell needs is data found by name: `configs/<config>.json`,
`workloads/<cell>.json`, `traffic/<kind>.py`, `layer_metrics/<metric>.py`
and `reference/<arch>.py`.  The yardstick (traffic, weights, vocabulary,
operation and byte counts, peaks, trace reduction, the plain reference and
the comparison that decides `correct`) lives here; from the port the
benchmark takes only the `Engine`, its counters and the names of the
kernels it launches.
"""
