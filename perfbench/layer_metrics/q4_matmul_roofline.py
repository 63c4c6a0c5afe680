"""The quantized linears' share of their roofline (`ops/linear.py` ->
`ops/q4_matmul.py`, K1 / K8 of `csrc/q4_matmul.cu`): the summed bound of
every linear launched in the traced slice, at its launch shape (rows x
sequence of the batch, padding included; K x N; the qtype's block bytes),
over the device seconds of the kernels named as that layer's, in %."""
from perfbench import counts
from perfbench.layer_metrics._common import is_linear, peaks


def read(run):
    s = run.slice
    if s is None or not s.shapes or peaks(run) is None:
        return None
    busy = s.kernel_seconds(is_linear)
    if busy <= 0:
        return None
    return 100.0 * counts.linear_bound_s(run.config, s.shapes, peaks(run)) / busy
