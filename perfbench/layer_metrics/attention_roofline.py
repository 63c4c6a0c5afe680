"""Attention's share of its roofline (`ops/attention.py`; the kernels of
`csrc/attention_bse.cu`, `attention_long.cu`, `attention_headpack.cu`): the
summed bound of every layer's attention over the real (query, key) pairs
of the texts launched in the traced slice (`counts.attention_bound_s`),
over the device seconds of the kernels named as that layer's, in %."""
from perfbench import counts
from perfbench.layer_metrics._common import is_attention, peaks


def read(run):
    s = run.slice
    if s is None or not len(s.lengths) or peaks(run) is None:
        return None
    busy = s.kernel_seconds(is_attention)
    if busy <= 0:
        return None
    return 100.0 * counts.attention_bound_s(run.config, s.lengths, peaks(run)) / busy
