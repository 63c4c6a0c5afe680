"""Device microseconds per 1000 real tokens of every operation neither the
linears nor attention claim: the norms, RoPE, adds, gathers, pooling and
copies the models run in plain PyTorch (`models/*.py`), over the traced
slice."""
from perfbench.layer_metrics._common import is_attention, is_linear


def read(run):
    s = run.slice
    if s is None or not s.kernels or not len(s.lengths):
        return None
    rest = s.kernel_seconds(lambda n: not is_linear(n) and not is_attention(n))
    return rest * 1e6 / (float(s.lengths.sum()) / 1e3)
