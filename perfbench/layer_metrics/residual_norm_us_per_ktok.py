"""Device microseconds per 1000 real tokens of the residual adds and the
norms (`ops/linear.py`: `linear`'s residual add, `layer_norm`, which
ModernBERT's bias-free norm also runs), over the traced slice: the device
operations under the program's ranges `op.residual` and `op.norm`
(`program_trace.py`)."""
from perfbench.program_trace import per_ktok, program_trace


def read(run):
    pt = program_trace(run)
    if pt is None or not run.slice.kernels:  # no device row: no device time
        return None
    return per_ktok(pt.device_seconds("op.residual", "op.norm"), run, 1e6)
