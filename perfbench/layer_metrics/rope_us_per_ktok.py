"""Device microseconds per 1000 real tokens of RoPE (`models/modernbert.py`:
`rope_cos_sin` and `apply_rope`, which nomic-bert shares), over the traced
slice: the device operations under the program's range `op.rope`
(`program_trace.py`)."""
from perfbench.program_trace import per_ktok, program_trace


def read(run):
    pt = program_trace(run)
    if pt is None or not run.slice.kernels:  # no device row: no device time
        return None
    return per_ktok(pt.device_seconds("op.rope"), run, 1e6)
