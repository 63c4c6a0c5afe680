"""Host milliseconds the program spends planning (`Engine._dispatch`'s
`plan` span: `_pack_plan`, `pack_segments`, `pack_batches` and the id
checks) per 1000 tokens it planned, over the traced slice, on the
profiler's clock."""
from perfbench.program_trace import per_ktok, program_trace


def read(run):
    pt = program_trace(run)
    if pt is None or not pt.intervals("plan"):
        return None
    return per_ktok(pt.span_seconds("plan"), run, 1e3)
