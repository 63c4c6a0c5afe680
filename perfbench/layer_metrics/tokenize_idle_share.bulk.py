"""The share of the traced slice in which the card idles while the program
tokenizes: every idle gap between device operations whose midpoint falls
inside the program's own `tokenize` span (`Engine.tokenize_batch`), over
the slice's length, in %."""
from perfbench.program_trace import program_trace
from perfbench.trace import union


def read(run):
    pt = program_trace(run)
    s = run.slice
    spans = pt.intervals("tokenize") if pt is not None else []
    if not spans or not s.kernels or s.window_s <= 0:
        return None
    iv = union(s.kernels)
    bounds = [x for x in s.spans if x[0] == "slice"]
    lo, hi = (bounds[0][1], bounds[0][2]) if bounds else (iv[0][0], iv[-1][1])
    edges = [lo] + [x for a, b in iv for x in (a, b)] + [hi]
    idle = sum(b - a for a, b in zip(edges[::2], edges[1::2])
               if b > a and any(t0 <= (a + b) / 2 <= t1 for t0, t1 in spans))
    return 100.0 * idle * 1e-6 / s.window_s
