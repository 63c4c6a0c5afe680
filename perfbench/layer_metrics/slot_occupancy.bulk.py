"""Real tokens over padded token slots of every batch the planner launched
in the window (`runtime/batching.py`, `Engine._dispatch`): the port's own
`tokens` / `padded_slots` counters (`utils/metrics.GLOBAL`), in %."""
from perfbench.layer_metrics._common import slot_occupancy


def read(run):
    return slot_occupancy(run)
