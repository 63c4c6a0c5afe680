"""The share of the traced slice in which no operation ran on the card: 1
minus the union of the device operations' intervals over the slice's
length, in %."""
from perfbench.layer_metrics._common import idle_share


def read(run):
    return idle_share(run)
