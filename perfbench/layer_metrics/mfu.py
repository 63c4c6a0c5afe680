"""The whole forward's share of the card's bf16 peak: the model operations
of the real tokens completed in the window (`counts.model_flops`: every
linear, and attention over each text's own visible pairs) over the
window's seconds (profiler off), over the published peak, in %."""
from perfbench import counts
from perfbench.layer_metrics._common import peaks


def read(run):
    win = run.window
    if not win or win["seconds"] <= 0 or not len(win["lengths"]):
        return None
    if peaks(run) is None:
        return None
    flops = counts.model_flops(run.config, win["lengths"])
    return 100.0 * flops / win["seconds"] / peaks(run)[1]
