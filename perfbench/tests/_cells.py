"""What the benchmark's tests share: configurations cut to a size a CPU
test holds, and the cells' workload files with their traffic cut to
match."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# published widths where the test must see the model's real spread of
# vectors (the comparison and its faults); tiny ones for the parity tests
SMALL = {
    "bert": dict(num_hidden_layers=6, vocab_size=2000),
    "modernbert": dict(num_hidden_layers=6, vocab_size=2000, max_position_embeddings=2048),
}
TINY = {
    "bert": dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                 num_hidden_layers=2, vocab_size=1000),
    "modernbert": dict(hidden_size=64, intermediate_size=96, num_attention_heads=4,
                       num_hidden_layers=4, vocab_size=1200, local_attention=16,
                       max_position_embeddings=1024),
}


def cut_cell(cell: str, sizes: dict) -> tuple[dict, dict]:
    """(workload, config) of a cell at a CPU test's size: the config with
    `sizes[arch]` applied, calls of at most 24 texts of at most an eighth
    of their length."""
    from perfbench import harness

    w = copy.deepcopy(harness.load_json(f"workloads/{cell}.json"))
    c = harness.load_json(f"configs/{w['config']}.json")
    c.update(sizes[c["arch"]])
    p = w["params"]
    p["texts_per_call"] = min(p["texts_per_call"], 24)
    if p["length"]["dist"] != "normal":
        p["length"].update(min=p["length"]["min"] // 8, max=p["length"]["max"] // 8)
    if "pack_seq" in w.get("engine", {}):
        w["engine"]["pack_seq"] = 256
    return w, c


