"""The plain f32 PyTorch reference of each model family, found by the
configuration's `arch`: `reference/<arch>.py` gives `tensors(config)` (the
checkpoint's tensor names, shapes and kinds) and `forward(weights, ids,
config, mm)` (one text's framed ids -> its pooled, L2-normalized vector).

Nothing here imports the port: the reference dequantizes the raw GGUF
blocks itself (`common.dequantize`) and derives the ids again from the
texts (`common.TextIds`)."""
from __future__ import annotations

import importlib


def arch_module(arch: str):
    """The reference module of a family (`reference/<arch>.py`)."""
    return importlib.import_module(f"{__name__}.{arch.replace('-', '_')}")
