"""Formatting shared by the CLIs."""
from __future__ import annotations

import numpy as np


def format_embedding(vec: np.ndarray, head: int = 8) -> str:
    prefix = ", ".join(f"{x:+.6f}" for x in vec[:head])
    return f"embedding[{vec.shape[0]}] = [{prefix}, ...]"
