"""The (query, key) pairs attention cannot skip.

`segment_pairs` and `segment_window_pairs` are frozen copies of the port's
`embedding_cpp_tpu_torch/benchmarks/profiles.py` counting (as of this
benchmark's first version; the windowed-slice form of `segment_pairs`,
which reads the kernel's own key slices, is left out): pairs of a packed
[B, S] segment-id array that share a segment, padding (-1) included.  The
benchmark counts real pairs only, from the texts' lengths
(`text_pairs`), which equals the copies' count over padding-free rows, as
the tests check."""
from __future__ import annotations

import numpy as np


def segment_pairs(seg: np.ndarray) -> float:
    """Pairs of seg [B, S] that share a segment id, the padding id -1
    included."""
    n = int(seg.max()) + 2
    pairs = 0
    for row in seg.astype(np.int64) + 1:
        c = np.bincount(row, minlength=n)
        pairs += int(np.dot(c, c))
    return float(pairs)


def segment_window_pairs(seg: np.ndarray, window: int) -> float:
    """Pairs of seg [B, S] that share a segment id and lie within |q - k| <=
    window // 2, the padding id -1 included."""
    s = seg.shape[1]
    pairs = 0
    for off in range(-(window // 2), window // 2 + 1):
        a = seg[:, max(0, -off):s - max(0, off)]
        b = seg[:, max(0, off):s - max(0, -off)]
        pairs += int((a == b).sum())
    return float(pairs)


def text_pairs(lengths: np.ndarray, half_window: int | None = None) -> float:
    """Pairs within each text of `lengths` tokens: L^2, or with a window the
    keys within |q - k| <= half_window of each query."""
    n = np.asarray(lengths, dtype=np.float64)
    if half_window is None:
        return float((n * n).sum())
    w = float(half_window)
    # per text: L (2w + 1) - w (w + 1) where L > w; every pair where L <= w + 1
    long_ = n > w
    full = (n * n)[~long_].sum()
    part = (n[long_] * (2 * w + 1) - w * (w + 1)).sum()
    return float(full + part)
