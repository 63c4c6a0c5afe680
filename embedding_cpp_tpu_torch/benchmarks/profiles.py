"""Serving-shaped inputs shared by the kernel suite, chip_smoke.py and the
tests: packed rows with the corpus's sentence-length profile, long packed
rows of chunk- or document-sized segments (nomic's chunk and document
rows), and the (query, key) pairs of such rows that share a segment id,
the work no skip can remove, which the packed attention kernels' bounds
count."""
from __future__ import annotations

import numpy as np


def serving_segments(rng, b: int, s: int, mean_len: float = 12.6):
    """(seg, pos) [b, s] int32: packed rows with the STSB corpus's
    sentence-length profile (~12.6 tokens a sentence, 3-64), seg = -1 and
    pos = 0 on the padded tail."""
    seg = np.full((b, s), -1, np.int32)
    pos = np.zeros((b, s), np.int32)
    for i in range(b):
        c = g = 0
        while True:
            n = int(np.clip(rng.geometric(1.0 / mean_len), 3, 64))
            if c + n > s:
                break
            seg[i, c:c + n] = g
            pos[i, c:c + n] = np.arange(n)
            c, g = c + n, g + 1
    return seg, pos


def packed_rows(rng, b: int, s: int, lo: int, hi: int, tile: int = 0):
    """seg/pos [b, s]: each row holds segments of lo..hi tokens in order and
    ends in at least 16 padding slots (seg -1).  With `tile`, a segment
    that would cross a multiple of `tile` ends on it instead, so segments
    end exactly on the kernel's query-tile boundaries."""
    seg = np.full((b, s), -1, np.int32)
    pos = np.zeros((b, s), np.int32)
    for i in range(b):
        c = g = 0
        while True:
            n = int(rng.integers(lo, hi + 1))
            if tile and c // tile != (c + n - 1) // tile:
                n = (c // tile + 1) * tile - c
            if c + n > s - 16:
                break
            seg[i, c:c + n], pos[i, c:c + n] = g, np.arange(n)
            c, g = c + n, g + 1
    return seg, pos


def segment_pairs(seg: np.ndarray, tq: int | None = None, wmax: int | None = None) -> float:
    """The (query, key) pairs of seg [B, S] that share a segment id, the
    padding id -1 included (padding queries attend padding keys).  With
    `wmax`, each query tile of `tq` rows counts only the keys of its
    wmax-key slice (K6's windowed form); without, every key."""
    from ..ops.attention import _slice_keys

    b, s = seg.shape
    kidx = (np.arange(s)[None] if wmax is None
            else _slice_keys(s, tq, wmax, "cpu").numpy())
    tq = s if wmax is None else tq
    n = int(seg.max()) + 2  # ids -1..max shifted to 0..max+1
    pairs = 0
    for row in seg.astype(np.int64) + 1:
        for t, keys in enumerate(kidx):
            pairs += int(np.dot(np.bincount(row[t * tq:(t + 1) * tq], minlength=n),
                                np.bincount(row[keys], minlength=n)))
    return float(pairs)


def segment_window_pairs(seg: np.ndarray, window: int) -> float:
    """The (query, key) pairs of seg [B, S] that share a segment id and lie
    within |q - k| <= window // 2, the padding id -1 included: the pairs
    mode 3 (segments and the sliding window) cannot skip."""
    s = seg.shape[1]
    pairs = 0
    for off in range(-(window // 2), window // 2 + 1):
        a = seg[:, max(0, -off):s - max(0, off)]
        b = seg[:, max(0, off):s - max(0, -off)]
        pairs += int((a == b).sum())
    return float(pairs)
