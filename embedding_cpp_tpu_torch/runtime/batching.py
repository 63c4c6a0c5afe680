"""Length-bucketed batch assembly and sequence packing.

A copy of the JAX package's `runtime/batching.py` (numpy only): sentences
are grouped into a small set of (batch, seq) shapes, padded rows are
masked, and results are scattered back to input order.  Short sentences
pack many to a row with segment ids (`pack_segments`); the model masks
attention block-diagonal by segment and pools per segment.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import chain
from typing import Sequence

import numpy as np

DEFAULT_SEQ_BUCKETS = (16, 32, 64, 128, 256, 512)
# Large top bucket: one device dispatch per shape class dominates throughput
# (dispatch latency amortizes over rows; occupancy is tracked in metrics).
DEFAULT_BATCH_BUCKETS = (1, 8, 64, 512, 2048)


def bucket_for(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


@dataclass
class PackedBatch:
    ids: np.ndarray  # [B, S] int32, padded with pad_id
    mask: np.ndarray  # [B, S] int32, 1 = valid
    positions: list[int]  # original index of each row (len = n_real rows)


# --- sequence packing --------------------------------------------------------
# Many short sentences per row, distinguished by segment ids: turns
# short-sentence traffic (the reference's STSB workload averages ~16 tokens)
# into a few large dispatches instead of many small ones.  The model side
# (models.bert.bert_embed_packed) masks attention block-diagonal by segment
# and pools per segment, so results equal the one-row-per-sentence path.

DEFAULT_PACK_SEQ = 512
DEFAULT_PACK_SEGS = 64
# Packed rows are large (512 token slots), so row-count buckets are finer
# than sentence-batch buckets: powers of two bound pad waste at 2x while
# keeping the set of compiled shapes small.
DEFAULT_PACK_ROW_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)


@dataclass
class PackedSegBatch:
    ids: np.ndarray  # [B, S] int32, padded with pad_id
    seg: np.ndarray  # [B, S] int32 segment id per token, -1 on padding
    pos: np.ndarray  # [B, S] int32 within-segment position (0 on padding)
    n_seg: int  # static segments-per-row capacity (G)
    positions: list[list[int]]  # [row][segment] -> original sentence index
    # flat views of `positions` for vectorized device gather / host scatter:
    orig: np.ndarray = None  # [n] original sentence index per real segment
    slots: np.ndarray = None  # [n] row * n_seg + segment for each of them
    max_len: int = 0  # longest packed sentence (windowed-attention bound)


def _nfd_place(lens: np.ndarray, seq_len: int, n_seg: int) -> list[list[int]]:
    """Consecutive next-fit-decreasing placement: sort descending, each row
    takes the longest prefix of the remainder that fits (token capacity and
    the n_seg cap).  O(rows) searchsorteds — see pack_segments for when this
    is within ~1% of FFD."""
    order = np.argsort(-lens, kind="stable")
    sl = lens[order]
    csum = np.concatenate([[0], np.cumsum(sl)])
    rows: list[list[int]] = []
    start, n = 0, len(sl)
    while start < n:
        j = int(np.searchsorted(csum, csum[start] + seq_len, side="right")) - 1
        j = max(min(j, start + n_seg), start + 1)
        rows.append(order[start:j].tolist())
        start = j
    return rows


def _ffd_place(
    token_lists: Sequence[Sequence[int]], lens: np.ndarray, seq_len: int,
    n_seg: int,
) -> list[list[int]]:
    """First-fit-decreasing placement over OPEN rows only.

    Lengths arrive descending, so once a row can't fit the current
    (smallest-so-far) sentence it can only close later via the seg cap — but
    scanning it again every sentence is Theta(n * rows).  Rows too full for
    the current sentence move to `closed` and are never rescanned; since
    `need` only shrinks, a row skipped for capacity at need=k can be
    reopened only if a later sentence is shorter — handled by re-checking
    closed rows whenever `need` drops below the capacity they were closed
    at."""
    order = np.argsort(-lens, kind="stable").tolist()
    rows: list[list[int]] = []  # local indices per row
    space: list[int] = []  # remaining token capacity per row
    open_rows: list[int] = []  # row indices with free space, capacity-usable
    closed_at: dict[int, int] = {}  # row -> need value it was closed at
    prev_need = None
    for i in order:
        need = len(token_lists[i])
        if prev_need is not None and need < prev_need:
            # shorter sentences may fit rows closed for capacity earlier
            reopen = [r for r, at in closed_at.items()
                      if space[r] >= need and len(rows[r]) < n_seg]
            for r in reopen:
                del closed_at[r]
            open_rows.extend(reopen)
        prev_need = need
        placed = False
        still_open: list[int] = []
        for pos, r in enumerate(open_rows):
            if space[r] >= need and len(rows[r]) < n_seg:
                rows[r].append(i)
                space[r] -= need
                placed = True
                if space[r] >= need and len(rows[r]) < n_seg:
                    still_open.append(r)
                else:
                    closed_at[r] = need
                open_rows = still_open + open_rows[pos + 1 :]
                break
            closed_at[r] = need  # can't fit anything >= need anymore
        if not placed:
            open_rows = []
            rows.append([i])
            space.append(seq_len - need)
            r = len(rows) - 1
            if space[r] >= need:
                open_rows.append(r)
            else:
                closed_at[r] = need
    return rows


def pack_segments(
    token_lists: Sequence[Sequence[int]],
    indices: Sequence[int],
    pad_id: int,
    *,
    seq_len: int = DEFAULT_PACK_SEQ,
    n_seg: int = DEFAULT_PACK_SEGS,
    batch_buckets: Sequence[int] = DEFAULT_PACK_ROW_BUCKETS,
    row_multiple: int = 1,
    max_pad_rows: int = 64,
) -> list[PackedSegBatch]:
    """First-fit-decreasing bin packing of sentences into [B, seq_len] rows.

    `indices[i]` is the original position of `token_lists[i]` (the caller may
    pack a subset).  Every sentence must have len <= seq_len; each row holds
    at most n_seg sentences.  `row_multiple` rounds each batch's row count up
    (to the mesh's dp size, so a batch splits evenly over its slots).

    `max_pad_rows` trades padded compute for dispatch count: a chunk pads to
    its power-of-two bucket when that wastes <= max_pad_rows rows, otherwise
    it splits base-2 (64+8 instead of a half-empty 128).  With the compact
    output gather, padded rows cost FLOPs only, not transfer.
    """
    lens = np.fromiter(
        (len(t) for t in token_lists), dtype=np.int64, count=len(token_lists)
    )
    if lens.size and int(lens.max()) > seq_len:
        raise ValueError(
            f"sentence of {int(lens.max())} tokens exceeds pack row {seq_len}"
        )
    if lens.size and int(lens.max()) * 8 <= seq_len:
        # uniformly-short workload (every sentence <= seq_len/8): consecutive
        # next-fit-decreasing packs as tightly as FFD here (70 rows either
        # way on the 2758-sentence STSB-profile corpus) and runs in O(rows)
        # numpy searchsorteds instead of a per-sentence Python loop.  Long
        # sentences break the equivalence (a 300-token head leaves space
        # only backfill can use), so they keep FFD.
        rows = _nfd_place(lens, seq_len, n_seg)
    else:
        rows = _ffd_place(token_lists, lens, seq_len, n_seg)

    # dispatch planning: power-of-two row buckets (bounded compile cache);
    # pad a chunk up to its bucket when the waste fits max_pad_rows, else
    # split base-2 (64+8 instead of a half-empty 128)
    chunks: list[list[list[int]]] = []
    start = 0
    max_bucket = batch_buckets[-1]
    while start < len(rows):
        remaining = len(rows) - start
        if remaining > max_bucket:
            size = max_bucket
        else:
            bucket = bucket_for(remaining, batch_buckets)
            if bucket - remaining <= max_pad_rows or remaining < 16:
                size = remaining
            else:
                size = 1 << (remaining.bit_length() - 1)
        chunks.append(rows[start : start + size])
        start += size

    batches: list[PackedSegBatch] = []
    for chunk in chunks:
        b = bucket_for(len(chunk), batch_buckets)
        b = -(-b // row_multiple) * row_multiple
        ids = np.full((b, seq_len), pad_id, dtype=np.int32)
        seg = np.full((b, seq_len), -1, dtype=np.int32)
        pos = np.zeros((b, seq_len), dtype=np.int32)
        positions: list[list[int]] = []
        for r, row in enumerate(chunk):
            row_lens = [len(token_lists[i]) for i in row]
            total = sum(row_lens)
            ids[r, :total] = np.fromiter(
                chain.from_iterable(token_lists[i] for i in row),
                dtype=np.int32, count=total,
            )
            seg[r, :total] = np.repeat(
                np.arange(len(row), dtype=np.int32), row_lens
            )
            starts = np.cumsum([0] + row_lens[:-1])
            pos[r, :total] = (
                np.arange(total, dtype=np.int32)
                - np.repeat(starts, row_lens).astype(np.int32)
            )
            positions.append([indices[i] for i in row])
        orig = np.array(
            [o for row in positions for o in row], dtype=np.int64
        )
        slots = np.array(
            [r * n_seg + g for r, row in enumerate(positions) for g in range(len(row))],
            dtype=np.int32,
        )
        max_len = max(
            (len(token_lists[i]) for row in chunk for i in row), default=0
        )
        batches.append(
            PackedSegBatch(
                ids=ids, seg=seg, pos=pos, n_seg=n_seg, positions=positions,
                orig=orig, slots=slots, max_len=max_len,
            )
        )
    return batches


def pack_batches(
    token_lists: Sequence[Sequence[int]],
    pad_id: int,
    *,
    seq_buckets: Sequence[int] = DEFAULT_SEQ_BUCKETS,
    batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
    max_seq: int | None = None,
    max_tokens: int | None = None,
    pad_rows: bool = True,
) -> list[PackedBatch]:
    """Group tokenized sentences into padded static-shape batches.

    `max_tokens` bounds one batch's token slots (rows x seq bucket): long
    sequence buckets get proportionally fewer rows per dispatch so the
    activation footprint of a single compiled shape stays bounded.  With
    `pad_rows=False` a batch holds only its real rows: the row buckets then
    only cap a batch's size."""
    if max_seq is not None:
        seq_buckets = [b for b in seq_buckets if b <= max_seq] or [max_seq]

    by_bucket: dict[int, list[int]] = {}
    for idx, toks in enumerate(token_lists):
        s = bucket_for(len(toks), seq_buckets)
        by_bucket.setdefault(s, []).append(idx)

    batches: list[PackedBatch] = []
    for s, indices in sorted(by_bucket.items()):
        bb = batch_buckets
        if max_tokens is not None and s * bb[-1] > max_tokens:
            row_cap = max(1, max_tokens // s)
            bb = [b for b in bb if b <= row_cap] or [row_cap]
        cap = bb[-1]
        for start in range(0, len(indices), cap):
            chunk = indices[start : start + cap]
            b = bucket_for(len(chunk), bb) if pad_rows else len(chunk)
            ids = np.full((b, s), pad_id, dtype=np.int32)
            mask = np.zeros((b, s), dtype=np.int32)
            for row, idx in enumerate(chunk):
                toks = list(token_lists[idx])[:s]
                ids[row, : len(toks)] = toks
                mask[row, : len(toks)] = 1
            batches.append(PackedBatch(ids=ids, mask=mask, positions=chunk))
    return batches
