"""Skewed walk storage + bucket-based in-memory walk management (§4.3).

*Skewed walk storage* (§4.3.1): a walk ``w_u^v`` persists with block
``min(B(u), B(v))`` — this is what makes the triangular schedule complete
(every stored walk's pair is visited in the time slot of its min block).

*Bucketing* (§4.3.2, Eq. 4 / Alg. 1 lines 4-10): within the time slot of
current block ``b``, a walk goes to bucket ``B(v)`` if ``B(u) == b`` else
``B(u)``; with the skewed invariant the bucket id is always ``> b``.

Both are vectorised: bucketing is one ``where`` + a stable counting sort, the
direct analogue of the paper's per-thread bucket buffers merged lock-free.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .graph import block_of
from .walk import WalkBatch

__all__ = [
    "skewed_block_assignment",
    "traditional_block_assignment",
    "bucket_ids",
    "push_by_block_assignment",
    "split_into_buckets",
]


def skewed_block_assignment(block_starts: np.ndarray, batch: WalkBatch) -> np.ndarray:
    """Block a walk persists with under skewed storage: min(B(u), B(v))."""
    bp = block_of(block_starts, batch.prev)
    bc = block_of(block_starts, batch.cur)
    return np.minimum(bp, bc)


def traditional_block_assignment(block_starts: np.ndarray, batch: WalkBatch) -> np.ndarray:
    """Traditional storage (baselines): a walk lives with B(cur)."""
    return block_of(block_starts, batch.cur)


def push_by_block_assignment(pool, block_starts, order: int, batch: WalkBatch, wid) -> None:
    """Persist ``batch`` through ``pool`` under the walk-storage rule —
    skewed ``min(B(u), B(v))`` for second order, traditional ``B(cur)``
    for first (§7.8).  The single association every tier persists with:
    the bi-block engine and the distributed sweep both call this, so the
    keying cannot silently diverge between them."""
    if len(batch) == 0:
        return
    if order == 1:
        assoc = traditional_block_assignment(block_starts, batch)
    else:
        assoc = skewed_block_assignment(block_starts, batch)
    for b in np.unique(assoc):
        m = assoc == b
        pool.push(int(b), batch.select(m), wid[m])


def bucket_ids(block_starts: np.ndarray, batch: WalkBatch, current_block: int) -> np.ndarray:
    """Eq. 4: bucket = B(v) if B(u) == b else B(u)."""
    bp = block_of(block_starts, batch.prev)
    bc = block_of(block_starts, batch.cur)
    return np.where(bp == current_block, bc, bp)


def split_into_buckets(
    block_starts: np.ndarray,
    batch: WalkBatch,
    current_block: int,
    wid: Optional[np.ndarray] = None,
) -> Dict[int, Tuple[WalkBatch, np.ndarray]]:
    """Group current walks into buckets (stable counting sort by bucket id).

    Returns wid-aligned ``bucket_id -> (WalkBatch, wid)`` pairs so callers
    never re-sort to realign walk ids.  When ``wid`` is omitted, positional
    ids ``arange(len(batch))`` are used.
    """
    if len(batch) == 0:
        return {}
    if wid is None:
        wid = np.arange(len(batch), dtype=np.int64)
    ids = bucket_ids(block_starts, batch, current_block)
    order = np.argsort(ids, kind="stable")
    ids_sorted = ids[order]
    batch = batch.select(order)
    wid_sorted = wid[order]
    # segment boundaries
    uniq, starts = np.unique(ids_sorted, return_index=True)
    out: Dict[int, Tuple[WalkBatch, np.ndarray]] = {}
    bounds = list(starts) + [len(batch)]
    for k, b_id in enumerate(uniq):
        seg = slice(bounds[k], bounds[k + 1])
        out[int(b_id)] = (batch.select(seg), wid_sorted[seg])
    return out
