"""Hot-set policy: which blocks serve from memory, which degrade to disk.

Serving traffic is skewed — most queries start near a few hub vertices
(the power-law regime of §7.6's graph families), so a few graph blocks
absorb most of the sweep's block loads.  The :class:`HotSetPolicy` keeps a
query-arrival histogram over blocks (each submitted query's source block
counts one arrival) and names the current top-``max_pinned`` blocks as the
*hot set*.  The server pins them into the
:class:`~repro_torch.io.BlockStore` — pinned blocks are held resident outside
the LRU, loaded (and charged) once, and served chargeless thereafter;
eviction governs only the cold tail.  That is ThunderRW's in-memory
serving regime on the hot set with the paper's disk economics on the cold
tail, and the savings are deterministic gauges
(``IOStats.pinned_block_hits`` / ``pinned_bytes_saved``).

The decision is program-order pure: the histogram depends only on the
submission sequence, ties break toward the lower block id, and blocks
need ``min_arrivals`` before qualifying (a single stray query should not
pin a megablock).
"""

from __future__ import annotations

import numpy as np

__all__ = ["HotSetPolicy"]


class HotSetPolicy:
    """Top-``max_pinned`` blocks of the query-arrival histogram.

    ``max_pinned=0`` disables pinning entirely — the pure-LRU reference
    ``chip_smoke.py``'s serving phase compares against.
    """

    def __init__(self, num_blocks: int, *, max_pinned: int = 2, min_arrivals: int = 1):
        if max_pinned < 0:
            raise ValueError("max_pinned must be >= 0")
        self.num_blocks = num_blocks
        self.max_pinned = max_pinned
        self.min_arrivals = max(int(min_arrivals), 1)
        self.arrivals = np.zeros(num_blocks, np.int64)

    def observe(self, block: int, n: int = 1) -> None:
        """Record ``n`` query arrivals whose source lives in ``block``."""
        self.arrivals[int(block)] += int(n)

    def hot_set(self) -> np.ndarray:
        """Current hot set: up to ``max_pinned`` block ids, by descending
        arrivals (ties toward the lower id), qualifying at
        ``min_arrivals``.  Sorted ascending for stable pinning calls."""
        if self.max_pinned == 0:
            return np.zeros(0, np.int64)
        order = np.lexsort((np.arange(self.num_blocks), -self.arrivals))
        top = order[: self.max_pinned]
        top = top[self.arrivals[top] >= self.min_arrivals]
        return np.sort(top).astype(np.int64)
