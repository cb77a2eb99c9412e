"""The staged async bi-block pipeline: what overlaps with what.

The serial bi-block loop executes each time slot as
``pool load -> bucket split -> ancillary view load -> advance -> persist``
with only a one-bucket-ahead partial-view prefetch.  This module turns the
slot into an explicit three-stage pipeline driven from the
:class:`~repro.core.scheduler.TimeSlotPlan`:

* **walk stage** (walk-pool writer thread) — persists ride a sequenced
  writer queue (:class:`repro.io.AsyncWalkPool`), and the *next* slot's pool
  drain + bucket split run there as a ``drain_async`` preload while the
  current slot advances;
* **view stage** (block-store prefetch thread) — the next slot's
  current-block view and the next bucket's ancillary view (full or
  activated, per the tentative LBL decision) build via
  :meth:`repro.io.BlockStore.schedule`;
* **execute stage** (main thread) — the jitted ``advance_pair`` call on the
  resident view pair.

Determinism is structural, not lucky: a preload is a FIFO job on the writer
queue, so it observes exactly the pushes enqueued before it in program
order — a *prefix* of the slot's walks.  Pools preserve push order, so
``prefix drain + remainder drain`` at slot start concatenates to what one
serial ``load`` would have returned, and with the counter-based per-walk
RNG the walks are bit-identical to the serial reference mode
(``async_pipeline=False``).  Prefetching never charges; the preload only
moves *when* walk reads happen, never what executes.

:class:`BucketCursor` replaces the serial engine's ``sorted(pending)``
rescan with an ordered min-heap cursor that tolerates Alg. 2
extension-grown buckets (extensions only target later blocks; buckets only
grow).
"""

from __future__ import annotations

import heapq
from concurrent.futures import Future
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.buckets import split_into_buckets
from repro_torch.core.scheduler import TimeSlotPlan
from repro_torch.core.stats import IOStats
from repro_torch.core.walk import WALK_BYTES, WalkBatch
from repro_torch.io import AsyncWalkPool, BlockStore, ShardedWalkPool

__all__ = ["BucketCursor", "BucketPipeline"]

#: pool types whose persists ride sequenced writer threads and whose
#: ``drain_async`` the pipeline can preload from — the single writer and
#: its keyspace-partitioned generalisation (one writer per shard)
SEQUENCED_POOLS = (AsyncWalkPool, ShardedWalkPool)


class BucketCursor:
    """Ordered cursor over one time slot's pending buckets.

    Bucket ids pop in strictly increasing order (the triangular ancillary
    order); Alg. 2 extensions merge in mid-slot without a rescan because
    they only ever target blocks *after* the executing one.  Equivalent to
    the serial ``sorted(k for k in pending if k > i)`` rescan, minus the
    O(buckets log buckets) per-bucket re-sort.
    """

    def __init__(self):
        self._pending: Dict[int, Tuple[WalkBatch, np.ndarray]] = {}
        self._heap: list = []

    def __len__(self) -> int:
        return len(self._pending)

    def __contains__(self, i: int) -> bool:
        return int(i) in self._pending

    def get(self, i: int) -> Optional[Tuple[WalkBatch, np.ndarray]]:
        return self._pending.get(int(i))

    def add(self, i: int, batch: WalkBatch, wid: np.ndarray) -> None:
        """Add walks to bucket ``i``, merging after any already queued (the
        subset-reuse invariant: buckets only grow)."""
        i = int(i)
        if i in self._pending:
            pb, pw = self._pending[i]
            self._pending[i] = (WalkBatch.concat([pb, batch]), np.concatenate([pw, wid]))
        else:
            self._pending[i] = (batch, wid)
            heapq.heappush(self._heap, i)

    def pop(self) -> Optional[Tuple[int, WalkBatch, np.ndarray]]:
        """Take the smallest pending bucket, or None when the slot is done."""
        while self._heap:
            i = heapq.heappop(self._heap)
            entry = self._pending.pop(i, None)
            if entry is not None:
                return i, entry[0], entry[1]
        return None

    def peek(self) -> Optional[int]:
        """The bucket id :meth:`pop` would return next (prefetch target)."""
        while self._heap and self._heap[0] not in self._pending:
            heapq.heappop(self._heap)
        return self._heap[0] if self._heap else None


class BucketPipeline:
    """Drives slot preloads and bucket-view prefetches for one engine run.

    With ``enabled=True`` the pool must be sequenced — an
    :class:`repro.io.AsyncWalkPool` or its sharded generalisation
    :class:`repro.io.ShardedWalkPool` — and :meth:`preload_slot` starts the
    next slot's drain + split on the writer owning that slot's shard (a
    sharded pool routes ``drain_async`` to the owning shard's FIFO, so
    drains for different blocks overlap each other too); with
    ``enabled=False`` every pool operation runs synchronously on the calling
    thread — the serial reference mode, bit-identical by construction.

    :meth:`acquire_slot` accounts the overlap: a slot served from a preload
    adds its spilled walk bytes to ``IOStats.overlapped_load_bytes``; a slot
    with no preload in flight (serial mode, the first slot of a run, a
    mispredicted next slot) counts into ``IOStats.pipeline_stall_slots``.
    Both are deterministic — they depend on the enqueue order, not on thread
    timing.
    """

    def __init__(
        self,
        *,
        pool,
        blocks: BlockStore,
        block_starts: np.ndarray,
        stats: IOStats,
        plan: TimeSlotPlan,
        enabled: bool = True,
    ):
        if enabled and not isinstance(pool, SEQUENCED_POOLS):
            raise ValueError(
                "async BucketPipeline needs a sequenced pool (AsyncWalkPool or ShardedWalkPool)"
            )
        self.pool = pool
        self.blocks = blocks
        self.block_starts = np.asarray(block_starts)
        self.stats = stats
        self.plan = plan
        self.enabled = enabled
        self.order = plan.order
        self._preloads: Dict[int, Future] = {}

    # -- slot state -----------------------------------------------------------
    def slot_has_walks(self, b: int) -> bool:
        """Live check the runner uses to decide whether slot ``b`` executes:
        walks in the pool *or* already handed to a preload.  Matches the
        serial ``pool.counts[b] > 0`` check exactly (eager counts + preload
        membership partition the same walks)."""
        return b in self._preloads or self.pool.counts[b] > 0

    def plan_next(self, b: int) -> Optional[int]:
        """The slot the plan schedules after ``b`` (wrapping into the next
        superstep), or None when nothing else is pending."""
        return self.plan.next_slot(b, self.slot_has_walks)

    # -- stage A: next-slot pool drain + bucket split ---------------------------
    def preload_slot(self, b: Optional[int]) -> None:
        """Start slot ``b``'s pool drain (+ bucket split, order 2) on the
        writer thread and its current-block view build on the prefetch
        thread, overlapping the current slot's advance."""
        if b is None or b in self._preloads or self.pool.counts[b] <= 0:
            return
        if not self.enabled:
            if self.order == 1:
                # the serial first-order engine already prefetched the next
                # current block (iteration scheduling); preserve that
                self.blocks.schedule([("full", b)])
            return
        transform = self._split_transform(b) if self.order == 2 else None
        self._preloads[b] = self.pool.drain_async(b, transform)
        self.blocks.schedule([("full", b)])

    def _split_transform(self, b: int):
        starts = self.block_starts

        def split(batch: WalkBatch, wid: np.ndarray):
            return split_into_buckets(starts, batch, b, wid)

        return split

    def acquire_slot(self, b: int):
        """Slot ``b``'s walks in exact serial push order: the preloaded
        prefix (if any) plus the post-preload remainder.  Returns a
        :class:`BucketCursor` for second-order slots, a ``(batch, wid)``
        pair for first-order ones."""
        fut = self._preloads.pop(b, None)
        if fut is None:
            self.stats.note_stall_slot()
            batch, wid = self.pool.load(b)
            return self._package(b, batch, wid, pre=None)
        payload, _n_walks, n_spilled = fut.result()
        self.stats.note_overlapped(n_spilled * WALK_BYTES)
        if self.pool.counts[b] > 0:  # pushed after the preload point
            batch, wid = self.pool.load(b)
        else:
            batch, wid = WalkBatch.empty(), np.zeros(0, np.int64)
        return self._package(b, batch, wid, pre=payload)

    def _package(self, b: int, batch: WalkBatch, wid: np.ndarray, pre):
        if self.order == 1:
            if pre is not None:
                pb, pw = pre
                batch = WalkBatch.concat([pb, batch])
                wid = np.concatenate([pw, wid])
            return batch, wid
        cursor = BucketCursor()
        if pre is not None:
            for i, (bb, ww) in pre.items():
                cursor.add(i, bb, ww)
        if len(batch):
            for i, (bb, ww) in split_into_buckets(self.block_starts, batch, b, wid).items():
                cursor.add(i, bb, ww)
        return cursor

    # -- teardown ---------------------------------------------------------------
    def finish(self) -> None:
        """End-of-run drain: waits out the writer queue so a persist-worker
        failure surfaces from ``run()`` even when the final slot never
        touched the pool again."""
        self._preloads.clear()
        if isinstance(self.pool, SEQUENCED_POOLS):
            self.pool.barrier()
