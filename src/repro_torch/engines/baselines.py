"""Baseline out-of-core engines from the paper's evaluation (§7).

* :class:`PlainBucketEngine` — the PB baseline of §7.3 (buckets, two block
  slots, but traditional walk storage, state-aware current scheduling and a
  0..N_B-1 ancillary sweep).
* :class:`SOGWEngine` — Second-Order GraphWalker (§7.1): one current block,
  per-walk random vertex I/O for the previous vertex's adjacency; with
  ``static_cache`` it becomes SGSC (static top-degree vertex cache).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import BlockedGraph, block_of
from repro_torch.core.scheduler import make_scheduler
from repro_torch.core.stats import SSD, DevicePreset
from repro_torch.core.transition import WalkTask
from repro_torch.core.walk import WalkBatch

from .base import EngineBase, WalkResult

__all__ = ["PlainBucketEngine", "SOGWEngine"]


class PlainBucketEngine(EngineBase):
    """§7.3 baseline: traditional walk storage (B(cur)), state-aware current
    scheduling (GraphWalker's max-sum), ancillary sweep b0..b_{N_B-1}."""

    def __init__(
        self,
        bg: BlockedGraph,
        task: WalkTask,
        *,
        preset: DevicePreset = SSD,
        record_walks: bool = False,
        **kw,
    ):
        super().__init__(bg, task, preset=preset, record_walks=record_walks, **kw)
        self.scheduler = make_scheduler("max_sum", bg.num_blocks, self.seed)

    def _persist(self, batch: WalkBatch, wid: np.ndarray) -> None:
        if len(batch) == 0:
            return
        assoc = block_of(self.bg.block_starts, batch.cur)
        for b in np.unique(assoc):
            m = assoc == b
            self.pool.push(int(b), batch.select(m), wid[m])

    def _run(self) -> WalkResult:
        self._initialize()
        guard = 0
        while self.unfinished > 0:
            guard += 1
            if guard > self.task.length * self.bg.num_blocks * 4 + 10:
                raise RuntimeError("engine failed to converge (bug)")
            b = self.scheduler.next_block(self.pool.counts, self.pool.min_hop)
            if b is None:
                break
            batch, wid = self.pool.load(b)
            if len(batch) == 0:
                continue
            self.stats.time_slots += 1
            self.stats.supersteps += 1
            # state-aware scheduling jumps around: current block load is a
            # random block I/O (the paper's point about sequential wins)
            self.pair.set_slot(0, self.blocks.get_view(b, sequential=False))
            # walks live with B(cur); bucket key = B(prev) (plain bucketing)
            pre_blk = block_of(self.bg.block_starts, batch.prev)
            for i in range(self.bg.num_blocks):
                m = pre_blk == i
                if not m.any():
                    continue
                bucket, bwid = batch.select(m), wid[m]
                self.stats.bucket_executions += 1
                # the linear sweep makes the next ancillary block predictable
                nxt = next(
                    (j for j in range(i + 1, self.bg.num_blocks) if (pre_blk == j).any()),
                    None,
                )
                if nxt is not None:
                    self.blocks.prefetch(nxt)
                seq = i == b + 1  # only the successor read is sequential
                self.pair.set_slot(1, self.blocks.get_view(i, sequential=seq))
                bucket, alive = self._advance(bucket, bwid)
                bucket, bwid = self._retire(bucket, bwid, alive)
                self._persist(bucket, bwid)
        return self.result()


class SOGWEngine(EngineBase):
    """Second-order GraphWalker: one current block; every walk whose stored
    previous vertex lies outside it pays a random vertex I/O (the paper's
    Fig. 1a bottleneck).  ``static_cache=True`` adds SGSC's top-degree cache
    sized to one block's edge budget."""

    def __init__(
        self,
        bg: BlockedGraph,
        task: WalkTask,
        *,
        static_cache: bool = False,
        preset: DevicePreset = SSD,
        record_walks: bool = False,
        **kw,
    ):
        super().__init__(bg, task, preset=preset, record_walks=record_walks, **kw)
        self.scheduler = make_scheduler("max_sum", bg.num_blocks, self.seed)
        self.cached = np.zeros(bg.num_vertices, bool)
        if static_cache:
            deg = bg.degrees.astype(np.int64)
            order = np.argsort(-deg)
            budget = int(bg.block_nedges.max())
            csum = np.cumsum(deg[order])
            k = int(np.searchsorted(csum, budget, side="right"))
            top = order[: max(k, 1)]
            self.cached[top] = True
            # cache initialisation is I/O (the paper charges it to I/O time)
            self.stats.vertex_load(top.size, int(8 * top.size + 4 * deg[top].sum()))

    def _persist(self, batch: WalkBatch, wid: np.ndarray) -> None:
        if len(batch) == 0:
            return
        assoc = block_of(self.bg.block_starts, batch.cur)
        for b in np.unique(assoc):
            m = assoc == b
            self.pool.push(int(b), batch.select(m), wid[m])

    def _run(self) -> WalkResult:
        self._initialize()
        guard = 0
        while self.unfinished > 0:
            guard += 1
            if guard > self.task.length * self.bg.num_blocks * 4 + 10:
                raise RuntimeError("engine failed to converge (bug)")
            b = self.scheduler.next_block(self.pool.counts, self.pool.min_hop)
            if b is None:
                break
            batch, wid = self.pool.load(b)
            if len(batch) == 0:
                continue
            self.stats.time_slots += 1
            self.stats.supersteps += 1
            view_b = self.blocks.get_view(b, sequential=False)
            # vertex I/Os: SECOND-order walks must fetch the stored previous
            # vertex's adjacency when it lies outside the current block
            # (first-order models never touch prev — paper Fig. 1a)
            pre_blk = block_of(self.bg.block_starts, batch.prev)
            outside = (
                (pre_blk != b) & (batch.hop > 0)
                if self.order == 2
                else np.zeros(len(batch), bool)
            )
            needs_io = outside & ~self.cached[batch.prev]
            if needs_io.any():
                vs = batch.prev[needs_io]
                deg = self.bg.degrees[vs].astype(np.int64)
                # per-walk light I/O — SOGW does not dedupe across walks
                self.stats.vertex_load(int(needs_io.sum()), int(8 * needs_io.sum() + 4 * deg.sum()))
            # the fetched (or cached) out-of-block prev adjacencies become a
            # gathered view in slot 1, so the rejection test probes the true
            # rows the engine just paid for — the walks are exactly the
            # oracle's, not an approximation
            self.pair.set_slot(0, view_b)
            if outside.any():
                self.pair.set_slot(1, self.blocks.gather_view(np.unique(batch.prev[outside])))
            else:
                self.pair.set_slot(1, view_b)
            batch, alive = self._advance(batch, wid)
            batch, wid = self._retire(batch, wid, alive)
            self._persist(batch, wid)
        return self.result()
