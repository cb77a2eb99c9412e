"""GraSorw: the bi-block engine (the paper's system).

Triangular bi-block scheduling (§4.2), skewed walk storage + bucket
management (§4.3), bucket-extending (Alg. 2), learning-based block loading
(§5).  Block *views* come in through the :class:`repro.io.BlockStore`: a
full-load decision materialises the whole ancillary block, an on-demand
decision builds a compacted *activated* :class:`~repro.core.graph.BlockView`
over only the bucket's prev/cur vertices — and execution runs on that view,
so the device footprint of an on-demand bucket is ``O(activated vertices)``
(``IOStats.peak_resident_bytes`` is the gauge).  Walks that reach a
non-activated vertex mid-advance pause; their rows are gathered and
*appended* to the view (never a re-materialisation) and the advance
resumes.

Since the staged pipeline refactor the run is organised by a
:class:`~repro.core.scheduler.TimeSlotPlan` and a
:class:`~repro.engines.pipeline.BucketPipeline`: while one bucket advances
on the device, the walk-pool writer thread applies persists and drains +
splits the *next* slot's pool, and the block-store prefetch thread builds
the next slot's current view and the next bucket's ancillary view.  With
``async_pipeline=False`` (the serial reference mode) every stage runs
inline; the counter-based per-walk RNG makes the two modes bit-identical.

The engine is also the execution tier of the query-serving front end
(:mod:`repro.serve`): an admission batch of point queries becomes one run
with its concatenated walk sources injected via ``initial_walks``, a
shared ``block_store`` (hot-set pinned) + ``stats``, and an ``on_retire``
hook attributing each terminating walk's endpoint back to its query — all
:class:`~repro.engines.base.EngineBase` seams, so serving rides the exact
triangular sweep (and bit-exact walks) of a batch run.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.buckets import push_by_block_assignment
from repro_torch.core.graph import BlockedGraph, BlockView, block_of
from repro_torch.core.loader import BlockLoadingModel
from repro_torch.core.scheduler import TimeSlotPlan
from repro_torch.core.stats import SSD, DevicePreset
from repro_torch.core.transition import WalkTask
from repro_torch.core.walk import WalkBatch

from .base import EngineBase, WalkResult
from .pipeline import BucketCursor, BucketPipeline

__all__ = ["BiBlockEngine"]


class BiBlockEngine(EngineBase):
    """Triangular bi-block scheduling + skewed storage + buckets + LBL."""

    def __init__(
        self,
        bg: BlockedGraph,
        task: WalkTask,
        *,
        loading: str = "auto",
        bucket_extending: bool = True,
        preset: DevicePreset = SSD,
        record_walks: bool = False,
        async_pipeline: bool = True,
        writer_queue: int = 64,
        **kw,
    ):
        super().__init__(
            bg,
            task,
            preset=preset,
            record_walks=record_walks,
            async_pipeline=async_pipeline,
            writer_queue=writer_queue,
            **kw,
        )
        self.loader = BlockLoadingModel(bg.num_blocks, mode=loading)
        self.bucket_extending = bucket_extending

    # skewed storage: persist with min(B(u), B(v)); first-order models never
    # read prev, so they use the traditional B(cur) association (§7.8)
    def _persist(self, batch: WalkBatch, wid: np.ndarray) -> None:
        push_by_block_assignment(self.pool, self.bg.block_starts, self.order, batch, wid)

    #: modelled in-memory cost per sampled step (feeds the LR exec component)
    STEP_COST = 2.0e-8

    @staticmethod
    def _bucket_activated(bucket: WalkBatch, s: int, e: int) -> np.ndarray:
        """Activated vertices of a bucket within block range [s, e)."""
        act = np.concatenate([bucket.prev, bucket.cur])
        return act[(act >= s) & (act < e)]

    def _load_ancillary(
        self,
        i: int,
        n_bucket_walks: int,
        activated: np.ndarray,
    ) -> Tuple[str, float, float, BlockView]:
        """Load block ``i`` with the learned method; meter; return
        (decision, eta, load_cost, view) — execution cost is added before
        feeding the model (the paper's t_f / t_o cover loading *and*
        executing, §5.2.1)."""
        nv = int(self.bg.block_nverts[i])
        decision = self.loader.choose(i, n_bucket_walks, nv)
        eta = n_bucket_walks / max(nv, 1)
        if decision == "full":
            nbytes = 4 * (nv + 1) + 4 * int(self.bg.block_nedges[i])
            cost = self.stats.preset.seq_cost(nbytes)
            view = self.blocks.get_view(i, sequential=True)
        else:
            gap = int(getattr(self.bg, "io_coalesce_gap", 0))
            sys0 = self.stats.ondemand_syscalls
            waste0 = self.stats.coalesce_waste_bytes
            view = self.blocks.partial_view(i, activated)
            nbytes = self.bg.activated_load_bytes(activated)
            n_act = view.nverts
            # with the planner on, cost follows the coalesced ranges the
            # store just gauged, not the raw vertex count (per-seek term)
            seeks = self.stats.ondemand_syscalls - sys0 if gap > 0 else None
            waste = self.stats.coalesce_waste_bytes - waste0 if gap > 0 else 0
            cost = self.loader.ondemand_cost(
                self.stats.preset, n_act, nbytes, seeks=seeks, waste_bytes=waste
            )
            self.stats.ondemand_load(n_act, nbytes, seeks=seeks, waste_bytes=waste)
        return decision, eta, cost, view

    def _schedule_bucket_view(self, i: int, bucket: WalkBatch) -> None:
        """Overlap the next bucket's view build with this bucket's advance.
        The tentative decision mirrors :meth:`_load_ancillary`'s (``choose``
        is pure); a mismatch — or a bucket grown by Alg. 2 extension in the
        meantime — just misses the prefetch cache and builds synchronously.
        """
        nv = int(self.bg.block_nverts[i])
        if self.loader.choose(i, len(bucket), nv) == "full":
            self.blocks.schedule([("full", i)])
        else:
            s, e = self.bg.block_starts[i], self.bg.block_starts[i + 1]
            self.blocks.schedule([("partial", i, self._bucket_activated(bucket, s, e))])

    def _advance_on_view(
        self,
        i: int,
        bucket: WalkBatch,
        bwid: np.ndarray,
        view: BlockView,
        decision: str,
    ) -> Tuple[WalkBatch, np.ndarray, float]:
        """Advance the bucket on the resident pair until every walk left it
        or terminated.  On an activated view, walks that reach a
        non-activated vertex of block ``i`` pause mid-advance; their rows
        are gathered (on-demand vertex I/O), *appended* to the view, and
        the advance resumes — the whole block is never materialised.
        Returns (batch, alive, extension_cost)."""
        cost = 0.0
        batch, alive = self._advance(bucket, bwid)
        if decision != "ondemand":
            return batch, alive, cost
        s, e = self.bg.block_starts[i], self.bg.block_starts[i + 1]
        while True:
            stuck = alive & (batch.cur >= s) & (batch.cur < e)
            if not stuck.any():
                break
            pending = np.unique(batch.cur[stuck])
            ext = pending[~view.has_vertices(pending)]
            if ext.size == 0:
                break
            nbytes = self.bg.activated_load_bytes(ext)
            gap = int(getattr(self.bg, "io_coalesce_gap", 0))
            sys0 = self.stats.ondemand_syscalls
            waste0 = self.stats.coalesce_waste_bytes
            # first-order buckets alias the same view in both slots — keep
            # the pair deduped so the extended rows are stored once
            both = self.pair.views[0] is self.pair.views[1]
            view = self.blocks.extend_view(view, ext)
            seeks = self.stats.ondemand_syscalls - sys0 if gap > 0 else None
            waste = self.stats.coalesce_waste_bytes - waste0 if gap > 0 else 0
            self.stats.ondemand_load(ext.size, nbytes, seeks=seeks, waste_bytes=waste)
            cost += self.loader.ondemand_cost(
                self.stats.preset, ext.size, nbytes, seeks=seeks, waste_bytes=waste
            )
            if both:
                self.pair.set_slot(0, view)
            self.pair.set_slot(1, view)
            batch, alive = self._advance(batch, bwid, alive)
        return batch, alive, cost

    def _run(self) -> WalkResult:
        """The staged slot loop, shared by first- and second-order tasks:
        the :class:`TimeSlotPlan` names the slots, the
        :class:`BucketPipeline` overlaps the next slot's pool drain + bucket
        split and the next views with the current advance (or runs
        everything inline when ``async_pipeline=False``)."""
        self._initialize()
        plan = TimeSlotPlan(self.bg.num_blocks, self.order)
        pipe = BucketPipeline(
            pool=self.pool,
            blocks=self.blocks,
            block_starts=self.bg.block_starts,
            stats=self.stats,
            plan=plan,
            enabled=self.async_pipeline,
        )
        guard = 0
        while self.unfinished > 0:
            guard += 1
            if guard > self.task.length * self.bg.num_blocks + 10:
                raise RuntimeError("engine failed to converge (bug)")
            self.stats.supersteps += 1
            for b in plan.slots():
                if not pipe.slot_has_walks(b):
                    continue
                self.stats.time_slots += 1
                if self.order == 1:
                    self._run_slot_first_order(b, pipe)
                else:
                    self._run_slot(b, pipe)
        pipe.finish()
        return self.result(loader_summary=self.loader.summary())

    def _run_slot(self, b: int, pipe: BucketPipeline) -> None:
        """One second-order time slot: current block ``b`` resident in slot
        0, ancillary buckets through the ordered cursor in slot 1."""
        cursor: BucketCursor = pipe.acquire_slot(b)
        pipe.preload_slot(pipe.plan_next(b))
        cur_view = self.blocks.get_view(b, sequential=True)
        self.pair.set_slot(0, cur_view)
        while True:
            item = cursor.pop()
            if item is None:
                break
            i, bucket, bwid = item
            # the schedule already knows the next ancillary bucket:
            # overlap its view build with this bucket's advance
            nxt = cursor.peek()
            if nxt is not None:
                self._schedule_bucket_view(nxt, cursor.get(nxt)[0])
            self.stats.bucket_executions += 1
            s, e = self.bg.block_starts[i], self.bg.block_starts[i + 1]
            activated = self._bucket_activated(bucket, s, e)
            decision, eta, cost, view = self._load_ancillary(i, len(bucket), activated)
            self.pair.set_slot(1, view)
            steps_before = self.stats.steps_sampled
            bucket, alive, ext_cost = self._advance_on_view(i, bucket, bwid, view, decision)
            cost += ext_cost
            cost += self.STEP_COST * (self.stats.steps_sampled - steps_before)
            self.loader.observe(i, eta, cost, decision)
            bucket, bwid = self._retire(bucket, bwid, alive)
            if len(bucket) == 0:
                continue
            # Alg. 2 routing
            pre_blk = block_of(self.bg.block_starts, bucket.prev)
            cur_blk = block_of(self.bg.block_starts, bucket.cur)
            extend = (
                (cur_blk > i) & (pre_blk == b)
                if self.bucket_extending
                else np.zeros(len(bucket), bool)
            )
            # persist the non-extending walks with min-rule
            self._persist(bucket.select(~extend), bwid[~extend])
            if extend.any():
                ext_batch = bucket.select(extend)
                ext_wid = bwid[extend]
                ext_blk = cur_blk[extend]
                for nb in np.unique(ext_blk):
                    m = ext_blk == nb
                    cursor.add(int(nb), ext_batch.select(m), ext_wid[m])

    def _run_slot_first_order(self, b: int, pipe: BucketPipeline) -> None:
        """§7.8: first-order walks need only the current block; iteration
        scheduling + the learning-based loader on the current block itself
        ("heavy block loads become light vertex I/Os once few walks remain").
        Both slots hold the *same* view — an on-demand slot is a compacted
        view over just the walks' current vertices."""
        batch, wid = pipe.acquire_slot(b)
        pipe.preload_slot(pipe.plan_next(b))
        self.stats.bucket_executions += 1
        decision, eta, cost, view = self._load_ancillary(b, len(batch), batch.cur)
        self.pair.set_slot(0, view)
        self.pair.set_slot(1, view)
        steps_before = self.stats.steps_sampled
        batch, alive, ext_cost = self._advance_on_view(b, batch, wid, view, decision)
        cost += ext_cost
        cost += self.STEP_COST * (self.stats.steps_sampled - steps_before)
        self.loader.observe(b, eta, cost, decision)
        batch, wid = self._retire(batch, wid, alive)
        self._persist(batch, wid)
