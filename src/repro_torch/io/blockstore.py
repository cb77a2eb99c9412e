"""Block store — resident-view cache + background prefetch over a graph
backend (the in-RAM :class:`~repro.core.graph.BlockedGraph` or the
file-backed :class:`~repro.io.blockfile.DiskBlockedGraph`).

The store's currency is the :class:`~repro.core.graph.BlockView`: engines
ask for *full* views (the whole block) or *partial* views (a compacted CSR
over exactly the activated vertices of a bucket).  The triangular schedule
(§4.2) makes the *next* ancillary bucket known before the current one
finishes executing, so either kind of load can overlap the jitted
``advance_pair`` call:

* an LRU cache of materialised :class:`~repro.core.graph.ResidentBlock`\\ s
  (bounded, unlike the unbounded page-cache model inside ``BlockedGraph``);
* one pending partial view per block: a bucket only ever *gains* walks
  between the prefetch and its execution (Alg. 2 extension), so a
  prefetched partial view is a subset of the set eventually requested —
  :meth:`partial_view` serves it as a base and gathers only the missing
  rows, and discards it if it is not a subset (a stale prediction).  The
  served view always holds *exactly* the requested activated set, so
  prefetching can never change what executes;
* a one-worker background prefetcher: :meth:`prefetch` /
  :meth:`prefetch_partial` start materialising on a thread; a later
  :meth:`get` / :meth:`partial_view` joins the in-flight future instead of
  materialising on the critical path.  This is the seam the async bucket
  pipeline grows from.

Accounting is unchanged from the seed engines: every :meth:`get` with
``charge=True`` charges exactly one ``block_load``; partial views are never
charged here (the engine charges the on-demand transfer deterministically).
Prefetching never charges, so the deterministic I/O counts (the paper's
tables) are identical with prefetch on or off.  Prefetch wins show up as
real wall-clock overlap, counted in :attr:`prefetch_hits` /
:attr:`partial_prefetch_hits`.

**Hot-set policy** (serving layer; ROADMAP "walk-query serving").  The
query-serving front end (:mod:`repro.serve`) observes which blocks its
query sources land in and :meth:`pin`\\ s the high-traffic ones.  A pinned
block is materialised (and charged) once, then held *resident outside the
LRU* — eviction only ever governs the cold tail — and every later charged
:meth:`get` is served from the pinned copy **without** a ``block_load``
charge: the block genuinely never re-crosses the slow/fast boundary, which
is the whole point of serving hot traffic from memory (§4.2's bucket
economics turned into a latency story; ThunderRW's in-memory regime on the
hot set, graceful degradation to disk on the cold tail).  The skipped
charges are metered as deterministic gauges (``IOStats.pinned_block_hits``
/ ``pinned_bytes_saved``; ``hot_pinned_blocks`` tracks the policy state) —
pinned membership and the access sequence are program-order pure, so the
savings are exactly reproducible.  Batch engines pin nothing, so their
accounting (the paper's tables) is untouched.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from repro_torch.core.graph import BlockView, ResidentBlock
from repro_torch.core.stats import IOStats
from repro_torch.io.ioplan import model_ondemand_io

__all__ = ["BlockStore"]


class BlockStore:
    """Metered, cached, prefetching access to a graph backend's block views.

    ``bg`` is anything exposing ``materialize_block(b) -> ResidentBlock``
    and ``partial_view(b, vertices) -> BlockView`` plus the blocked-graph
    metadata surface — for the file-backed
    :class:`~repro.io.blockfile.DiskBlockedGraph` the LRU + prefetch thread
    here is what hides real file reads from the critical path.
    """

    def __init__(
        self,
        bg,
        stats: IOStats,
        *,
        capacity: int = 4,
        enable_prefetch: bool = True,
    ):
        if capacity < 2:
            raise ValueError("BlockStore needs capacity >= 2 (a resident pair)")
        self.bg = bg
        self.stats = stats
        self.capacity = capacity
        self.enable_prefetch = enable_prefetch
        self._cache: "OrderedDict[int, ResidentBlock]" = OrderedDict()
        # hot set: block id -> resident copy (None until first touch);
        # pinned blocks live outside the LRU and are exempt from eviction
        self._pinned: "OrderedDict[int, Optional[ResidentBlock]]" = OrderedDict()
        self._futures: Dict[int, Future] = {}
        # one pending partial-view build per block (consumed by partial_view)
        self._pfutures: Dict[int, Future] = {}
        self._lock = threading.Lock()
        self._mat_lock = threading.Lock()  # serialises backend reads
        self._executor: Optional[ThreadPoolExecutor] = None
        self.prefetch_issued = 0
        self.prefetch_hits = 0
        self.cache_hits = 0
        self.demand_loads = 0
        self.partial_prefetch_issued = 0
        self.partial_prefetch_hits = 0
        self.partial_builds = 0
        self.pinned_hits = 0

    # -- internals ------------------------------------------------------------
    def _materialize(self, b: int) -> ResidentBlock:
        with self._mat_lock:
            return self.bg.materialize_block(b)

    def _build_partial(self, b: int, vertices: np.ndarray) -> BlockView:
        with self._mat_lock:
            return self.bg.partial_view(b, vertices)

    def _note_ondemand_plan(self, vertices: np.ndarray) -> None:
        """Meter the read planner's gauges for an on-demand request over
        ``vertices`` — the *modelled* syscall/range/waste counts from
        :func:`repro.io.ioplan.model_ondemand_io`, charged in program order
        on the engine thread.  Like every deterministic charge, the gauge
        covers the full requested set whether or not a prefetched base
        served part of it, so the values are identical across prefetch /
        async / backend configurations (and equal the real
        ``DiskBlockedGraph`` counters when prefetch is off)."""
        gap = int(getattr(self.bg, "io_coalesce_gap", 0))
        syscalls, ranges, waste = model_ondemand_io(self.bg, vertices, gap)
        if syscalls or ranges or waste:
            self.stats.note_ondemand_plan(syscalls, ranges, waste)

    def _insert(self, b: int, blk: ResidentBlock) -> None:
        with self._lock:
            self._cache[b] = blk
            self._cache.move_to_end(b)
            while len(self._cache) > self.capacity:
                self._cache.popitem(last=False)

    def _submit(self, fn, *args) -> Future:
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1,
                thread_name_prefix="blockstore-prefetch",
            )
        return self._executor.submit(fn, *args)

    # -- the engine-facing API -------------------------------------------------
    def schedule(self, ops) -> None:
        """Schedule a batch of prefetches from a pipeline plan.

        ``ops`` is an iterable of ``("full", b)`` / ``("partial", b,
        vertices)`` tuples — the :class:`repro.engines.pipeline
        .BucketPipeline` derives them from the
        :class:`~repro.core.scheduler.TimeSlotPlan` (next slot's current
        block, next bucket's ancillary view) instead of issuing one-off
        calls.  Same-slot partial requests against one block are batched:
        their vertex sets union into a single prefetched build, so the read
        planner sees one plan per block instead of one per request.  Never
        charges; a no-op when prefetch is disabled.
        """
        partials: Dict[int, list] = {}
        for op in ops:
            if op[0] == "full":
                self.prefetch(op[1])
            elif op[0] == "partial":
                partials.setdefault(int(op[1]), []).append(
                    np.asarray(op[2], dtype=np.int64)
                )
            else:
                raise ValueError(f"unknown prefetch op {op[0]!r}; have full, partial")
        for b, sets in partials.items():
            vs = sets[0] if len(sets) == 1 else np.unique(np.concatenate(sets))
            self.prefetch_partial(b, vs)

    # -- hot-set policy (serving layer) ----------------------------------------
    def pin(self, blocks) -> None:
        """Pin ``blocks`` into the hot set.  A pinned block is charged one
        ``block_load`` on first touch, then held resident outside the LRU;
        later charged :meth:`get`\\ s skip the charge and meter the saving
        (``IOStats.pinned_block_hits`` / ``pinned_bytes_saved``).  Already
        pinned ids (and their resident copies) are kept."""
        with self._lock:
            for b in blocks:
                b = int(b)
                if b not in self._pinned:
                    # promote an LRU-resident copy instead of re-reading it
                    self._pinned[b] = self._cache.pop(b, None)
            self.stats.note_hot_set(len(self._pinned))

    def unpin(self, blocks) -> None:
        """Release ``blocks`` from the hot set; they rejoin the cold tail
        (their resident copies re-enter the LRU and compete for capacity
        again, and every later charged :meth:`get` pays ``block_load``)."""
        with self._lock:
            for b in blocks:
                blk = self._pinned.pop(int(b), None)
                if blk is not None:
                    self._cache[int(b)] = blk
                    self._cache.move_to_end(int(b))
            while len(self._cache) > self.capacity:
                self._cache.popitem(last=False)
            self.stats.note_hot_set(len(self._pinned))

    def set_pinned(self, blocks) -> None:
        """Replace the hot set: pin the new ids, release the dropped ones.
        The serving layer calls this at every admission batch with the
        policy's current top-traffic blocks."""
        want = {int(b) for b in blocks}
        self.unpin([b for b in list(self._pinned) if b not in want])
        self.pin(sorted(want))

    def pinned(self) -> frozenset:
        """The hot set's block ids."""
        with self._lock:
            return frozenset(self._pinned)

    def prefetch(self, b: int) -> None:
        """Start materialising block ``b`` in the background (no charge)."""
        if not self.enable_prefetch:
            return
        b = int(b)
        with self._lock:
            if b in self._cache or b in self._futures:
                return
            if self._pinned.get(b) is not None:
                return  # pinned resident: nothing to build
            self._futures[b] = self._submit(self._materialize, b)
            self.prefetch_issued += 1

    def prefetch_partial(self, b: int, vertices: np.ndarray) -> None:
        """Start building the partial view of block ``b`` over ``vertices``
        in the background (no charge).  A later :meth:`partial_view` call
        uses it as a base when its set is a subset of the request (buckets
        only grow between prefetch and execution) and gathers the missing
        rows; otherwise it is discarded."""
        if not self.enable_prefetch:
            return
        b = int(b)
        with self._lock:
            # always replace the pending prediction: an unconsumed one is
            # stale (its bucket chose a full load after all), and keeping an
            # in-flight one only when it is still running would make which
            # prediction partial_view sees — and the overlapped_load_bytes
            # it counts — depend on prefetch-thread timing.  The superseded
            # build finishes in the background and is dropped.
            self._pfutures[b] = self._submit(self._build_partial, b, np.asarray(vertices))
            self.partial_prefetch_issued += 1

    def get(self, b: int, *, sequential: bool = True, charge: bool = True) -> ResidentBlock:
        """Resident block ``b``; charges one ``block_load`` unless ``charge=False``.

        The charge models the paper's deterministic accounting (the page
        cache is bypassed), so cache/prefetch hits still pay the modelled
        I/O — they only skip the host-side materialisation latency.  The
        one exception is the **hot set**: a :meth:`pin`\\ ned block is
        charged on first touch only; later charged gets are served from the
        pinned copy with the avoided charge metered as a deterministic
        saving (the serving layer's whole point).
        """
        b = int(b)
        with self._lock:
            pinned = b in self._pinned
            blk = self._pinned.get(b) if pinned else self._cache.get(b)
            fut = self._futures.pop(b, None)
        if pinned:
            if blk is not None:
                self.pinned_hits += 1
                if charge:
                    self.stats.note_pinned_hit(blk.nbytes_full())
                return blk
            # first touch: materialise (joining any in-flight prefetch),
            # pay the normal block_load charge, and keep the copy pinned
            if fut is not None:
                blk = fut.result()
                self.prefetch_hits += 1
                self.stats.note_overlapped(blk.nbytes_full())
            else:
                blk = self._materialize(b)
                self.demand_loads += 1
            with self._lock:
                if b in self._pinned:
                    self._pinned[b] = blk
                else:  # unpinned while materialising: fall back to the LRU
                    self._insert(b, blk)
            if charge:
                self.stats.block_load(b, blk.nbytes_full(), sequential=sequential)
            return blk
        if fut is not None:
            blk = fut.result()
            self.prefetch_hits += 1
            # the materialisation ran off the critical path — measure the win
            self.stats.note_overlapped(blk.nbytes_full())
        elif blk is not None:
            self.cache_hits += 1
        else:
            blk = self._materialize(b)
            self.demand_loads += 1
        self._insert(b, blk)
        if charge:
            self.stats.block_load(b, blk.nbytes_full(), sequential=sequential)
        return blk

    def get_view(self, b: int, *, sequential: bool = True, charge: bool = True) -> BlockView:
        """Full :class:`BlockView` of block ``b`` (same charging as
        :meth:`get`)."""
        return BlockView.from_resident(self.get(b, sequential=sequential, charge=charge))

    def partial_view(self, b: int, vertices: np.ndarray) -> BlockView:
        """Activated view of block ``b`` over exactly the unique
        ``vertices``.

        Never charges — the *engine* charges the on-demand transfer
        (``IOStats.ondemand_load``) deterministically, whether or not the
        view was prefetched.  A pending prefetched view whose vertex set is
        a subset of the request becomes the base; only the missing rows are
        gathered.  The returned view holds *exactly* the requested set
        either way, so prefetching never changes what executes.
        """
        b = int(b)
        vs = np.unique(np.asarray(vertices, dtype=np.int64))
        # gauge the plan over the full requested set (prefetch-invariant)
        self._note_ondemand_plan(vs)
        base = None
        with self._lock:
            fut = self._pfutures.pop(b, None)
        if fut is not None:
            base = fut.result()
        if base is not None:
            in_req = np.isin(base.vids, vs)
            if in_req.all():
                self.partial_prefetch_hits += 1
                self.stats.note_overlapped(self.bg.activated_load_bytes(base.vids))
                missing = vs[~base.has_vertices(vs)]
                if missing.size:
                    base = self._extend(base, missing)
                return base
        view = self._build_partial(b, vs)
        self.partial_builds += 1
        return view

    def _extend(self, view: BlockView, vertices: np.ndarray) -> BlockView:
        extra = self._build_partial(view.block_id, vertices)
        return view.extended(extra)

    def extend_view(self, view: BlockView, vertices: np.ndarray) -> BlockView:
        """Mid-advance extension gather: append the rows of ``vertices`` to
        an activated ``view`` (never charges bytes; the engine accounts the
        gather as on-demand vertex I/O).  Meters the read-planner gauges
        for the gathered set."""
        self._note_ondemand_plan(np.asarray(vertices, dtype=np.int64))
        return self._extend(view, vertices)

    def gather_view(self, vertices: np.ndarray) -> BlockView:
        """Cross-block activated view over arbitrary vertices (never
        charges bytes; the engine accounts the per-vertex fetches).  Meters
        the read-planner gauges for the gathered set."""
        self._note_ondemand_plan(np.asarray(vertices, dtype=np.int64))
        with self._mat_lock:
            return self.bg.gather_view(vertices)

    def counters(self) -> dict:
        return {
            "prefetch_issued": self.prefetch_issued,
            "prefetch_hits": self.prefetch_hits,
            "cache_hits": self.cache_hits,
            "demand_loads": self.demand_loads,
            "partial_prefetch_issued": self.partial_prefetch_issued,
            "partial_prefetch_hits": self.partial_prefetch_hits,
            "partial_builds": self.partial_builds,
            "pinned_blocks": len(self._pinned),
            "pinned_hits": self.pinned_hits,
        }

    def close(self) -> None:
        with self._lock:
            futures = list(self._futures.values()) + list(self._pfutures.values())
            self._futures = {}
            self._pfutures = {}
            self._pinned = OrderedDict()
            executor, self._executor = self._executor, None
        for fut in futures:
            fut.cancel()
        if executor is not None:
            executor.shutdown(wait=True)
