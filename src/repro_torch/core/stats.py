"""I/O accounting — the quantities in the paper's Tables 3/4/7.

Every transfer across the slow/fast boundary is metered here.  Costs are both
*counted* (number of block I/Os, vertex I/Os, bytes) and *modelled* in seconds
against a device preset, so benchmark results are deterministic on any host.
The presets expose the paper's regime (SSD: cheap sequential, ruinous random)
and the TPU regime the system targets (HBM / ICI), which share that shape.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import defaultdict

__all__ = ["DevicePreset", "SSD", "HBM_V5E", "ICI_V5E", "IOStats"]


@dataclasses.dataclass(frozen=True)
class DevicePreset:
    """Bandwidth/latency model of the slow tier."""

    name: str
    seq_bandwidth: float  # bytes/s for sequential block transfers
    rand_latency: float  # seconds per random I/O (seek / gather setup)
    rand_bandwidth: float  # bytes/s once a random transfer streams

    def seq_cost(self, nbytes: int) -> float:
        return self.rand_latency + nbytes / self.seq_bandwidth

    def rand_cost(self, n_ios: int, nbytes: int) -> float:
        return n_ios * self.rand_latency + nbytes / self.rand_bandwidth


# An NVMe SSD like the paper's testbed: ~2 GB/s sequential, ~80 us random.
SSD = DevicePreset("ssd", 2.0e9, 8.0e-5, 4.0e8)
# TPU v5e HBM (the slow tier vs VMEM): 819 GB/s, ~1 us "gather setup".
HBM_V5E = DevicePreset("hbm_v5e", 8.19e11, 1.0e-6, 8.19e10)
# TPU v5e ICI link (the slow tier vs local HBM at pod scale): 50 GB/s/link.
ICI_V5E = DevicePreset("ici_v5e", 5.0e10, 1.0e-6, 5.0e9)


class IOStats:
    """Counter bundle; mirrors the decomposition in the paper's Fig. 1(a)."""

    def __init__(self, preset: DevicePreset = SSD):
        self.preset = preset
        # walk_io is the one counter path hit from multiple writer threads
        # (one per pool shard); everything else stays single-producer
        self._walk_lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.block_ios = 0
        self.block_bytes = 0
        self.vertex_ios = 0
        self.vertex_bytes = 0
        self.walk_ios = 0
        self.walk_bytes = 0
        self.walk_bytes_written = 0
        self.walk_bytes_read = 0
        self.ondemand_ios = 0
        self.ondemand_bytes = 0
        self.ondemand_syscalls = 0
        self.coalesced_ranges = 0
        self.coalesce_waste_bytes = 0
        self.hot_pinned_blocks = 0
        self.pinned_block_hits = 0
        self.pinned_bytes_saved = 0
        self.peak_resident_bytes = 0
        self.overlapped_load_bytes = 0
        self.pipeline_stall_slots = 0
        self.writer_queue_peak = 0
        self.shard_spill_bytes: dict = {}
        self.shard_imbalance = 0.0
        self.time_slots = 0
        self.supersteps = 0
        self.steps_sampled = 0
        self.bucket_executions = 0
        self.sim_block_io_time = 0.0
        self.sim_vertex_io_time = 0.0
        self.sim_ondemand_io_time = 0.0
        self.exec_time = 0.0  # wall time inside walk updating
        self.wall_start = time.perf_counter()
        self.per_block_loads = defaultdict(int)

    # -- metering ------------------------------------------------------------
    def block_load(self, block_id: int, nbytes: int, *, sequential: bool) -> None:
        self.block_ios += 1
        self.block_bytes += nbytes
        self.per_block_loads[block_id] += 1
        if sequential:
            self.sim_block_io_time += self.preset.seq_cost(nbytes)
        else:
            self.sim_block_io_time += self.preset.rand_cost(1, nbytes)

    def vertex_load(self, n_vertices: int, nbytes: int) -> None:
        self.vertex_ios += n_vertices
        self.vertex_bytes += nbytes
        self.sim_vertex_io_time += self.preset.rand_cost(n_vertices, nbytes)

    def ondemand_load(
        self,
        n_vertices: int,
        nbytes: int,
        *,
        seeks: int | None = None,
        waste_bytes: int = 0,
    ) -> None:
        """Charge an on-demand gather: ``n_vertices`` vertex I/Os moving
        ``nbytes`` *useful* bytes.  With the gap-aware read planner on, the
        caller passes the observed ``seeks`` (coalesced ranges actually
        issued) and read-through ``waste_bytes``, and the modelled time pays
        one seek per range plus streaming over useful+wasted bytes — the
        loader's per-seek cost term.  ``seeks=None`` (planner off) keeps the
        bit-exact reference charge of one random I/O per vertex.  The
        ``ondemand_ios``/``ondemand_bytes`` counters always count vertices
        and useful bytes, so charged useful bytes never depend on the gap."""
        self.ondemand_ios += n_vertices
        self.ondemand_bytes += nbytes
        if seeks is None:
            self.sim_ondemand_io_time += self.preset.rand_cost(n_vertices, nbytes)
        else:
            p = self.preset
            self.sim_ondemand_io_time += seeks * p.rand_latency + (
                nbytes + waste_bytes
            ) / p.rand_bandwidth

    def note_ondemand_plan(self, syscalls: int, ranges: int, waste_bytes: int) -> None:
        """Gauges: what the on-demand read planner actually did.
        ``ondemand_syscalls`` counts every ``pread`` the on-demand path
        issues (4 tiny ones per vertex on the reference path, one large one
        per coalesced range with the planner on); ``coalesced_ranges``
        counts only planner-issued ranges; ``coalesce_waste_bytes`` is the
        read-through hole bytes those ranges carried beyond the useful
        extents.  Metered from the pure plan model on either graph backend,
        so the values are deterministic and backend-invariant."""
        self.ondemand_syscalls += int(syscalls)
        self.coalesced_ranges += int(ranges)
        self.coalesce_waste_bytes += int(waste_bytes)

    def note_hot_set(self, n_blocks: int) -> None:
        """Gauge: blocks currently pinned resident by the
        :class:`~repro.io.BlockStore` hot-set policy (serving layer).  Set
        at every (program-ordered) pinning decision, so the value reflects
        the final policy state, never thread timing."""
        self.hot_pinned_blocks = int(n_blocks)

    def note_pinned_hit(self, nbytes: int) -> None:
        """Counter: a charged ``get`` served from the pinned hot set.  The
        ``block_load`` charge is *skipped* — the block never re-crossed the
        slow/fast boundary — and the avoided bytes accumulate in
        ``pinned_bytes_saved``.  Deterministic: pinned membership and the
        access sequence are both program-order pure."""
        self.pinned_block_hits += 1
        self.pinned_bytes_saved += int(nbytes)

    def note_resident(self, nbytes: int) -> None:
        """Gauge: bytes of graph data resident in "memory" (the device view
        pair) right now.  ``peak_resident_bytes`` is the high-water mark —
        the footprint on-demand *execution* shrinks versus full loads."""
        self.peak_resident_bytes = max(self.peak_resident_bytes, int(nbytes))

    def note_overlapped(self, nbytes: int) -> None:
        """Counter: bytes whose load was *initiated off the critical path*
        by a background worker (block/partial-view prefetch thread,
        walk-pool writer preload) and later consumed by the engine.  The
        serial reference mode still reports its prefetch-thread hits here —
        it was never prefetch-free; the async pipeline's *additional*
        overlap is the delta against it (the ``pipeline_overlap`` bench
        asserts it is positive).  Never part of the deterministic I/O
        charges."""
        self.overlapped_load_bytes += int(nbytes)

    def note_stall_slot(self) -> None:
        """Counter: a time slot whose walk-pool load ran synchronously on
        the critical path (the pipeline had no preload in flight — serial
        mode, the first slot of a run, or a mispredicted next slot)."""
        self.pipeline_stall_slots += 1

    def note_writer_queue(self, depth: int) -> None:
        """Gauge: walk-pool writer queue depth; keeps the high-water mark."""
        self.writer_queue_peak = max(self.writer_queue_peak, int(depth))

    def note_shard_imbalance(self, value: float) -> None:
        """Gauge: max-over-mean ratio of walks pushed per pool shard.

        Updated at every (program-ordered) push, so the value — like the
        per-shard breakdown in ``shard_spill_bytes`` — is deterministic: it
        reflects how the keyspace hash distributed the final push totals,
        never thread timing."""
        self.shard_imbalance = float(value)

    def walk_io(
        self,
        n_walks: int,
        *,
        bytes_per_walk: int = 16,
        kind: str = "write",
        shard: int | None = None,
    ) -> None:
        """Walk pool flush/load: 128-bit encoded walks (paper §6.1).

        ``kind`` distinguishes spills (``"write"``) from pool loads
        (``"read"``) so ``walk_bytes_written`` can be checked against the
        bytes a :class:`repro.io.DiskWalkPool` actually put on disk.
        ``shard`` attributes a spill to one pool shard's writer
        (``shard_spill_bytes`` breakdown); shard writers run on their own
        threads, so the whole update is taken under one lock.
        """
        nbytes = n_walks * bytes_per_walk
        with self._walk_lock:
            self.walk_ios += 1
            self.walk_bytes += nbytes
            if kind == "write":
                self.walk_bytes_written += nbytes
                if shard is not None:
                    self.shard_spill_bytes[shard] = self.shard_spill_bytes.get(shard, 0) + nbytes
            else:
                self.walk_bytes_read += nbytes

    # -- summaries -------------------------------------------------------------
    @property
    def sim_walk_io_time(self) -> float:
        """Modelled walk-I/O seconds: ``walk_ios`` sequential transfers of
        ``walk_bytes`` total.  Derived from the order-independent integer
        counters instead of accumulated per call, so concurrent shard
        writers cannot perturb the float-summation order — the value is
        bit-deterministic at any shard count."""
        p = self.preset
        return self.walk_ios * p.rand_latency + self.walk_bytes / p.seq_bandwidth

    @property
    def sim_io_time(self) -> float:
        return (
            self.sim_block_io_time
            + self.sim_vertex_io_time
            + self.sim_ondemand_io_time
            + self.sim_walk_io_time
        )

    @property
    def sim_wall_time(self) -> float:
        return self.sim_io_time + self.exec_time

    def as_dict(self) -> dict:
        return {
            "block_ios": self.block_ios,
            "block_bytes": self.block_bytes,
            "vertex_ios": self.vertex_ios,
            "vertex_bytes": self.vertex_bytes,
            "ondemand_ios": self.ondemand_ios,
            "ondemand_bytes": self.ondemand_bytes,
            "ondemand_syscalls": self.ondemand_syscalls,
            "coalesced_ranges": self.coalesced_ranges,
            "coalesce_waste_bytes": self.coalesce_waste_bytes,
            "hot_pinned_blocks": self.hot_pinned_blocks,
            "pinned_block_hits": self.pinned_block_hits,
            "pinned_bytes_saved": self.pinned_bytes_saved,
            "walk_ios": self.walk_ios,
            "walk_bytes": self.walk_bytes,
            "walk_bytes_written": self.walk_bytes_written,
            "walk_bytes_read": self.walk_bytes_read,
            "peak_resident_bytes": self.peak_resident_bytes,
            "overlapped_load_bytes": self.overlapped_load_bytes,
            "pipeline_stall_slots": self.pipeline_stall_slots,
            "writer_queue_peak": self.writer_queue_peak,
            "shard_spill_bytes": dict(sorted(self.shard_spill_bytes.items())),
            "shard_imbalance": self.shard_imbalance,
            "time_slots": self.time_slots,
            "supersteps": self.supersteps,
            "steps_sampled": self.steps_sampled,
            "bucket_executions": self.bucket_executions,
            "sim_block_io_time": self.sim_block_io_time,
            "sim_vertex_io_time": self.sim_vertex_io_time,
            "sim_ondemand_io_time": self.sim_ondemand_io_time,
            "sim_walk_io_time": self.sim_walk_io_time,
            "sim_io_time": self.sim_io_time,
            "exec_time": self.exec_time,
            "sim_wall_time": self.sim_wall_time,
        }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        d = self.as_dict()
        return "IOStats(" + ", ".join(f"{k}={v}" for k, v in d.items()) + ")"
