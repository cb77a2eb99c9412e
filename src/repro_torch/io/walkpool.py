"""Walk pools — the "disk" tier for partially-finished walks (paper §4.3/§6.1).

A :class:`WalkPool` owns one append-only pool per block.  Engines ``push``
walks to the pool of the block they persist with (skewed ``min(B(u), B(v))``
or traditional ``B(cur)`` association — the *engine* decides the key, the
pool only stores) and ``load`` drains a whole pool at the start of that
block's time slot.

Both backends buffer pushes in memory and *spill* once a block's buffer
reaches ``flush_walks`` (the paper's walk-pool write buffer); a ``load``
first seals the buffer, then returns spilled + buffered walks in exact push
order, so the two backends are observationally identical to the engines:

* :class:`MemoryWalkPool` — spills into a host-memory list; the spill/read
  I/O is *modelled* (charged to :class:`~repro.core.stats.IOStats`) but no
  bytes move.  This is the seed engine's behavior, extracted.
* :class:`DiskWalkPool` — spills real 16-byte packed records
  (:func:`repro.core.walk.pack_walks`, §6.1 Fig. 7) to one append-only file
  per block, so ``IOStats.walk_bytes_written`` equals bytes on disk.  Walk
  ids ride in an int64 sidecar file: they are host bookkeeping for corpus
  recording, not part of the paper's record, and are not charged.

Only spilled walks are charged: a walk that never left the write buffer
never crossed the slow/fast boundary.  ``flush_walks=0`` spills every push
(the seed's accounting), ``flush_walks=None`` never spills before a load.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

from repro_torch.core.stats import IOStats
from repro_torch.core.walk import WALK_BYTES, WalkBatch, pack_walks, unpack_walks

__all__ = [
    "WalkPool",
    "MemoryWalkPool",
    "DiskWalkPool",
    "AsyncWalkPool",
    "ShardedWalkPool",
    "make_walk_pool",
    "shard_of_block",
]

_WID_BYTES = 8


def shard_of_block(b: int, num_shards: int) -> int:
    """Deterministic owner shard of block ``b``'s walk pool.

    Round-robin striping (``b % num_shards``): block ids are small
    *contiguous* integers, so striping is the perfect hash for this
    keyspace — every shard owns an equal slice (a multiplicative hash
    collides badly here: 2 blocks over 2 shards can land on one), it is
    independent of ``PYTHONHASHSEED`` and stable across hosts, and when
    ``num_shards == num_blocks`` it degenerates to the identity — one
    shard per rank, the distributed engine's natural placement.  Every key
    of the ``(block, bucket)`` keyspace an engine persists with — the
    skewed ``min(B(u), B(v))`` or traditional ``B(cur)`` association —
    resolves through this one function, so a block's entire op stream
    lands on one shard, in program order.
    """
    return int(b) % max(int(num_shards), 1)


def _first_missing_ancestor(path: str) -> Optional[str]:
    """The topmost path component ``os.makedirs(path)`` would create (the
    root to remove to undo it), or None when ``path`` already exists."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        return None
    root = path
    parent = os.path.dirname(root)
    while parent and parent != root and not os.path.isdir(parent):
        root, parent = parent, os.path.dirname(parent)
    return root


@runtime_checkable
class WalkPool(Protocol):
    """Per-block walk storage; see the module docstring for the contract."""

    backend: str
    counts: np.ndarray  # [NB] int64 — walks currently stored per block
    min_hop: np.ndarray  # [NB] float64 — min hop per block (inf when empty)

    def push(self, b: int, batch: WalkBatch, wid: np.ndarray) -> None: ...

    def load(self, b: int) -> Tuple[WalkBatch, np.ndarray]: ...

    def peek(self, b: int) -> Tuple[WalkBatch, np.ndarray]: ...

    def flush(self, b: Optional[int] = None) -> None: ...

    def close(self) -> None: ...


class _PoolBase:
    """Shared buffering, counting and spill-threshold logic."""

    backend = "base"

    def __init__(self, num_blocks: int, stats: IOStats, flush_walks: Optional[int] = 1 << 18):
        self.num_blocks = num_blocks
        self.stats = stats
        self.flush_walks = flush_walks
        self.counts = np.zeros(num_blocks, np.int64)
        self.min_hop = np.full(num_blocks, np.inf)
        self._buf: Dict[int, List[Tuple[WalkBatch, np.ndarray]]] = {
            b: [] for b in range(num_blocks)
        }
        self._buf_counts = np.zeros(num_blocks, np.int64)

    # -- subclass hooks -------------------------------------------------------
    def _spill(self, b: int, batch: WalkBatch, wid: np.ndarray) -> None:
        raise NotImplementedError

    def _read_spilled(self, b: int, *, consume: bool) -> Tuple[WalkBatch, np.ndarray]:
        raise NotImplementedError

    def _spilled_count(self, b: int) -> int:
        raise NotImplementedError

    # -- the engine-facing API ------------------------------------------------
    def push(self, b: int, batch: WalkBatch, wid: np.ndarray) -> None:
        if len(batch) == 0:
            return
        self._buf[b].append((batch, wid))
        self._buf_counts[b] += len(batch)
        self.counts[b] += len(batch)
        self.min_hop[b] = min(self.min_hop[b], float(batch.hop.min()))
        if self.flush_walks is not None and self._buf_counts[b] >= self.flush_walks:
            self.flush(b)

    def flush(self, b: Optional[int] = None) -> None:
        """Spill buffered walks to the slow tier (charged as walk writes)."""
        blocks = range(self.num_blocks) if b is None else (b,)
        for blk in blocks:
            entries = self._buf[blk]
            if not entries:
                continue
            self._buf[blk] = []
            n = int(self._buf_counts[blk])
            self._buf_counts[blk] = 0
            batch = WalkBatch.concat([e[0] for e in entries])
            wid = np.concatenate([e[1] for e in entries])
            self._spill(blk, batch, wid)
            self.stats.walk_io(n, kind="write")

    def load(self, b: int) -> Tuple[WalkBatch, np.ndarray]:
        """Drain pool ``b``: spilled walks (charged as a read) + buffer."""
        n_spilled = self._spilled_count(b)
        spilled_batch, spilled_wid = self._read_spilled(b, consume=True)
        if n_spilled:
            self.stats.walk_io(n_spilled, kind="read")
        entries = self._buf[b]
        self._buf[b] = []
        self._buf_counts[b] = 0
        self.counts[b] = 0
        self.min_hop[b] = np.inf
        batch = WalkBatch.concat([spilled_batch] + [e[0] for e in entries])
        wid = np.concatenate([spilled_wid] + [e[1] for e in entries])
        return batch, wid

    def peek(self, b: int) -> Tuple[WalkBatch, np.ndarray]:
        """Inspect pool ``b`` without consuming or charging (tests/debug)."""
        spilled_batch, spilled_wid = self._read_spilled(b, consume=False)
        entries = self._buf[b]
        batch = WalkBatch.concat([spilled_batch] + [e[0] for e in entries])
        wid = np.concatenate([spilled_wid] + [e[1] for e in entries])
        return batch, wid

    def close(self) -> None:
        pass


class MemoryWalkPool(_PoolBase):
    """Host-memory pools; spill I/O is modelled, not performed."""

    backend = "memory"

    def __init__(self, num_blocks: int, stats: IOStats, flush_walks: Optional[int] = 1 << 18):
        super().__init__(num_blocks, stats, flush_walks)
        self._spilled: Dict[int, List[Tuple[WalkBatch, np.ndarray]]] = {
            b: [] for b in range(num_blocks)
        }
        self._spilled_counts = np.zeros(num_blocks, np.int64)

    def _spill(self, b: int, batch: WalkBatch, wid: np.ndarray) -> None:
        self._spilled[b].append((batch, wid))
        self._spilled_counts[b] += len(batch)

    def _spilled_count(self, b: int) -> int:
        return int(self._spilled_counts[b])

    def _read_spilled(self, b: int, *, consume: bool) -> Tuple[WalkBatch, np.ndarray]:
        entries = self._spilled[b]
        if consume:
            self._spilled[b] = []
            self._spilled_counts[b] = 0
        if not entries:
            return WalkBatch.empty(), np.zeros(0, np.int64)
        return (
            WalkBatch.concat([e[0] for e in entries]),
            np.concatenate([e[1] for e in entries]),
        )


class DiskWalkPool(_PoolBase):
    """Real per-block append-only files of 16-byte packed walk records."""

    backend = "disk"

    def __init__(
        self,
        num_blocks: int,
        stats: IOStats,
        block_starts: np.ndarray,
        flush_walks: Optional[int] = 1 << 18,
        directory: Optional[str] = None,
    ):
        super().__init__(num_blocks, stats, flush_walks)
        self.block_starts = np.asarray(block_starts, dtype=np.int64)
        self._tmpdir: Optional[tempfile.TemporaryDirectory] = None
        if directory is None:
            self._tmpdir = tempfile.TemporaryDirectory(prefix="grasorw_pool_")
            directory = self._tmpdir.name
        # directories this pool creates (the whole makedirs chain) are
        # removed wholesale on close; in a pre-existing (user-owned)
        # directory only the spill files are
        self._created_root = _first_missing_ancestor(directory)
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self._spilled_counts = np.zeros(num_blocks, np.int64)
        self.bytes_written = 0

    def record_path(self, b: int) -> str:
        return os.path.join(self.directory, f"pool_{b:05d}.walks")

    def _wid_path(self, b: int) -> str:
        return os.path.join(self.directory, f"pool_{b:05d}.wid")

    def on_disk_bytes(self) -> int:
        """Current total size of all record files (16 bytes per stored walk)."""
        return sum(
            os.path.getsize(p)
            for b in range(self.num_blocks)
            if os.path.exists(p := self.record_path(b))
        )

    def _spill(self, b: int, batch: WalkBatch, wid: np.ndarray) -> None:
        packed = pack_walks(batch, self.block_starts)
        with open(self.record_path(b), "ab") as f:
            f.write(packed.tobytes())
        with open(self._wid_path(b), "ab") as f:
            f.write(np.asarray(wid, dtype=np.int64).tobytes())
        self._spilled_counts[b] += len(batch)
        self.bytes_written += len(batch) * WALK_BYTES

    def _spilled_count(self, b: int) -> int:
        return int(self._spilled_counts[b])

    def _read_spilled(self, b: int, *, consume: bool) -> Tuple[WalkBatch, np.ndarray]:
        n = int(self._spilled_counts[b])
        if n == 0:
            return WalkBatch.empty(), np.zeros(0, np.int64)
        with open(self.record_path(b), "rb") as f:
            raw = f.read()
        packed = np.frombuffer(raw, dtype=np.uint32).reshape(-1, 4)
        assert packed.shape[0] == n, "record file out of sync with pool counts"
        with open(self._wid_path(b), "rb") as f:
            wid = np.frombuffer(f.read(), dtype=np.int64)
        batch = unpack_walks(packed, self.block_starts)
        if consume:
            os.remove(self.record_path(b))
            os.remove(self._wid_path(b))
            self._spilled_counts[b] = 0
        return batch, wid.copy()

    def close(self) -> None:
        """Remove this pool's spill files so an aborted run (e.g. a writer
        fault mid-slot) never orphans them — pool state is gone with the
        object either way.  Directories go too when the pool created them
        (a fresh temp dir, or the whole makedirs chain of a
        previously-nonexistent explicit path); a pre-existing directory is
        left in place.  Idempotent."""
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None
            return
        for b in range(self.num_blocks):
            for path in (self.record_path(b), self._wid_path(b)):
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass
        if self._created_root is not None:
            shutil.rmtree(self._created_root, ignore_errors=True)


class AsyncWalkPool:
    """Sequenced async persist path over any :class:`WalkPool` backend.

    Wraps a base pool with a single *writer thread* draining a bounded FIFO
    job queue.  Every ``push`` is assigned a monotonically-increasing ticket
    and enqueued; the writer applies jobs strictly in ticket order, so the
    base pool steps through **exactly** the state sequence a serial engine
    issuing the same op sequence would have produced — same buffer
    contents, same spill points, same charged walk I/O — just off the
    caller's critical path.

    ``drain_async`` is the pipeline's preload primitive: the drain job rides
    the same FIFO, so it observes precisely the pushes enqueued *before* it
    in program order (a deterministic prefix — no racy snapshot), loads the
    pool on the writer thread (optionally running a ``transform`` such as
    bucket splitting there too) and resolves a future with
    ``(payload, n_walks, n_spilled)``.  Because a pool preserves push order
    and a drain consumes a prefix, ``prefix-drain + later remainder-drain``
    concatenates to what one serial ``load`` at slot start would return —
    the *walks* are identical.  The walk-I/O *charges* are deterministic
    and backend-invariant but follow the drain points: a preload drains the
    write buffer earlier than a slot-start ``load`` would, so a
    flush-threshold crossing that straddles the preload point can spill in
    one mode and not the other — ``walk_bytes_written/read`` legitimately
    differ between the async pipeline and the no-preload serial reference
    (block and on-demand charges never do).

    ``counts``/``min_hop`` are tracked *eagerly* on the caller's thread
    (updated at enqueue time), so schedulers see the same sequential view of
    pending walks as with a raw pool.

    A writer-thread exception is latched: every queued and subsequent
    operation (``push``/``load``/``flush``/``barrier``) re-raises it on the
    calling thread, so a failed spill propagates out of ``Engine.run()``.
    ``close`` never raises and never hangs: it wakes the writer, lets it
    drain the queue (failing pending futures once an error is latched) and
    joins it before closing the base pool.  Idempotent.
    """

    def __init__(self, base: WalkPool, stats: Optional[IOStats] = None, max_queue: int = 64):
        self.base = base
        self.stats = stats
        self.max_queue = max(int(max_queue), 1)
        self.num_blocks = base.num_blocks
        #: eager sequential view — the base arrays lag by the queue contents
        self.counts = base.counts.copy()
        self.min_hop = base.min_hop.copy()
        self.tickets_issued = 0
        self.applied_ticket = 0
        #: pool-local high-water copy of ``IOStats.writer_queue_peak`` for
        #: stats-less construction; both update from the same _enqueue line
        self.queue_peak = 0
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._error: Optional[BaseException] = None
        self._closed = False
        self._worker = threading.Thread(
            target=self._run_worker, name="walkpool-writer", daemon=True
        )
        self._worker.start()

    @property
    def backend(self) -> str:
        return self.base.backend

    def __getattr__(self, name):
        # forward backend extras (e.g. DiskWalkPool.bytes_written/on_disk_bytes)
        return getattr(self.base, name)

    # -- writer thread --------------------------------------------------------
    def _run_worker(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if not self._q:
                    return  # closed and fully drained
                job = self._q.popleft()
                self._cv.notify_all()  # wake producers blocked on a full queue
            self._apply(job)

    def _apply(self, job) -> None:
        kind, fut = job[0], job[-1]
        if self._error is not None:
            if fut is not None:
                fut.set_exception(self._error)
            return
        try:
            if kind == "push":
                _, ticket, b, batch, wid, _ = job
                self.base.push(b, batch, wid)
                self.applied_ticket = ticket
            elif kind == "drain":
                _, b, transform, fut = job
                n_spilled = self.base._spilled_count(b)
                batch, wid = self.base.load(b)
                payload = transform(batch, wid) if transform is not None else (batch, wid)
                fut.set_result((payload, len(batch), n_spilled))
            elif kind == "flush":
                _, b, fut = job
                self.base.flush(b)
                fut.set_result(None)
            else:  # barrier
                fut.set_result(None)
        except BaseException as e:  # latch and surface on the calling thread
            self._error = e
            if fut is not None and not fut.done():
                fut.set_exception(e)
            with self._cv:
                self._cv.notify_all()

    # -- producer side --------------------------------------------------------
    def _raise_if_failed(self) -> None:
        if self._error is not None:
            raise RuntimeError("walk-pool writer thread failed") from self._error

    def _enqueue(self, job) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("AsyncWalkPool is closed")
            self._q.append(job)
            self.queue_peak = max(self.queue_peak, len(self._q))
            if self.stats is not None:
                self.stats.note_writer_queue(len(self._q))
            self._cv.notify_all()

    def push(self, b: int, batch: WalkBatch, wid: np.ndarray) -> None:
        if len(batch) == 0:
            return
        self._raise_if_failed()
        with self._cv:
            while len(self._q) >= self.max_queue and self._error is None and not self._closed:
                self._cv.wait()
        self._raise_if_failed()
        self.tickets_issued += 1
        self._enqueue(("push", self.tickets_issued, int(b), batch, wid, None))
        self.counts[b] += len(batch)
        self.min_hop[b] = min(self.min_hop[b], float(batch.hop.min()))

    def drain_async(
        self,
        b: int,
        transform: Optional[Callable[[WalkBatch, np.ndarray], object]] = None,
    ) -> Future:
        """Enqueue a prefix drain of pool ``b``; resolves to
        ``(payload, n_walks, n_spilled)`` where ``payload`` is
        ``transform(batch, wid)`` (or the raw pair)."""
        fut: Future = Future()
        self._enqueue(("drain", int(b), transform, fut))
        self.counts[b] = 0
        self.min_hop[b] = np.inf
        return fut

    def load(self, b: int) -> Tuple[WalkBatch, np.ndarray]:
        payload, _, _ = self.drain_async(b).result()
        return payload

    def peek(self, b: int) -> Tuple[WalkBatch, np.ndarray]:
        """Inspect pool ``b`` after the queue settles (tests/debug; does not
        see batches already handed out by :meth:`drain_async`)."""
        self.barrier()
        return self.base.peek(b)

    def flush(self, b: Optional[int] = None) -> None:
        fut: Future = Future()
        self._enqueue(("flush", b, fut))
        fut.result()

    def barrier(self) -> None:
        """Block until every enqueued job has been applied; re-raises a
        latched writer error."""
        with self._cv:
            closed = self._closed
        if not closed:
            fut: Future = Future()
            self._enqueue(("barrier", fut))
            fut.result()
        self._raise_if_failed()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join()
        self.base.close()


class _ShardStats:
    """Stats facade handed to one shard's base pool.

    Base pools charge walk I/O through ``stats.walk_io`` from their shard's
    writer thread; this facade forwards the charge to the shared
    :class:`~repro.core.stats.IOStats` (which serialises concurrent shard
    writers under its lock) and stamps it with the shard id, feeding the
    ``shard_spill_bytes`` breakdown.
    """

    def __init__(self, parent: IOStats, shard: int):
        self.parent = parent
        self.shard = shard

    def walk_io(self, n_walks: int, *, bytes_per_walk: int = 16, kind: str = "write") -> None:
        self.parent.walk_io(n_walks, bytes_per_walk=bytes_per_walk, kind=kind, shard=self.shard)


class ShardedWalkPool:
    """Partition of the walk-pool keyspace across N sequenced writers.

    The ``(block, bucket)`` keyspace engines persist with is partitioned by
    :func:`shard_of_block` — a deterministic hash of the block id — across
    ``num_shards`` shards.  Each shard is a full pool backend
    (memory/disk, its own spill directory) wrapped in its own
    :class:`AsyncWalkPool` sequenced writer, so persists and
    ``drain_async`` preloads for blocks owned by *different* shards proceed
    concurrently with no cross-shard ordering, while per-shard FIFO ticket
    order is preserved.

    Determinism is inherited, not re-argued: every op on block ``b``
    (push, drain, flush) is forwarded to ``shard_of_block(b)``'s FIFO in
    program order, so a block's op subsequence — and with it the per-block
    write buffer, its spill points, and the prefix a ``drain_async``
    observes — is *identical* to what a single sequenced writer would
    apply.  Walks, walk-I/O charges, and the per-shard spill breakdown
    (``IOStats.shard_spill_bytes``, summing to ``walk_bytes_written``) are
    therefore invariant across shard counts and pool backends; only the
    concurrency changes.  The ``shard_imbalance`` gauge (max-over-mean of
    pushed walks per shard) is likewise a pure function of the push totals.

    ``counts``/``min_hop`` are tracked eagerly on the caller's thread —
    the same sequential view of pending walks :class:`AsyncWalkPool`
    exposes.  A writer fault in *any* shard latches and re-raises from
    every subsequent pool op and from :meth:`barrier`; ``close`` joins all
    writers and never raises or hangs.
    """

    def __init__(
        self,
        backend: str,
        *,
        num_shards: int,
        num_blocks: int,
        stats: IOStats,
        block_starts: Optional[np.ndarray] = None,
        flush_walks: Optional[int] = 1 << 18,
        directory: Optional[str] = None,
        max_queue: int = 64,
    ):
        if not isinstance(backend, str):
            raise ValueError("ShardedWalkPool builds its shards itself; pass a backend name")
        self.num_shards = max(int(num_shards), 1)
        self.num_blocks = num_blocks
        self.stats = stats
        self.counts = np.zeros(num_blocks, np.int64)
        self.min_hop = np.full(num_blocks, np.inf)
        self.owner = np.array(
            [shard_of_block(b, self.num_shards) for b in range(num_blocks)], np.int64
        )
        self.pushed_per_shard = np.zeros(self.num_shards, np.int64)
        # shard pools remove their own spill subdirs on close; any parent
        # chain we are about to create is ours to remove too
        self.directory = directory
        self._created_root = None if directory is None else _first_missing_ancestor(directory)
        self.shards: List[AsyncWalkPool] = []
        for k in range(self.num_shards):
            sub = None if directory is None else os.path.join(directory, f"shard_{k:02d}")
            base = make_walk_pool(
                backend,
                num_blocks=num_blocks,
                stats=_ShardStats(stats, k),
                block_starts=block_starts,
                flush_walks=flush_walks,
                directory=sub,
            )
            self.shards.append(AsyncWalkPool(base, stats=stats, max_queue=max_queue))
        self._closed = False

    @property
    def backend(self) -> str:
        return self.shards[0].backend

    def shard_of(self, b: int) -> int:
        return int(self.owner[b])

    def writer(self, b: int) -> AsyncWalkPool:
        """The sequenced writer owning block ``b``'s pool (the pipeline
        targets it for next-slot drains)."""
        return self.shards[self.shard_of(b)]

    def _raise_if_failed(self) -> None:
        for shard in self.shards:
            if shard._error is not None:
                raise RuntimeError("walk-pool shard writer failed") from shard._error

    # -- the engine-facing API ------------------------------------------------
    def push(self, b: int, batch: WalkBatch, wid: np.ndarray) -> None:
        if len(batch) == 0:
            return
        self._raise_if_failed()
        k = self.shard_of(b)
        self.shards[k].push(b, batch, wid)
        self.counts[b] += len(batch)
        self.min_hop[b] = min(self.min_hop[b], float(batch.hop.min()))
        self.pushed_per_shard[k] += len(batch)
        total = int(self.pushed_per_shard.sum())
        self.stats.note_shard_imbalance(
            int(self.pushed_per_shard.max()) * self.num_shards / max(total, 1)
        )

    def drain_async(
        self,
        b: int,
        transform: Optional[Callable[[WalkBatch, np.ndarray], object]] = None,
    ) -> Future:
        self._raise_if_failed()
        fut = self.writer(b).drain_async(b, transform)
        self.counts[b] = 0
        self.min_hop[b] = np.inf
        return fut

    def load(self, b: int) -> Tuple[WalkBatch, np.ndarray]:
        payload, _, _ = self.drain_async(b).result()
        return payload

    def peek(self, b: int) -> Tuple[WalkBatch, np.ndarray]:
        return self.writer(b).peek(b)

    def flush(self, b: Optional[int] = None) -> None:
        if b is not None:
            self.writer(b).flush(b)
            return
        for shard in self.shards:
            shard.flush(None)

    def barrier(self) -> None:
        """Wait out every shard's writer queue; re-raises any latched fault."""
        for shard in self.shards:
            shard.barrier()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for shard in self.shards:
            shard.close()
        if self._created_root is not None:
            shutil.rmtree(self._created_root, ignore_errors=True)

    # -- disk-backend extras, aggregated over shards ---------------------------
    @property
    def bytes_written(self) -> int:
        return sum(getattr(s.base, "bytes_written", 0) for s in self.shards)

    def on_disk_bytes(self) -> int:
        return sum(s.base.on_disk_bytes() for s in self.shards if hasattr(s.base, "on_disk_bytes"))


def make_walk_pool(
    backend,
    *,
    num_blocks: int,
    stats: IOStats,
    block_starts: Optional[np.ndarray] = None,
    flush_walks: Optional[int] = 1 << 18,
    directory: Optional[str] = None,
) -> WalkPool:
    """Build a pool from a backend name, or pass an instance through."""
    if not isinstance(backend, str):
        return backend
    if backend == "memory":
        return MemoryWalkPool(num_blocks, stats, flush_walks)
    if backend == "disk":
        if block_starts is None:
            raise ValueError("disk pool needs block_starts for the 128-bit encoding")
        return DiskWalkPool(num_blocks, stats, block_starts, flush_walks, directory)
    raise ValueError(f"unknown walk pool backend {backend!r}; have memory, disk")
