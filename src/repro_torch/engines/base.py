"""Shared engine plumbing: resident view pair, walk pools, stats, advance.

The port of ``repro/engines/base.py``: the same packing, bookkeeping and
storage layer, with the resident pair held as torch tensors on the engine's
device (``cuda`` unless the caller passes ``device="cpu"``) and the advance
run by the hand-written CUDA kernel (:mod:`repro_torch.kernels.pair_advance`)
or its plain PyTorch version.

Every out-of-core engine owns

* a :class:`repro.io.WalkPool` (``pool=``, ``"memory"`` or ``"disk"``) — the
  slow tier holding partially-finished walks between time slots; engines
  persist *exclusively* through it;
* a :class:`repro.io.BlockStore` — metered, cached, prefetching access to
  graph block *views*; engines load *exclusively* through it;
* with ``record_walks``, the corpus ``[num_walks, length + 1]`` on the
  engine's device, written by the advance and copied back once by
  ``result()`` (on the host, filled from each advance's trace, when it
  does not fit the card);
* a :class:`ResidentPair` — the two resident slots as packed device arrays
  (the "memory" tier of the paper).  Each slot holds a
  :class:`~repro.core.graph.BlockView` — a full block or a compacted
  *activated* view — so heterogeneously-sized views stack without padding
  one to the other's shape; per-slot sizes are pow2-bucketed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple, Union

import numpy as np

import torch

from repro_torch.core import spans
from repro_torch.core.graph import BlockedGraph, BlockView, block_of
from repro_torch.core.stats import SSD, DevicePreset, IOStats
from repro_torch.core.transition import Node2vec, WalkTask
from repro_torch.core.walk import WalkBatch
from repro_torch.io import AsyncWalkPool, BlockStore, ShardedWalkPool, WalkPool, make_walk_pool
from repro_torch.kernels import pair_advance as _pair_advance
from repro_torch.kernels import rng

from .step import VID_PAD, pair_advance_ref, pow2_pad, remap_search_iters

__all__ = ["WalkResult", "EngineBase", "ResidentPair", "corpus_fits", "resolve_device"]


def resolve_device(device) -> torch.device:
    """The engine's device: ``cuda`` by default, ``cpu`` only when asked.
    Raises when a CUDA device is asked for and none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def corpus_fits(nbytes: int, device: torch.device) -> bool:
    """Whether an engine keeps a corpus of ``nbytes`` on ``device``: always
    on the CPU; on a card, when it takes at most half of the bytes the card
    reports free."""
    if device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(device)
    return nbytes <= free // 2


@dataclasses.dataclass
class WalkResult:
    """Task output: endpoint histogram (PPR estimator), optional corpus."""

    num_walks: int
    steps_sampled: int
    endpoint_counts: np.ndarray  # [V] visits at termination
    corpus: Optional[np.ndarray]  # [num_walks, length+1] int32 or None
    stats: IOStats
    loader_summary: Optional[dict] = None
    block_store_counters: Optional[dict] = None
    advance_calls: int = 0  # EngineBase._advance calls of the run

    def ppr_estimate(self) -> np.ndarray:
        tot = max(self.endpoint_counts.sum(), 1)
        return self.endpoint_counts / tot


class ResidentPair:
    """Two resident view slots packed into flat ragged device arrays.

    Unlike the fixed-shape block pair it replaces, each slot is padded to
    its *own* pow2-bucketed capacity, so an activated view costs
    ``O(activated vertices)`` device bytes next to a full block instead of
    being padded to the block maxima.  When both slots hold the same view
    (initialization, single-block engines) the segment is stored once and
    both slots alias it.
    """

    #: pow2 floor for activated-view capacities (vertices, edges)
    V_FLOOR = 64
    E_FLOOR = 256

    def __init__(
        self,
        bg: BlockedGraph,
        has_alias: bool,
        stats: Optional[IOStats] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.bg = bg
        self.device = torch.device(device)
        self.has_alias = has_alias
        self.stats = stats
        self.views: list[Optional[BlockView]] = [None, None]
        # pack-once-per-slot-change: packed segment + caps, keyed by the view
        # object resident in the slot (views are immutable once built)
        self._packed: list = [None, None]

    def set_slot(self, s: int, view: BlockView) -> None:
        if self.views[s] is not view:
            self._packed[s] = None
        self.views[s] = view

    def _packed_segment(self, s: int):
        view = self.views[s]
        if self._packed[s] is None:
            vc, ec = self._caps(view)
            self._packed[s] = (self._pack_segment(view, vc, ec, self.has_alias), vc, ec)
        return self._packed[s]

    # -- packing --------------------------------------------------------------
    def _caps(self, view: BlockView) -> Tuple[int, int]:
        """Padded (vertex, edge) capacity for one view.  Full views always
        pad to the graph maxima (one stable shape); activated views to a
        pow2 bucket of their own size."""
        if view.kind == "full":
            return self.bg.max_block_verts, self.bg.max_block_edges
        vc = min(pow2_pad(view.nverts, self.V_FLOOR), self.bg.max_block_verts)
        ec = min(pow2_pad(view.nedges, self.E_FLOOR), self.bg.max_block_edges)
        return max(vc, view.nverts), max(ec, view.nedges)

    @staticmethod
    def _pack_segment(view: BlockView, vc: int, ec: int, has_alias: bool):
        vids = np.full(vc, VID_PAD, np.int32)
        vids[: view.nverts] = view.vids
        indptr = np.full(vc + 1, view.nedges, np.int32)
        indptr[: view.nverts + 1] = view.indptr
        indices = np.full(ec, -1, np.int32)
        indices[: view.nedges] = view.indices
        if has_alias:
            aj = np.zeros(ec, np.int32)
            aq = np.ones(ec, np.float32)
            if view.alias_j is not None:
                aj[: view.nedges] = view.alias_j
                aq[: view.nedges] = view.alias_q
        else:
            aj = np.zeros(1, np.int32)
            aq = np.ones(1, np.float32)
        return vids, indptr, indices, aj, aq

    def device_args(self):
        """Pack both slots into the kernel's flat ragged arrays.  Returns
        ``(args, v_iters)`` — ``v_iters`` is the static binary-search depth
        for the remap lookup at this padded size."""
        v0, v1 = self.views
        dedupe = v1 is v0
        slots = [0] if dedupe else [0, 1]
        segs = []
        packed = []
        for s in slots:
            p, vc, ec = self._packed_segment(s)
            segs.append((self.views[s], vc, ec))
            packed.append(p)
        vids = np.concatenate([p[0] for p in packed])
        indptr = np.concatenate([p[1] for p in packed])
        indices = np.concatenate([p[2] for p in packed])
        if self.has_alias:
            alias_j = np.concatenate([p[3] for p in packed])
            alias_q = np.concatenate([p[4] for p in packed])
        else:
            alias_j = np.zeros(1, np.int32)
            alias_q = np.ones(1, np.float32)
        vc0 = segs[0][1]
        ec0 = segs[0][2]
        if dedupe:
            nverts = np.array([v0.nverts, v0.nverts], np.int32)
            vid_base = np.array([0, 0], np.int32)
            ptr_base = np.array([0, 0], np.int32)
            ind_base = np.array([0, 0], np.int32)
        else:
            nverts = np.array([v0.nverts, v1.nverts], np.int32)
            vid_base = np.array([0, vc0], np.int32)
            ptr_base = np.array([0, vc0 + 1], np.int32)
            ind_base = np.array([0, ec0], np.int32)
        if self.stats is not None:
            nbytes = 4 * (vids.size + indptr.size + indices.size)
            if self.has_alias:
                nbytes += 8 * indices.size
            self.stats.note_resident(nbytes)
        max_cap = max(vc for _, vc, _ in segs)
        v_iters = remap_search_iters(max_cap)
        args = tuple(
            torch.as_tensor(a, device=self.device)
            for a in (vids, nverts, vid_base, indptr, ptr_base, indices, ind_base, alias_j, alias_q)
        )
        return args, v_iters


class EngineBase:
    """Common state: walk pool ("disk"), block store, stats, bookkeeping.

    Engines are single-run objects and context managers: ``run()`` closes
    the storage layer on any exit (including a raise), ``close()`` is
    idempotent, and ``with Engine(...) as eng: eng.run()`` works too.
    """

    def __init__(
        self,
        bg: BlockedGraph,
        task: WalkTask,
        *,
        preset: DevicePreset = SSD,
        record_walks: bool = False,
        k_max: int = 16,
        pool: Union[str, WalkPool] = "memory",
        pool_flush_walks: int = 1 << 18,
        pool_dir: Optional[str] = None,
        prefetch: bool = True,
        block_cache_blocks: int = 4,
        seed: Optional[int] = None,
        async_pipeline: bool = False,
        writer_queue: int = 64,
        pool_shards: int = 1,
        advance_impl: str = "cuda",
        device: Union[str, torch.device] = "cuda",
        stats: Optional[IOStats] = None,
        block_store: Optional[BlockStore] = None,
        initial_walks: Optional[np.ndarray] = None,
        on_retire: Optional[Callable[[np.ndarray, np.ndarray], None]] = None,
        hot_blocks=None,
    ):
        with spans.span("engine.init"):
            self.bg = bg
            self.task = task
            # the serving seams: a query front end (repro.serve) passes a shared
            # IOStats + BlockStore so charges (and the hot-set pinning savings)
            # accumulate across the engine runs it drives, injects the admitted
            # queries' walk sources as `initial_walks`, and observes per-walk
            # terminations through `on_retire` to attribute endpoints per query
            if stats is None and block_store is not None:
                stats = block_store.stats
            self.stats = IOStats(preset) if stats is None else stats
            if block_store is not None and block_store.stats is not self.stats:
                raise ValueError(
                    "a shared block_store must charge through the engine's IOStats "
                    "(pass the store's stats, or no stats at all)"
                )
            self.on_retire = on_retire
            self.record_walks = record_walks
            self.k_max = k_max if isinstance(task.model, Node2vec) else 1
            if isinstance(task.model, Node2vec) and task.model.p == task.model.q == 1.0:
                self.k_max = 1  # acceptance prob is exactly 1 — no rejection needed
            self.pool_flush_walks = pool_flush_walks
            self.seed = task.seed if seed is None else seed
            self.order = task.model.order
            # backend-neutral surface: works for the in-RAM BlockedGraph and the
            # file-backed repro.io.DiskBlockedGraph alike
            self.has_alias = bg.has_weights
            if self.has_alias:
                bg.ensure_alias()
            self.n_iters = int(np.ceil(np.log2(max(bg.max_block_edges, 2)))) + 2
            # the advance: "cuda" (the fused multi-hop kernel,
            # repro_torch.kernels.pair_advance, whose wrapper takes the plain
            # version for CPU tensors) or "torch" (the plain version itself) —
            # both draw through the same threefry, so their walks are identical
            if advance_impl not in ("cuda", "torch"):
                raise ValueError(f"advance_impl must be 'cuda' or 'torch', got {advance_impl!r}")
            self.advance_impl = advance_impl
            self.device = resolve_device(device)
            self.advance_calls = 0
            # counter-based RNG: one fixed base key (jax.random.PRNGKey(seed)'s
            # raw halves); draws are keyed per (walk id, hop), never per call
            self._base_key = rng.key_halves(self.seed)
            V = bg.num_vertices
            self.endpoint_counts = np.zeros(V, np.int64)
            if initial_walks is None:
                src = task.initial_walks(V)
            else:
                src = np.asarray(initial_walks, dtype=np.int64)
            self.num_walks = src.shape[0]
            # the corpus lives on the engine's device, where the advance writes
            # each recorded step into its walk's row, and comes back once, in
            # result(); one that does not fit there is kept on the host and
            # filled from each advance's trace
            self.corpus: Optional[np.ndarray] = None
            self.device_corpus: Optional[torch.Tensor] = None
            if record_walks:
                shape = (self.num_walks, task.length + 1)
                if corpus_fits(4 * shape[0] * shape[1], self.device):
                    spans.count("corpus.device")
                    dev = self.device
                    self.device_corpus = torch.full(shape, -1, dtype=torch.int32, device=dev)
                    self.device_corpus[:, 0] = torch.as_tensor(src.astype(np.int32), device=dev)
                else:
                    spans.count("corpus.host")
                    self.corpus = np.full(shape, -1, np.int32)
                    self.corpus[:, 0] = src
            # the storage layer: walk pool ("disk" tier) + block store; with the
            # async pipeline the pool persists through a sequenced writer thread
            # (ticketed pushes — serial state sequence, off the critical path),
            # and pool_shards > 1 partitions the keyspace across that many
            # writers (one AsyncWalkPool-wrapped backend per shard)
            self.async_pipeline = bool(async_pipeline)
            self.writer_queue = writer_queue
            self.pool_shards = max(int(pool_shards), 1)
            if self.pool_shards > 1 and not self.async_pipeline:
                raise ValueError(
                    "pool_shards > 1 requires the async pipeline: shards are "
                    "per-shard sequenced writers (the serial reference mode has none)"
                )
            if self.pool_shards > 1 and not isinstance(pool, (str, ShardedWalkPool)):
                raise ValueError(
                    "pool_shards > 1 needs a backend name (or a prebuilt ShardedWalkPool); "
                    "a plain pool instance cannot be partitioned after construction"
                )
            if self.pool_shards > 1 and isinstance(pool, str):
                self.pool: WalkPool = ShardedWalkPool(
                    pool,
                    num_shards=self.pool_shards,
                    num_blocks=bg.num_blocks,
                    stats=self.stats,
                    block_starts=bg.block_starts,
                    flush_walks=pool_flush_walks,
                    directory=pool_dir,
                    max_queue=writer_queue,
                )
            else:
                self.pool = make_walk_pool(
                    pool,
                    num_blocks=bg.num_blocks,
                    stats=self.stats,
                    block_starts=bg.block_starts,
                    flush_walks=pool_flush_walks,
                    directory=pool_dir,
                )
                sequenced = isinstance(self.pool, (AsyncWalkPool, ShardedWalkPool))
                if self.async_pipeline and not sequenced:
                    self.pool = AsyncWalkPool(self.pool, stats=self.stats, max_queue=writer_queue)
            if block_store is not None:
                self.blocks = block_store
                self._owns_blocks = False
            else:
                self.blocks = BlockStore(
                    bg,
                    self.stats,
                    enable_prefetch=prefetch,
                    capacity=max(block_cache_blocks, 2),
                )
                self._owns_blocks = True
            if hot_blocks is not None:
                self.blocks.pin(hot_blocks)
            self._pending_init_src = src
            self.unfinished = self.num_walks
            self.pair = ResidentPair(bg, self.has_alias, self.stats, self.device)
            self._closed = False

    # -- pool plumbing ("disk" walk I/O) --------------------------------------
    @property
    def pool_counts(self) -> np.ndarray:
        return self.pool.counts

    @property
    def pool_min_hop(self) -> np.ndarray:
        return self.pool.min_hop

    # -- termination bookkeeping ----------------------------------------------
    def _retire(
        self,
        batch: WalkBatch,
        wid: np.ndarray,
        alive: np.ndarray,
    ) -> Tuple[WalkBatch, np.ndarray]:
        with spans.span("retire"):
            done = ~alive
            if done.any():
                ends = batch.cur[done]
                np.add.at(self.endpoint_counts, ends, 1)
                if self.on_retire is not None:
                    self.on_retire(wid[done], ends)
                self.unfinished -= int(done.sum())
            keep = alive
            return batch.select(keep), wid[keep]

    def _record_trace(self, wid: np.ndarray, trace: np.ndarray) -> None:
        if self.corpus is None or wid.size == 0:
            return
        with spans.span("advance.record"):
            cols = np.nonzero((trace >= 0).any(axis=0))[0]
            for h in cols:
                col = trace[:, h]
                m = col >= 0
                self.corpus[wid[m], h] = col[m]

    # -- the device advance ------------------------------------------------------
    def _advance(self, batch: WalkBatch, wid: np.ndarray, alive: Optional[np.ndarray] = None):
        """Run the pair advance on the resident view pair; returns the
        updated host batch and alive mask.  ``alive`` masks walks already
        retired in a previous round of the same bucket (mid-advance
        extensions)."""
        with spans.span("advance"):
            with spans.span("advance.upload"):
                n = len(batch)
                N = pow2_pad(n)
                # lanes padded to a power of two with alive=False; one
                # host->device copy for the four int32 lane arrays
                lanes = np.zeros((4, N), np.int32)
                lanes[0, :n] = wid
                lanes[1, :n] = batch.prev
                lanes[2, :n] = batch.cur
                lanes[3, :n] = batch.hop
                alive_host = np.zeros(N, bool)
                alive_host[:n] = True if alive is None else alive
                lanes_dev = torch.as_tensor(lanes, device=self.device)
                wid_dev, prev, cur, hop = lanes_dev.unbind(0)
                alive_dev = torch.as_tensor(alive_host, device=self.device)
                pair_args, v_iters = self.pair.device_args()
            t0 = time.perf_counter_ns()
            if self.advance_impl == "cuda":
                advance = _pair_advance.fused_advance_pair
            else:
                advance = pair_advance_ref
            out = advance(
                *pair_args,
                wid_dev,
                prev,
                cur,
                hop,
                alive_dev,
                self._base_key,
                int(self.task.length),
                float(self.task.decay),
                float(getattr(self.task.model, "p", 1.0)),
                float(getattr(self.task.model, "q", 1.0)),
                order=self.order,
                k_max=self.k_max,
                n_iters=self.n_iters,
                v_iters=v_iters,
                record=self.record_walks,
                has_alias=self.has_alias,
                max_len=int(self.task.length),
                corpus=self.device_corpus,
            )
            # the device-to-host copies synchronise, so exec_time covers the
            # run; the "advance.exec" span is made of the same two reads
            prev_f, cur_f, hop_f, alive_f, steps, trace = (t.cpu().numpy() for t in out)
            t1 = time.perf_counter_ns()
            self.stats.exec_time += (t1 - t0) * 1e-9
            spans.add("advance.exec", t0, t1)
            self.advance_calls += 1
            self.stats.steps_sampled += int(steps)
            if self.corpus is not None:
                self._record_trace(wid, trace[:n])
            new_batch = WalkBatch(batch.src, prev_f[:n], cur_f[:n], hop_f[:n])
            return new_batch, alive_f[:n]

    # -- initialization stage (paper App. B step 1) -----------------------------
    def _initialize(self) -> None:
        """First-order init: advance walks inside their source block until
        they leave it or terminate, guaranteeing B(u) != B(v) for every
        persisted walk."""
        with spans.span("init"):
            src = self._pending_init_src
            self._pending_init_src = None
            wid_all = np.arange(src.shape[0], dtype=np.int64)
            src_blocks = block_of(self.bg.block_starts, src)
            uniq = np.unique(src_blocks)
            for k, b in enumerate(uniq):
                with spans.span("load"):
                    view = self.blocks.get_view(int(b), sequential=True)
                if k + 1 < len(uniq):
                    self.blocks.prefetch(int(uniq[k + 1]))
                self.pair.set_slot(0, view)
                self.pair.set_slot(1, view)
                m = src_blocks == b
                batch = WalkBatch(src[m], src[m], src[m], np.zeros(m.sum(), np.int32))
                wid = wid_all[m]
                batch, alive = self._advance(batch, wid)
                batch, wid = self._retire(batch, wid, alive)
                self._persist(batch, wid)

    def _persist(self, batch: WalkBatch, wid: np.ndarray) -> None:
        raise NotImplementedError

    def _run(self) -> WalkResult:
        raise NotImplementedError

    def run(self) -> WalkResult:
        """Execute the task.  The storage layer (prefetch thread, disk-pool
        spill dirs) is released on *any* exit — including the
        convergence-guard ``RuntimeError`` — so a failed run leaks nothing."""
        with spans.span("task.run"):
            try:
                return self._run()
            finally:
                self.close()

    def close(self) -> None:
        """Release the storage layer: the prefetch thread and any spill
        files/temp dirs a disk pool owns.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._owns_blocks:
            self.blocks.close()
        self.pool.close()

    def __enter__(self) -> "EngineBase":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def result(self, *, loader_summary: Optional[dict] = None) -> WalkResult:
        """Assemble the :class:`WalkResult` and close the engine.  Every
        engine reports ``loader_summary`` uniformly — baselines (and any
        engine without a learning-based loader) report ``None``."""
        corpus = self.corpus
        if self.device_corpus is not None:
            # one copy to the host, into memory the caller owns (none from the
            # CPU, where the engine hands its tensor over); its time is that of
            # touching fresh host pages, which a copy through pinned memory
            # pays as well
            with spans.span("corpus.fetch"):
                corpus = self.device_corpus.cpu().numpy()
            self.device_corpus = None
        res = WalkResult(
            num_walks=self.num_walks,
            steps_sampled=self.stats.steps_sampled,
            endpoint_counts=self.endpoint_counts,
            corpus=corpus,
            stats=self.stats,
            loader_summary=loader_summary,
            block_store_counters=self.blocks.counters(),
            advance_calls=self.advance_calls,
        )
        self.close()
        return res

