"""Distributed GraSorw on ``torch.distributed`` — the bi-block engine at pod scale.

The port of ``repro/core/distributed.py``.  Each rank of the mesh's block
axis owns one graph block; walks are sharded over ``(*data_axes,
block_axis)``.  The triangular bi-block schedule becomes a **half ring**:

    for t in 1 .. max(N_B // 2, 1):
        every rank r holds the pair (block r, block (r + t) mod N_B)
        — one ring hop of the partner block per round (batch_isend_irecv) —
        and advances every routed walk whose block pair has ring distance t.

Every unordered block pair {a, b} is resident at exactly one rank per sweep
(rank a if (b-a) mod N_B <= N_B/2 else rank b; ties toward min(a, b)).
Walks are routed to the owning rank with ``all_to_all_single`` under a fixed
per-destination capacity; a walk whose slot does not fit waits for the next
sweep (the walks do not change, only ``sweeps`` and the pool's charges).

Between sweeps the walk state crosses the host through a
:class:`repro_torch.io.ShardedWalkPool`, as the JAX engine's single
controller does.  Here **rank 0 of the world owns the pool**: every rank
gathers the sweep's global arrays (it returns them), rank 0 persists the
live frontier in walk-id order and drains it back in block order, then
scatters each rank its slice.  The other ranks build no pool, and only rank
0's :class:`IOStats` carries the walk-I/O charges.

The advance is the port's pair advance: the hand-written CUDA kernel
(:func:`repro_torch.kernels.pair_advance.fused_advance_pair`) or its plain
PyTorch version, keyed on ``(task seed, walk id, hop)``, so a walk's
trajectory is that of every other engine, on any mesh.

Where tensors live is the process group backend's rule, not a fallback:
exchanged tensors (the partner block, routed walks, the gathered and
scattered state) are on the card for NCCL and in host memory for gloo; the
advance always runs on ``device``.  NCCL with ``device="cpu"`` raises.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.buckets import push_by_block_assignment
from repro_torch.core.graph import BlockedGraph
from repro_torch.core.stats import IOStats
from repro_torch.core.transition import Node2vec, WalkTask
from repro_torch.core.walk import WalkBatch
from repro_torch.engines.base import resolve_device
from repro_torch.engines.step import VID_PAD, pair_advance_ref, remap_search_iters
from repro_torch.io import ShardedWalkPool
from repro_torch.kernels import pair_advance as _pair_advance
from repro_torch.kernels import rng

__all__ = ["DistributedWalkEngine", "ring_owner_and_round"]

_log = logging.getLogger(__name__)
_I32 = torch.int32


def ring_owner_and_round(a, b, nb: int):
    """Owner rank and ring round for block pair (a, b), as int32 tensors.
    Takes ints or tensors; vectorised."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    d_ab = torch.remainder(b - a, nb)
    d_ba = torch.remainder(a - b, nb)
    tie = d_ab == d_ba  # nb even, distance nb/2
    a_owns = (d_ab < d_ba) | (tie & (a <= b))
    owner = torch.where(a_owns, a, b)
    rnd = torch.where(a_owns, d_ab, d_ba)
    same = a == b
    rnd = torch.where(same, 0, rnd)
    owner = torch.where(same, a, owner)
    return owner.to(_I32), rnd.to(_I32)


class DistributedWalkEngine:
    """Walks sharded over (data x model); blocks sharded over 'model'.

    Requires ``bg.num_blocks == mesh.size(block_axis)`` and a mesh over the
    whole world.  Walk state persists between sweeps through a
    :class:`repro_torch.io.ShardedWalkPool` on rank 0 (``pool``/
    ``pool_shards``/``pool_flush_walks``/``pool_dir``; pass a pool instance
    to share one across engines — the engine then never closes it).

    ``device`` (``"cuda"`` by default; raises without a card) is where the
    advance runs, ``advance_impl`` picks the CUDA kernel (``"cuda"``) or the
    plain PyTorch version (``"torch"``).  Exchanged tensors live where the
    mesh's backend needs them: on ``device`` for NCCL, on the host for gloo.
    """

    def __init__(
        self,
        bg: BlockedGraph,
        task: WalkTask,
        mesh: DeviceMesh,
        *,
        data_axes: Tuple[str, ...] = ("data",),
        block_axis: str = "model",
        capacity_factor: float = 2.0,
        k_max: int = 16,
        pool: Union[str, ShardedWalkPool] = "memory",
        pool_shards: Optional[int] = None,
        pool_flush_walks: Optional[int] = 1 << 18,
        pool_dir: Optional[str] = None,
        stats: Optional[IOStats] = None,
        device: Union[str, torch.device] = "cuda",
        advance_impl: str = "cuda",
    ):
        names = tuple(mesh.mesh_dim_names or ())
        dims = {ax: names.index(ax) for ax in (*data_axes, block_axis) if ax in names}
        missing = [ax for ax in (*data_axes, block_axis) if ax not in dims]
        if missing:
            raise ValueError(f"mesh has no axes {missing} (it has {names})")
        nb = mesh.size(dims[block_axis])
        if bg.num_blocks != nb:
            raise ValueError(
                f"num_blocks ({bg.num_blocks}) must equal mesh[{block_axis!r}] ({nb})"
            )
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"the mesh ({mesh.size()} ranks) must span the world "
                             f"({dist.get_world_size()} ranks)")  # fmt: skip
        if advance_impl not in ("cuda", "torch"):
            raise ValueError(f"advance_impl must be 'cuda' or 'torch', got {advance_impl!r}")
        self.device = resolve_device(device)
        self.advance_impl = advance_impl
        self.bg = bg
        self.task = task
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.block_axis = block_axis
        self.walk_axes = (*self.data_axes, block_axis)
        self.nb = nb
        self.capacity_factor = capacity_factor
        self.order = task.model.order
        self.rank = dist.get_rank()

        # the backend's rule for exchanged tensors
        self._bgroup = mesh.get_group(dims[block_axis])
        self.backend = str(dist.get_backend(self._bgroup))
        if "nccl" in self.backend and self.device.type == "cuda":
            self._xdev = self.device
        elif "gloo" in self.backend:
            self._xdev = torch.device("cpu")
        else:
            raise ValueError(f"process group backend {self.backend!r} cannot exchange the "
                             f"tensors of an engine on {self.device} (NCCL needs a CUDA "
                             f"device; gloo exchanges in host memory)")  # fmt: skip
        _log.info("DistributedWalkEngine: rank %d, backend %s, exchange on %s, advance on %s",
                  self.rank, self.backend, self._xdev, self.device)  # fmt: skip

        # this rank's place: its block, its walk shard, and every rank's shard
        sizes = {ax: mesh.size(d) for ax, d in dims.items()}
        self.block = mesh.get_local_rank(block_axis)
        self.wshards = int(np.prod([sizes[ax] for ax in self.walk_axes]))
        self.shard = 0
        for ax in self.walk_axes:
            self.shard = self.shard * sizes[ax] + mesh.get_local_rank(ax)
        ranks = mesh.mesh.cpu().numpy()
        self._shard_of_rank = np.zeros(ranks.size, np.int64)
        for coords in np.ndindex(*ranks.shape):
            s = 0
            for ax in self.walk_axes:
                s = s * sizes[ax] + coords[dims[ax]]
            self._shard_of_rank[int(ranks[coords])] = s
        i = self.block
        self._send_to = dist.get_global_rank(self._bgroup, (i - 1) % nb)
        self._recv_from = dist.get_global_rank(self._bgroup, (i + 1) % nb)

        # rank 0 owns the walk pool, as the JAX engine's single controller
        self.pool = None
        self._owns_pool = False
        if isinstance(pool, str):
            self.stats = stats if stats is not None else IOStats()
            if self.rank == 0:
                # one writer shard per block by default (shard_of_block
                # stripes, so num_shards == num_blocks is the identity)
                self.pool = ShardedWalkPool(
                    pool,
                    num_shards=nb if pool_shards is None else pool_shards,
                    num_blocks=nb,
                    stats=self.stats,
                    block_starts=bg.block_starts,
                    flush_walks=pool_flush_walks,
                    directory=pool_dir,
                )
                self._owns_pool = True
        else:
            self.pool = pool if self.rank == 0 else None
            # a shared pool charges the stats it was built with
            if stats is None:
                stats = getattr(pool, "stats", None)
            self.stats = stats if stats is not None else IOStats()
        first_order = task.model.order == 1
        trivial_nv = isinstance(task.model, Node2vec) and task.model.p == task.model.q == 1.0
        self.k_max = 1 if first_order or trivial_nv else k_max
        self.n_iters = int(np.ceil(np.log2(max(bg.max_block_edges, 2)))) + 2
        self._base_key = rng.key_halves(task.seed)
        self._block_starts = torch.as_tensor(bg.block_starts.astype(np.int32), device=self.device)
        self._own = self._own_block()
        self._own_dev = self._unpack(self._own)
        # what the last run did: sweeps' rounds, advances, seconds spent in
        # collectives
        self.rounds = 0
        self.advance_calls = 0
        self.collective_time = 0.0
        self._events = []
        if self._xdev.type == "cuda":
            # NCCL makes a group's communicator on its first collective:
            # make both here, so a run's collective time holds none of it
            t0 = time.perf_counter()
            for group in (self._bgroup, None):
                dist.all_reduce(torch.zeros(1, device=self._xdev), group=group)
            torch.cuda.synchronize(self._xdev)
            _log.info("DistributedWalkEngine: NCCL communicators made in %.3f s",
                      time.perf_counter() - t0)  # fmt: skip

    # -- the block shard ---------------------------------------------------
    def _own_block(self) -> torch.Tensor:
        """This rank's block, padded as the JAX engine pads every block
        (indptr to ``mv+1``, indices to ``me`` with -1), packed into one
        int32 tensor on the exchange device: ``[start, nverts]``, indptr,
        indices, then (weighted graphs only) alias_j and alias_q's bits."""
        bg = self.bg
        mv, me = bg.max_block_verts, bg.max_block_edges
        blk = bg.materialize_block(self.block)
        parts = [np.array([blk.start, blk.nverts], np.int32), np.zeros(mv + 1, np.int32),
                 np.full(me, -1, np.int32)]  # fmt: skip
        parts[1][:] = blk.indptr
        parts[2][:] = blk.indices
        if bg.has_weights:
            alias_j = np.zeros(me, np.int32)
            alias_q = np.ones(me, np.float32)
            if blk.alias_j is not None:
                alias_j[:], alias_q[:] = blk.alias_j, blk.alias_q
            parts += [alias_j, alias_q.view(np.int32)]
        return torch.as_tensor(np.concatenate(parts), device=self._xdev)

    def _unpack(self, packed: torch.Tensor):
        """``(vids, nverts, indptr, indices, alias_j, alias_q)`` of a packed
        block on the advance's device; ``vids`` is the remap
        ``start + arange(nverts)`` padded with ``VID_PAD``.  Unweighted
        blocks carry one-entry alias stand-ins, which the advance never
        reads."""
        mv, me = self.bg.max_block_verts, self.bg.max_block_edges
        p = packed.to(self.device)
        start, nv = p[0], p[1]
        k = torch.arange(mv, dtype=_I32, device=self.device)
        vids = torch.where(k < nv, start + k, VID_PAD)
        indptr = p[2 : mv + 3]
        indices = p[mv + 3 : mv + 3 + me]
        if self.bg.has_weights:
            alias_j = p[mv + 3 + me : mv + 3 + 2 * me]
            alias_q = p[mv + 3 + 2 * me :].view(torch.float32)
        else:
            alias_j = torch.zeros(1, dtype=_I32, device=self.device)
            alias_q = torch.ones(1, dtype=torch.float32, device=self.device)
        return vids, nv, indptr, indices, alias_j, alias_q

    # -- collectives -------------------------------------------------------
    def _timed(self, what: str, dev: torch.device, fn):
        """Run ``fn`` and book its seconds to ``what`` (``"exec"``:
        ``stats.exec_time``; ``"collective"``: ``collective_time``): on the
        host clock where ``dev`` is the host, else with CUDA events on the
        current stream, read when the run ends, so nothing waits for them."""
        if dev.type != "cuda":
            t0 = time.perf_counter()
            out = fn()
            self._book(what, time.perf_counter() - t0)
            return out
        stream = torch.cuda.current_stream(dev)
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
        out = fn()
        stop.record(stream)
        self._events.append((what, start, stop))
        return out

    def _book(self, what: str, seconds: float) -> None:
        if what == "exec":
            self.stats.exec_time += seconds
        else:
            self.collective_time += seconds

    def _read_events(self) -> None:
        for what, start, stop in self._events:
            stop.synchronize()
            self._book(what, start.elapsed_time(stop) / 1e3)
        self._events.clear()

    def _rotate(self, partner: torch.Tensor) -> torch.Tensor:
        """One ring hop of the partner block: block-axis rank i sends to
        i-1 and receives from i+1."""

        def hop():
            recv = torch.empty_like(partner)
            ops = [dist.P2POp(dist.isend, partner, self._send_to, self._bgroup),
                   dist.P2POp(dist.irecv, recv, self._recv_from, self._bgroup)]  # fmt: skip
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            return recv

        return self._timed("collective", self._xdev, hop)

    def _all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Row block j of ``x`` goes to block-axis rank j; the received
        blocks are stacked in source order."""

        def a2a():
            xs = x.to(self._xdev).contiguous()
            out = torch.empty_like(xs)
            dist.all_to_all_single(out, xs, group=self._bgroup)
            return out.to(self.device)

        return self._timed("collective", self._xdev, a2a)

    def _gather(self, local: torch.Tensor) -> np.ndarray:
        """Every rank's ``[W, 4]`` slice, as the global ``[N, 4]`` array in
        walk-shard order."""

        def gather():
            xs = local.to(self._xdev).contiguous()
            parts = [torch.empty_like(xs) for _ in range(dist.get_world_size())]
            dist.all_gather(parts, xs)
            return [p.cpu().numpy() for p in parts]

        parts = self._timed("collective", self._xdev, gather)
        out = np.empty((self.wshards, *parts[0].shape), np.int32)
        for rank, part in enumerate(parts):
            out[self._shard_of_rank[rank]] = part
        return out.reshape(-1, parts[0].shape[-1])

    def _scatter(self, state: Optional[np.ndarray], W: int) -> torch.Tensor:
        """Rank 0 sends each rank its ``[W, 4]`` slice of the global
        ``state``; returns this rank's, on the advance's device."""

        def scatter():
            out = torch.empty((W, 4), dtype=_I32, device=self._xdev)
            parts = None
            if self.rank == 0:
                parts = [torch.as_tensor(state[s * W : (s + 1) * W], device=self._xdev)
                         for s in self._shard_of_rank]  # fmt: skip
            dist.scatter(out, parts, src=0)
            return out.to(self.device)

        return self._timed("collective", self._xdev, scatter)

    # -- the sweep ---------------------------------------------------------
    def _blk_of(self, v: torch.Tensor) -> torch.Tensor:
        b = torch.searchsorted(self._block_starts, v, right=True) - 1
        return b.clamp(0, self.nb - 1).to(_I32)

    def _route(self, state, wid0, t: int, capacity: int):
        """Round ``t``'s routing: each walk whose pair is resident this
        round goes to its owner at its order-preserving slot among walks to
        the same owner; a slot past ``capacity`` waits.  Returns the send
        buffer ``[nb * capacity, 5]`` (unrouted rows -1) and each walk's
        flat slot (``nb * capacity`` where it is not routed)."""
        nb = self.nb
        prev, cur, hop, alive = state.t().contiguous()
        alive = alive > 0
        OOB = nb * capacity
        owner, rnd = ring_owner_and_round(self._blk_of(prev), self._blk_of(cur), nb)
        is_init = hop == 0
        owner = torch.where(is_init, self._blk_of(cur), owner)
        rnd = torch.where(is_init, t, rnd)
        want = alive & (rnd == t)
        dest = torch.where(want, owner, nb).long()
        # slot: rank among the walks with the same destination, in order
        W = dest.shape[0]
        order = torch.argsort(dest, stable=True)
        counts = torch.bincount(dest, minlength=nb + 1)
        first = torch.cumsum(counts, 0) - counts
        slot = torch.empty_like(dest)
        slot[order] = torch.arange(W, device=dest.device) - first[dest[order]]
        routed = want & (slot < capacity)
        flat = torch.where(routed, dest * capacity + slot, OOB)
        payload = torch.cat([state, wid0[:, None]], 1)
        # unrouted walks land in a spare last row, which is cut off
        send = torch.full((OOB + 1, 5), -1, dtype=_I32, device=state.device)
        send[flat] = payload
        return send[:OOB], flat

    def _advance_inputs(self, pair, recv: torch.Tensor):
        """The pair advance's arguments for the received rows: the padded
        own + partner pair, one lane per row (rows nobody routed go in as
        walk 0, not alive), the task's scalars; returns ``(args, kwargs,
        rows routed)``."""
        task = self.task
        length = int(task.length)
        mv, me = self.bg.max_block_verts, self.bg.max_block_edges
        (ov, onv, optr, oind, oaj, oaq), (pv, pnv, pptr, pind, paj, paq) = pair
        dev = self.device
        i32 = lambda xs: torch.tensor(xs, dtype=_I32, device=dev)
        if self.bg.has_weights:
            alias_j, alias_q = torch.cat([oaj, paj]), torch.cat([oaq, paq])
        else:
            alias_j, alias_q = oaj, oaq
        cols = recv.t().contiguous()
        rmask = cols[0] >= 0
        args = (
            torch.cat([ov, pv]), torch.stack([onv, pnv]), i32([0, mv]),
            torch.cat([optr, pptr]), i32([0, mv + 1]), torch.cat([oind, pind]), i32([0, me]),
            alias_j, alias_q,
            torch.where(rmask, cols[4], 0), cols[0], cols[1], cols[2], (cols[3] > 0) & rmask,
            self._base_key, length, float(task.decay), float(getattr(task.model, "p", 1.0)),
            float(getattr(task.model, "q", 1.0)),
        )  # fmt: skip
        kwargs = dict(
            order=self.order,
            k_max=self.k_max,
            n_iters=self.n_iters,
            v_iters=remap_search_iters(mv),
            record=False,
            has_alias=self.bg.has_weights,
            max_len=length,
        )
        return args, kwargs, rmask

    def _advance(self, pair, recv: torch.Tensor) -> torch.Tensor:
        """Advance the received rows on the resident pair; returns
        ``[rows, 4]`` (prev, cur, hop, alive), -1 on rows nobody routed."""
        args, kwargs, rmask = self._advance_inputs(pair, recv)
        if self.advance_impl == "cuda":
            advance = _pair_advance.fused_advance_pair
        else:
            advance = pair_advance_ref

        def step():
            nprev, ncur, nhop, nalive, _, _ = advance(*args, **kwargs)
            back = torch.stack([nprev, ncur, nhop, nalive.to(_I32)], 1)
            return torch.where(rmask[:, None], back, -1)

        self.advance_calls += 1
        return self._timed("exec", self.device, step)

    def _sweep(self, state: torch.Tensor, capacity: int) -> torch.Tensor:
        """One half-ring sweep over this rank's ``[W, 4]`` walk slice."""
        W = state.shape[0]
        wid0 = self.shard * W + torch.arange(W, dtype=_I32, device=self.device)
        own = self._own_dev
        partner = self._own
        for t in range(1, max(self.nb // 2, 1) + 1):
            if self.nb > 1:  # at one block the ring hop is the identity
                partner = self._rotate(partner)
            send, flat = self._route(state, wid0, t, capacity)
            recv = self._all_to_all(send)
            pair = (own, own if partner is self._own else self._unpack(partner))
            back = self._all_to_all(self._advance(pair, recv))
            # invert the routing: flat slot -> local walk index (unrouted
            # walks write the spare last row, which is cut off)
            home = torch.full((send.shape[0] + 1,), -1, dtype=torch.long, device=self.device)
            home[flat] = torch.arange(W, device=self.device)
            home = home[:-1]
            valid = (back[:, 0] >= 0) & (home >= 0)
            state = state.clone()
            state[home[valid]] = back[valid]
            self.rounds += 1
        return state

    # -- walk persistence through the shared pool (rank 0) -------------------
    def _persist_frontier(self, src0, prev, cur, hop, alive) -> None:
        """Push the live frontier into the pool in walk-id order through
        the persist helper every engine uses; walk ids ride along so the
        drain can scatter each walk back to its slot."""
        live = np.nonzero(alive)[0]
        if live.size == 0:
            return
        batch = WalkBatch(src0[live], prev[live], cur[live], hop[live])
        push_by_block_assignment(
            self.pool, self.bg.block_starts, self.order, batch, live.astype(np.int64)
        )

    def _drain_frontier(self, n_slots: int):
        """Drain every block pool (all drains enqueued first, in block
        order) and rebuild the dense sweep arrays by walk id."""
        prev = np.zeros(n_slots, np.int32)
        cur = np.zeros(n_slots, np.int32)
        hop = np.zeros(n_slots, np.int32)
        alive = np.zeros(n_slots, bool)
        pending = [b for b in range(self.nb) if self.pool.counts[b] > 0]
        for fut in [self.pool.drain_async(b) for b in pending]:
            (batch, wid), _n_walks, _n_spilled = fut.result()
            prev[wid] = batch.prev
            cur[wid] = batch.cur
            hop[wid] = batch.hop
            alive[wid] = True
        return prev, cur, hop, alive

    # -- the run loop -------------------------------------------------------
    def run(self, max_sweeps: Optional[int] = None) -> dict:
        """Walk every task walk to its end (or ``max_sweeps``).  Every rank
        returns the global ``prev``/``cur``/``hop``/``alive`` and ``sweeps``;
        rank 0's ``stats`` carries the walk-I/O charges."""
        task, bg = self.task, self.bg
        src = task.initial_walks(bg.num_vertices).astype(np.int32)
        n = src.shape[0]
        wshards = self.wshards
        N = int(np.ceil(n / wshards) * wshards)
        W = N // wshards
        pad = N - n
        src0 = np.concatenate([src, np.zeros(pad, np.int32)])
        capacity = max(int(np.ceil((N / wshards) / self.nb * self.capacity_factor)), 8)

        # the result arrays accumulate every walk's final state (a retired
        # walk's slot is last written the sweep it died in)
        live = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
        init = np.stack([src0, src0, np.zeros(N, np.int32), live.astype(np.int32)], 1)
        res = init.copy()
        lo = self.shard * W
        state = torch.as_tensor(init[lo : lo + W], device=self.device)

        self.rounds = self.advance_calls = 0
        self.collective_time = 0.0
        sweeps = 0
        limit = max_sweeps if max_sweeps is not None else task.length + 8
        try:
            while sweeps < limit and live.any():
                out = self._gather(self._sweep(state, capacity))
                sweeps += 1
                # only walks alive going into the sweep were advanced there
                res[live] = out[live]
                live = out[:, 3] > 0
                if not live.any():
                    break
                frontier = None
                if self.rank == 0:
                    self._persist_frontier(src0, *out[:, :3].T, live)
                    *drained, drained_alive = self._drain_frontier(N)
                    if not np.array_equal(drained_alive, live):
                        raise RuntimeError("the walk pool did not return the live frontier")
                    frontier = np.stack([*drained, drained_alive.astype(np.int32)], 1)
                state = self._scatter(frontier, W)
        finally:
            self._read_events()
            if self._owns_pool:
                self.pool.close()
        return {
            "prev": res[:n, 0].copy(),
            "cur": res[:n, 1].copy(),
            "hop": res[:n, 2].copy(),
            "alive": res[:n, 3] > 0,
            "sweeps": sweeps,
            "stats": self.stats,
        }
