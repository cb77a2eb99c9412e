"""The pair advance shared by the engines, as plain PyTorch.

Vectorised Alg. 2 ``UpdateWalk`` over a *view pair* — the port of the
jitted pair advance of ``repro/engines/step.py``.  :func:`pair_advance_ref` is
the plain version of the hand-written CUDA kernel in
:mod:`repro_torch.kernels.pair_advance`: the CPU path of the kernel's
wrapper, and what the kernel is held against on the card.

* **Views, not blocks.**  The resident pair is two
  :class:`~repro_torch.core.graph.BlockView`\\ s packed into flat ragged
  arrays.  A global vertex resolves to its compact row by binary search over
  the view's sorted ``vids`` remap; a walk that reaches a vertex with no row
  in the pair stops being *resident* (it stays alive) and the host engine
  routes it or extends the view.
* **Counter-based per-walk RNG.**  Every draw is keyed by
  ``(base_key, walk_id, hop, round)`` through :mod:`repro_torch.kernels.rng`,
  so a walk's trajectory is a pure function of the task seed and its walk
  id — the same bits as the JAX package's advance.

Gathers clamp their index to ``[0, len-1]`` as jnp indexing does: masked
lanes read padded slots, and an order-2 ``prev`` that misses the pair reads
``indptr`` one past its segment.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sampling import _take, alias_draw, lower_bound_rows, searchsorted_rows
from repro_torch.kernels import rng

__all__ = [
    "VID_PAD",
    "accept_thresholds",
    "lower_bound_rows",
    "pair_advance_ref",
    "pow2_pad",
    "remap_search_iters",
    "searchsorted_rows",
]

#: vids padding value — sorts after every real vertex id
VID_PAD = np.iinfo(np.int32).max


def remap_search_iters(n: int) -> int:
    """Binary-search depth for a remap (``vids``) segment of ``n`` entries —
    the single source of the ``v_iters`` static the kernel consumes."""
    return int(np.ceil(np.log2(max(n, 2)))) + 1


def pow2_pad(n: int, lo: int = 256) -> int:
    """Next power of two >= n (>= lo) — the lane padding of every advance."""
    m = lo
    while m < n:
        m <<= 1
    return m


def accept_thresholds(p: float, q: float) -> tuple:
    """Node2vec acceptance ``{1/p, 1, 1/q} / max(1, 1/p, 1/q)`` in float32,
    rounded exactly as the reference computes them on the device.  Returns
    ``(acc_return, acc_neighbor, acc_away)`` as ``np.float32``."""
    one = np.float32(1.0)
    inv_p = one / np.float32(p)
    inv_q = one / np.float32(q)
    max_bias = np.maximum(one, np.maximum(inv_p, inv_q))
    return inv_p / max_bias, one / max_bias, inv_q / max_bias


def pair_advance_ref(
    vids,  # [SV] i32 — both slots' sorted global vertex ids, concatenated
    nverts,  # [2] i32  — valid vids per slot
    vid_base,  # [2] i32  — offset of each slot's segment within vids
    indptr,  # [SP] i32 — concatenated compact local offsets
    ptr_base,  # [2] i32  — offset of each slot's indptr segment
    indices,  # [SE] i32 — concatenated global neighbor ids, sorted per row
    ind_base,  # [2] i32  — offset of each slot's indices segment
    alias_j,  # [SE] i32 — row-local alias slots ([1] dummy if not has_alias)
    alias_q,  # [SE] f32
    wid,  # [N] i32  — walk ids (the per-walk RNG stream identity)
    prev,  # [N] i32
    cur,  # [N] i32
    hop,  # [N] i32
    alive,  # [N] bool — not yet terminated
    key,  # (k0, k1) — raw halves of the task's base key
    length: int,  # walk length in edges
    decay: float,  # per-step continue probability (1.0 = fixed length)
    p: float,  # node2vec return parameter
    q: float,  # node2vec in-out parameter
    *,
    order: int,
    k_max: int,
    n_iters: int,
    v_iters: int,
    record: bool,
    has_alias: bool,
    max_len: int,
    max_hops: int | None = None,
    corpus: torch.Tensor | None = None,  # [W, max_len+1] i32 — the walks, by walk id
):
    """Advance every walk until it leaves the resident view pair or
    terminates, for at most ``max_hops`` hops (``None`` means
    ``max_len + 1``, the full sweep; 1 is the single-hop form).  Returns
    ``(prev, cur, hop, alive, steps, trace)``, where
    ``trace[n, h]`` is the vertex walk n reached at hop h during this call
    (-1 = no move); ``trace`` is ``[N, max_len+1]``, or ``[1, 1]`` when not
    recording.  Recording with a ``corpus``, the vertex goes to
    ``corpus[wid[n], h]`` in place instead, and ``trace`` is ``[1, 1]``.

    The ``k_max`` proposal rounds of one hop are drawn together as a
    ``[k_max, N]`` batch, and each lane takes its first accepted round —
    the same walk as the reference's sequential rounds.  The draws of one
    hop come from two cipher calls over stacked counters: round folds
    ``0..k_max`` (``k_max`` is the termination draw), then the counters
    ``(0,2)``, ``(1,0)`` and ``(0,0)`` of ``uniform3`` and ``uniform1``.
    """
    dev = prev.device
    i64 = torch.int64
    N = prev.shape[0]
    nv0, nv1 = (int(x) for x in nverts.tolist())
    vb0, vb1 = (int(x) for x in vid_base.tolist())
    pb0, pb1 = (int(x) for x in ptr_base.tolist())
    ib0, ib1 = (int(x) for x in ind_base.tolist())
    vids = vids.to(i64)
    indptr = indptr.to(i64)
    indices = indices.to(i64)
    alias_j = alias_j.to(i64)
    acc_ret, acc_nbr, acc_away = (
        torch.tensor(float(a), dtype=torch.float32, device=dev) for a in accept_thresholds(p, q)
    )
    decay32 = torch.tensor(float(np.float32(decay)), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)

    prev = prev.to(i64)
    cur = cur.to(i64)
    hop = hop.to(i64)
    hop_in = hop
    alive = alive.to(torch.bool)
    # per-walk streams: fold the walk id in once, the hop/round per draw
    kwid = rng.fold_in(key[0], key[1], wid)
    rounds = torch.arange(k_max + 1, dtype=i64, device=dev)[:, None]
    ctr0 = torch.tensor([0, 1, 0], dtype=i64, device=dev)[:, None, None]
    ctr1 = torch.tensor([2, 0, 0], dtype=i64, device=dev)[:, None, None]
    seg_lo = torch.tensor([vb0, vb1], dtype=i64, device=dev)[:, None]
    seg_hi = torch.tensor([vb0 + nv0, vb1 + nv1], dtype=i64, device=dev)[:, None]
    # one spare "dump" column (max_len+1) absorbs writes of frozen walks
    into_corpus = record and corpus is not None
    trace_shape = (N, max_len + 2) if record and not into_corpus else (1, 1)
    trace = torch.full(trace_shape, -1, dtype=torch.int32, device=dev)
    lanes = torch.arange(N, device=dev)

    def locate(v):
        """Resolve global vertex -> (slot, compact row, found) via the remap;
        both slots' segments are searched as one [2, N] batch."""
        r, f = lower_bound_rows(
            vids, seg_lo.expand(2, N), seg_hi.expand(2, N), v[None, :], n_iters=v_iters
        )
        slot = torch.where(f[0], 0, 1)
        row = torch.where(f[0], r[0] - vb0, r[1] - vb1).clamp(min=0)
        return slot, row, f[0] | f[1]

    slot, row, found = locate(cur)
    resident = alive & found
    hops = max_len + 1 if max_hops is None else max_hops
    it = 0
    while it < hops and bool(resident.any()):
        kw0, kw1 = rng.fold_in(kwid[0], kwid[1], hop)

        movable = resident  # alive & cur has a row in the pair
        pslot = torch.where(slot == 0, pb0, pb1)
        row_start = _take(indptr, pslot + row)
        deg = _take(indptr, pslot + row + 1) - row_start
        dead = movable & (deg <= 0)
        movable = movable & (deg > 0)
        deg_c = deg.clamp(min=1)
        islot = torch.where(slot == 0, ib0, ib1)

        # ---- proposal + rejection: all k_max rounds as one [k_max, N] batch --
        r0, r1 = rng.fold_in(kw0[None, :], kw1[None, :], rounds)
        c0, c1 = rng.threefry2x32(r0[None], r1[None], ctr0, ctr1)
        u1 = rng.bits_to_unit(c0[0, :k_max])
        u2 = rng.bits_to_unit(c0[1, :k_max])
        u3 = rng.bits_to_unit(c1[0, :k_max])
        if has_alias:
            kloc = alias_draw(alias_j, alias_q, islot + row_start, deg_c, u1, u2).to(i64)
        else:
            kloc = torch.minimum((u1 * deg_c.to(torch.float32)).to(i64), deg_c - 1)
        idx = islot + row_start + kloc
        zk = _take(indices, idx)
        if order == 2:
            uslot, urow, _ = locate(prev)
            pu = torch.where(uslot == 0, pb0, pb1)
            u_start = _take(indptr, pu + urow)
            ulo = torch.where(uslot == 0, ib0, ib1) + u_start
            uhi = ulo + (_take(indptr, pu + urow + 1) - u_start)
            memb = searchsorted_rows(
                indices, ulo.expand_as(zk), uhi.expand_as(zk), zk, n_iters=n_iters
            )
            acc = torch.where(zk == prev, acc_ret, torch.where(memb, acc_nbr, acc_away))
            acc = torch.where(hop == 0, one, acc)  # first step: 1st-order
        else:
            acc = one.expand_as(u3)
        ok = u3 < acc
        ok[k_max - 1] = True  # the last round always accepts
        first = ok.to(torch.int32).argmax(dim=0)
        z = zk.gather(0, first[None, :])[0]

        # ---- commit ----------------------------------------------------------
        u_term = rng.bits_to_unit(c0[2, k_max])
        new_hop = hop + movable.to(i64)
        new_prev = torch.where(movable, cur, prev)
        new_cur = torch.where(movable, z, cur)
        finished = movable & (new_hop >= length)
        stopped = movable & (u_term >= decay32)
        alive = alive & ~dead & ~finished & ~stopped
        slot, row, found = locate(new_cur)
        resident = alive & found
        if into_corpus:
            cols = new_hop.clamp(0, max_len)
            corpus[wid[movable].to(i64), cols[movable]] = new_cur[movable].to(torch.int32)
        elif record:
            cols = torch.where(movable, new_hop.clamp(0, max_len), max_len + 1)
            trace[lanes, cols] = new_cur.to(torch.int32)
        prev, cur, hop = new_prev, new_cur, new_hop
        it += 1

    steps = (hop - hop_in).sum().to(torch.int32)
    if record and not into_corpus:
        trace = trace[:, : max_len + 1]
    i32 = torch.int32
    return prev.to(i32), cur.to(i32), hop.to(i32), alive, steps, trace
