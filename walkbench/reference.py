"""The plain reference that decides ``correct``: node2vec walks in PyTorch.

It imports neither the program nor JAX.  From the benchmark's edge list it
builds the undirected simple graph again (both directions, loops dropped,
duplicates merged, each vertex's neighbours in ascending order) and walks
every walk of a task, all walks in lock step, one hop at a time.

The walk semantics that the program guarantees, and this module follows:

* walk ``w`` of a task starts at ``sources[w]``; every draw of hop ``h`` is
  keyed by ``(task seed, w, h, round)`` through Threefry-2x32 (20 rounds;
  Salmon et al., SC'11) as JAX's ``fold_in`` / ``uniform`` lay the counters
  out: key ``(0, seed mod 2**32)``, ``fold_in(k, d) = threefry(k, (0, d))``,
  a round's draws ``u1, u3`` are words 0 and 1 of ``threefry(k_r, (0, 2))``
  and the stop draw is word 0 of ``threefry(k_stop, (0, 0))``;
* a draw is float32 in [0, 1): the top 23 bits over 2**23;
* a proposal is neighbour ``min(trunc(u1 * deg), deg - 1)`` in float32;
  node2vec accepts it when ``u3 < {1/p, 1, 1/q}[return, neighbour of the
  previous vertex, farther] / max(1, 1/p, 1/q)`` (float32); the first hop
  accepts at once, and the last of ``k_max`` rounds always accepts;
* after a move the walk ends at ``length`` hops, or when the stop draw of
  the hop is ``>= decay`` (float32); a walk at a vertex with no neighbour
  ends there without moving.

``draw_dtype`` lowers the precision of the draws and of the proposal
product: ``torch.bfloat16`` is the control that ``correct`` must reject.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

__all__ = [
    "Adjacency",
    "Walks",
    "build_adjacency",
    "threefry2x32",
    "unit_float",
    "walk",
]

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds; words are int64 tensors in [0, 2**32)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    y0 = (x0 + k0) & MASK
    y1 = (x1 + k1) & MASK
    for i in range(20):
        r = _ROTATIONS[i % 8]
        y0 = (y0 + y1) & MASK
        y1 = ((y1 << r) & MASK) | (y1 >> (32 - r))
        y1 = y1 ^ y0
        if i % 4 == 3:
            s = i // 4 + 1
            y0 = (y0 + ks[s % 3]) & MASK
            y1 = (y1 + ks[(s + 1) % 3] + s) & MASK
    return y0, y1


def unit_float(bits: torch.Tensor) -> torch.Tensor:
    """Random 32-bit words -> float32 in [0, 1): the top 23 bits / 2**23."""
    return (bits >> 9).to(torch.float32) * (2.0**-23)


@dataclass
class Adjacency:
    num_vertices: int
    indptr: torch.Tensor  # [V + 1] int64
    neighbours: torch.Tensor  # [E] int64, ascending within each vertex
    keys: torch.Tensor  # [E] int64, u * V + v, ascending

    def has_edge(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        key = u * self.num_vertices + v
        pos = torch.searchsorted(self.keys, key).clamp(max=self.keys.numel() - 1)
        return self.keys[pos] == key


def build_adjacency(edges: np.ndarray, num_vertices: int, device) -> Adjacency:
    """The undirected simple graph of a directed edge list ``[M, 2]``."""
    e = torch.as_tensor(np.ascontiguousarray(edges), dtype=torch.int64, device=device)
    u = torch.cat([e[:, 0], e[:, 1]])
    v = torch.cat([e[:, 1], e[:, 0]])
    del e
    loop = u == v
    keys = torch.unique(u[~loop] * num_vertices + v[~loop])  # sorted
    del u, v, loop
    src = keys // num_vertices
    deg = torch.bincount(src, minlength=num_vertices)
    indptr = torch.zeros(num_vertices + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(deg, 0, out=indptr[1:])
    return Adjacency(num_vertices, indptr, keys - src * num_vertices, keys)


@dataclass
class Walks:
    endpoint_counts: torch.Tensor  # [V] int64
    steps: int
    corpus: Optional[torch.Tensor]  # [W, length + 1] int32, -1 past the end


def _accept_thresholds(p: float, q: float):
    one = np.float32(1.0)
    inv_p, inv_q = one / np.float32(p), one / np.float32(q)
    top = max(one, inv_p, inv_q)
    return float(inv_p / top), float(one / top), float(inv_q / top)


def _propose(adj, h0, h1, start, deg, prev, rounds, *, first_hop, dtype, thresholds):
    """Round(s) ``rounds`` of the proposal for walks at hop key ``(h0, h1)``:
    returns the candidates and whether each is accepted (broadcast over a
    leading axis of rounds when ``rounds`` is a column)."""
    r0, r1 = threefry2x32(h0, h1, 0, rounds)
    b0, b1 = threefry2x32(r0, r1, 0, 2)
    u1 = unit_float(b0).to(dtype)
    u3 = unit_float(b1).to(dtype)
    pick = torch.minimum((u1 * deg.to(dtype)).to(torch.int64), deg - 1)
    z = adj.neighbours[start + pick]
    if first_hop:
        return z, torch.ones_like(z, dtype=torch.bool)
    acc_ret, acc_nbr, acc_away = thresholds
    prev = prev.expand_as(z)
    thr = torch.where(z == prev, acc_ret, torch.where(adj.has_edge(prev, z), acc_nbr, acc_away))
    return z, u3 < thr.to(dtype)


def walk(
    adj: Adjacency,
    sources: torch.Tensor,
    *,
    seed: int,
    length: int,
    p: float,
    q: float,
    decay: float,
    k_max: int,
    record: bool,
    draw_dtype: torch.dtype = torch.float32,
) -> Walks:
    """Every walk of one task, from ``sources`` (walk ids ``0..W-1``)."""
    dev = adj.indptr.device
    i64 = torch.int64
    sources = sources.to(device=dev, dtype=i64)
    n = sources.numel()
    thresholds = _accept_thresholds(p, q)
    decay32 = float(np.float32(decay))
    wid = torch.arange(n, device=dev, dtype=i64)
    kw0, kw1 = threefry2x32(0, int(seed) & MASK, torch.zeros_like(wid), wid)
    cur = sources.clone()
    prev = sources.clone()
    hops = torch.zeros(n, dtype=i64, device=dev)
    ends = torch.zeros(adj.num_vertices, dtype=i64, device=dev)
    corpus = None
    if record:
        corpus = torch.full((n, length + 1), -1, dtype=torch.int32, device=dev)
        corpus[:, 0] = sources.to(torch.int32)
    live = wid  # walks still going, all at hop h
    for h in range(length):
        if live.numel() == 0:
            break
        c = cur[live]
        start = adj.indptr[c]
        deg = adj.indptr[c + 1] - start
        stuck = deg == 0
        if bool(stuck.any()):
            ends.index_add_(0, c[stuck], torch.ones_like(c[stuck]))
            live, c, start, deg = live[~stuck], c[~stuck], start[~stuck], deg[~stuck]
        m = live.numel()
        if m == 0:
            break
        pv = prev[live]
        h0, h1 = threefry2x32(kw0[live], kw1[live], 0, h)
        nxt, ok = _propose(adj, h0, h1, start, deg, pv, 0, first_hop=h == 0, dtype=draw_dtype,
                           thresholds=thresholds)  # fmt: skip
        retry = torch.nonzero(~ok).squeeze(1)
        if retry.numel() and k_max > 1:
            # rounds 1 .. k_max-1 of the walks round 0 rejected, drawn together;
            # each walk takes its first accepted round, the last always accepts
            rounds = torch.arange(1, k_max, device=dev, dtype=i64)[:, None]
            z, ok = _propose(
                adj, h0[retry], h1[retry], start[retry], deg[retry], pv[retry], rounds,
                first_hop=False, dtype=draw_dtype, thresholds=thresholds,
            )  # fmt: skip
            ok[-1] = True
            first = ok.to(torch.int8).argmax(dim=0)
            nxt[retry] = z.gather(0, first[None, :])[0]
        prev[live] = c
        cur[live] = nxt
        hops[live] = h + 1
        if record:
            corpus[live, h + 1] = nxt.to(torch.int32)
        if h + 1 >= length:
            done = torch.ones(m, dtype=torch.bool, device=dev)
        elif decay < 1.0:
            s0, s1 = threefry2x32(h0, h1, 0, k_max)
            t0, _ = threefry2x32(s0, s1, 0, 0)
            done = unit_float(t0).to(draw_dtype) >= decay32
        else:
            done = torch.zeros(m, dtype=torch.bool, device=dev)
        ends.index_add_(0, nxt[done], torch.ones_like(nxt[done]))
        live = live[~done]
    return Walks(ends, int(hops.sum()), corpus)
