"""Samplers (PyTorch port): alias tables (first-order draws) and the
pieces of the second-order rejection sampler used by the Node2vec
transition — the port of the JAX package's ``core/sampling.py``.

Everything exists twice:
  * host numpy constructors (graph preprocessing — alias tables per block,
    reached lazily by the weighted paths of :mod:`repro_torch.core.graph`
    and :mod:`repro_torch.io.blockfile`), and
  * batched tensor step functions (:func:`alias_draw`,
    :func:`searchsorted_rows` / :func:`membership`,
    :func:`node2vec_accept_prob`), which run on whatever device their input
    tensors live on and give the JAX functions' bits.  The plain pair
    advance (:mod:`repro_torch.engines.step`) draws through
    :func:`alias_draw` and probes membership through
    :func:`searchsorted_rows`; it does not use :func:`membership` or
    :func:`node2vec_accept_prob`, which stay for parity with the JAX
    module.  Its acceptance rule is ``accept_thresholds`` (the kernel's
    rounding: float32 ``1/p`` etc. divided by float32 ``M``), which can
    differ from :func:`node2vec_accept_prob`'s in the last bit.

Gathers clamp their index to ``[0, len-1]``, as jnp indexing does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "build_alias",
    "build_alias_rows",
    "alias_draw_np",
    "alias_draw",
    "searchsorted_rows",
    "membership",
    "node2vec_accept_prob",
]


def build_alias(probs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Classic O(n) alias construction for one distribution.

    Returns (J, q): draw slot k uniformly, draw r ~ U[0,1); result is k if
    r < q[k] else J[k].
    """
    probs = np.asarray(probs, dtype=np.float64)
    n = probs.shape[0]
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.float32)
    s = probs.sum()
    if s <= 0:
        probs = np.full(n, 1.0 / n)
    else:
        probs = probs / s
    q = probs * n
    J = np.arange(n, dtype=np.int32)
    small = [i for i in range(n) if q[i] < 1.0]
    large = [i for i in range(n) if q[i] >= 1.0]
    while small and large:
        s_i = small.pop()
        l_i = large.pop()
        J[s_i] = l_i
        q[l_i] = q[l_i] - (1.0 - q[s_i])
        if q[l_i] < 1.0:
            small.append(l_i)
        else:
            large.append(l_i)
    return J.astype(np.int32), np.minimum(q, 1.0).astype(np.float32)


def build_alias_rows(
    indptr: np.ndarray, nverts: int, pad_len: int, weights: Optional[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-vertex alias tables over a block's CSR rows, stored edge-aligned
    and padded to ``pad_len`` (so tables stack uniformly across blocks).

    ``J`` holds *local* (within-row) alias indices so a row's table is
    position-independent — the engine adds the row offset at draw time.
    """
    pad_len = max(pad_len, 1)
    J = np.zeros(pad_len, dtype=np.int32)
    q = np.ones(pad_len, dtype=np.float32)
    for v in range(nverts):
        s, e = int(indptr[v]), int(indptr[v + 1])
        if e <= s:
            continue
        w = weights[s:e] if weights is not None else np.ones(e - s)
        Jr, qr = build_alias(w)
        J[s:e] = Jr
        q[s:e] = qr
    return J, q


def alias_draw_np(
    J: np.ndarray,
    q: np.ndarray,
    row_start: np.ndarray,
    row_deg: np.ndarray,
    u1: np.ndarray,
    u2: np.ndarray,
) -> np.ndarray:
    """Vectorised alias draw (numpy). Returns *local* neighbor slot per row."""
    k = np.minimum((u1 * row_deg).astype(np.int64), row_deg - 1)
    idx = row_start + k
    take_alias = u2 >= q[idx]
    return np.where(take_alias, J[idx].astype(np.int64), k)


def _take(flat, idx):
    """``flat[idx]`` with the index clamped to the array, as jnp gathers."""
    return flat[idx.clamp(0, flat.shape[0] - 1)]


def alias_draw(J, q, row_start, row_deg, u1, u2):
    """Tensor twin of :func:`alias_draw_np` (int32 local slots): slot
    ``k = clamp(int(u1 * deg), 0, deg - 1)``, redirected to ``J[row_start +
    k]`` when ``u2 >= q[row_start + k]``."""
    k = torch.minimum((u1 * row_deg).to(torch.int32), row_deg - 1)
    k = k.clamp(min=0)
    idx = row_start + k
    take_alias = u2 >= _take(q, idx)
    return torch.where(take_alias, _take(J, idx), k)


# ---------------------------------------------------------------------------
# Membership probe: z in N(u) via binary search over sorted adjacency rows
# ---------------------------------------------------------------------------


def lower_bound_rows(flat, lo, hi, z, *, n_iters: int):
    """Batched lower bound of ``z`` within the sorted slice ``flat[lo:hi]``.

    Branch-free fixed-iteration binary search (``n_iters`` halvings), what
    the kernel runs per lane.  Returns ``(pos, found)``.
    """
    hi0 = hi
    for _ in range(n_iters):
        mid = (lo + hi) // 2
        val = _take(flat, mid)
        valid = lo < hi
        go_right = valid & (val < z)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(valid & ~go_right, mid, hi)
    return lo, (lo < hi0) & (_take(flat, lo) == z)


def searchsorted_rows(indices, lo, hi, z, *, n_iters: int):
    """Batched binary search of ``z`` within ``indices[lo:hi]`` (sorted
    rows), ``n_iters = ceil(log2(max_row_len)) + 1`` halvings.  Returns True
    iff found (the second-order membership probe)."""
    return lower_bound_rows(indices, lo, hi, z, n_iters=n_iters)[1]


def membership(indices, lo, hi, z, *, n_iters: int):
    """True iff z appears in the sorted slice indices[lo:hi]."""
    return searchsorted_rows(indices, lo, hi, z, n_iters=n_iters)


# ---------------------------------------------------------------------------
# Node2vec acceptance
# ---------------------------------------------------------------------------


def node2vec_accept_prob(z, u, is_neighbor_of_u, p: float, q: float):
    """`a'_vz / (M a_vz)` with M = max(1, 1/p, 1/q)  (Eq. 1, unweighted bias),
    as float32.

    h_uz = 0 (z == u)        -> 1/p
    h_uz = 1 (z in N(u))     -> 1
    h_uz = 2 (otherwise)     -> 1/q

    Rounded as the JAX function rounds: each bias is ``1/p`` etc. in double,
    rounded to float32, then divided by float32 ``M`` in float32.
    """
    M = np.float32(max(1.0, 1.0 / p, 1.0 / q))
    dev = z.device
    ret, nbr, away = (
        torch.tensor(np.float32(b) / M, dtype=torch.float32, device=dev)
        for b in (1.0 / p, 1.0, 1.0 / q)
    )
    return torch.where(z == u, ret, torch.where(is_neighbor_of_u, nbr, away))
