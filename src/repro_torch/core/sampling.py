"""Alias tables (Walker's method): the host numpy half of the JAX package's
``core/sampling.py``.

The batched step functions of the original (draws, membership probes,
acceptance) live in :mod:`repro_torch.engines.step` and the CUDA kernel;
what stays here is graph preprocessing, reached lazily by the weighted
paths of :mod:`repro_torch.core.graph` and :mod:`repro_torch.io.blockfile`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["build_alias", "build_alias_rows", "alias_draw_np"]


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
