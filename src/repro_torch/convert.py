"""Carry graph and RNG state from the JAX package into the port.

Both packages speak numpy at their edges, so a graph built and blocked by
``repro`` (a ``CSRGraph`` and its ``block_starts``) crosses over as plain
arrays.  Nothing here imports ``repro`` or ``jax``.

    from repro_torch.convert import blocked_graph_from_arrays
    bg = blocked_graph_from_arrays(g.indptr, g.indices, g.weights, bg_jax.block_starts)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.graph import BlockedGraph, CSRGraph
from repro_torch.kernels import rng

__all__ = ["blocked_graph_from_arrays", "key_halves_from_seed"]


def blocked_graph_from_arrays(
    indptr: np.ndarray,
    indices: np.ndarray,
    weights: Optional[np.ndarray],
    block_starts: np.ndarray,
) -> BlockedGraph:
    """The port's :class:`BlockedGraph` over a CSR (rows sorted) and its
    block boundaries — the same blocks, views and packing as the source."""
    graph = CSRGraph(
        np.asarray(indptr).copy(),
        np.asarray(indices).copy(),
        None if weights is None else np.asarray(weights).copy(),
    )
    return BlockedGraph(graph, np.asarray(block_starts, dtype=np.int64).copy())


def key_halves_from_seed(seed: int) -> np.ndarray:
    """The raw ``uint32[2]`` data of ``jax.random.PRNGKey(seed)`` for a
    non-negative seed — the engines' base key."""
    return np.asarray(rng.key_halves(seed), dtype=np.uint32)
