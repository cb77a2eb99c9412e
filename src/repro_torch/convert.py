"""Carry graph, RNG state and LM weights from the JAX package into the port.

Both packages speak numpy at their edges, so a graph built and blocked by
``repro`` (a ``CSRGraph`` and its ``block_starts``) crosses over as plain
arrays, and so does a model's parameter tree.  Nothing here imports
``repro`` or ``jax``.

    from repro_torch.convert import blocked_graph_from_arrays, lm_params_from_arrays
    bg = blocked_graph_from_arrays(g.indptr, g.indices, g.weights, bg_jax.block_starts)
    params = lm_params_from_arrays(jax.tree.map(np.asarray, jax_params), cfg, "cpu")
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import BlockedGraph, CSRGraph
from repro_torch.engines.base import resolve_device
from repro_torch.kernels import rng
from repro_torch.models.common import ModelConfig, tree_map
from repro_torch.models.registry import init_params_shape

__all__ = ["blocked_graph_from_arrays", "key_halves_from_seed", "lm_params_from_arrays"]


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


def lm_params_from_arrays(tree, cfg: ModelConfig, device="cuda"):
    """The port's parameter tree from the JAX package's, as numpy arrays
    (``jax.tree.map(np.asarray, params)``): the same keys, shapes, dtypes
    and bits, on ``device``.  Raises ``ValueError`` where the tree does not
    match ``cfg``'s."""
    dev = resolve_device(device)

    def leaf(a, want):
        a = np.array(a)  # a writable copy: the port's tensors own their memory
        if a.dtype.name == "bfloat16":
            # ml_dtypes' bfloat16, which torch.from_numpy refuses: the same
            # bits through a 16-bit integer view
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        if t.shape != want.shape or t.dtype != want.dtype:
            raise ValueError(
                f"{cfg.name}: array {tuple(t.shape)} {t.dtype} where the config "
                f"has {tuple(want.shape)} {want.dtype}"
            )
        return t.to(dev)

    return tree_map(leaf, tree, init_params_shape(cfg))
