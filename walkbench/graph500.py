"""The Graph500 Kronecker generator, vectorised in PyTorch.

Graph 500 specification, section "Kronecker generator"
(``kronecker_generator.m``): each of ``edge_factor * 2**scale`` edges picks
one quadrant per bit level with probabilities A, B, C, D, and the vertex
labels are then randomly permuted.  The specification also shuffles the
order of the edge list; the graph built from it (symmetrised, sorted) does
not depend on that order, so the shuffle is left out.

The edge list is drawn on the device, in one call a level, from a
``torch.Generator`` seeded from ``--seed``; the tasks' seeds and query
vertices come from ``--seed`` through :class:`numpy.random.SeedSequence`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["kronecker_edges", "kronecker_parts", "non_isolated", "task_rng"]

#: spawn keys that separate the graph's stream from each task's
_GRAPH_STREAM = 0
_TASK_STREAM = 1
_WARMUP_STREAM = 2


def task_rng(seed: int, k: int) -> np.random.Generator:
    """The stream of the window's task ``k`` (its walk seed and query);
    ``k = -1`` is the warm-up task's."""
    key = (_WARMUP_STREAM,) if k < 0 else (_TASK_STREAM, k)
    return np.random.default_rng(np.random.SeedSequence(seed, spawn_key=key))


def kronecker_parts(
    scale: int, edge_factor: int, a: float, b: float, c: float, seed: int, device="cpu"
):
    """The generator's draws: ``(ii, jj, perm)``, the unpermuted endpoints of
    every edge and the label permutation, as tensors on ``device``.

    The draws are made on ``device`` by one ``torch.Generator`` seeded from
    ``seed``, one level of the recursion a call; one seed gives one edge
    list on one kind of device."""
    import torch

    n = 1 << scale
    m = edge_factor * n
    stream = np.random.SeedSequence(seed, spawn_key=(_GRAPH_STREAM,))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(stream.generate_state(1, np.uint64)[0]))
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ii = torch.zeros(m, dtype=torch.int64, device=device)
    jj = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        r = torch.rand((2, m), generator=gen, device=device)
        ii_bit = r[0] > ab
        jj_bit = r[1] > torch.where(ii_bit, c_norm, a_norm)
        ii |= ii_bit.to(torch.int64) << bit
        jj |= jj_bit.to(torch.int64) << bit
        del r, ii_bit, jj_bit
    perm = torch.randperm(n, generator=gen, device=device)
    return ii, jj, perm


def kronecker_edges(
    scale: int, edge_factor: int, a: float, b: float, c: float, seed: int, device="cpu"
) -> np.ndarray:
    """``[edge_factor * 2**scale, 2]`` int64 directed edges, labels permuted."""
    import torch

    ii, jj, perm = kronecker_parts(scale, edge_factor, a, b, c, seed, device)
    return torch.stack([perm[ii], perm[jj]], dim=1).cpu().numpy()


def non_isolated(edges: np.ndarray, num_vertices: int) -> np.ndarray:
    """Sorted ids of the vertices with at least one edge that is not a loop."""
    keep = edges[:, 0] != edges[:, 1]
    seen = np.zeros(num_vertices, bool)
    seen[edges[keep, 0]] = True
    seen[edges[keep, 1]] = True
    return np.flatnonzero(seen)
