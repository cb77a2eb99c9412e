"""Graph partitioners (paper §6.2 / §7.5).

``sequential_partition`` is the paper's default: pack vertices in ID order
into blocks whose CSR slice fits a byte budget.  ``greedy_locality_partition``
is our in-core stand-in for METIS (§7.5): a BFS/label-propagation hybrid that
raises block density (lowers edge-cut) so walks stay inside a block longer —
the property the paper exploits.  Both return either block boundaries (for
ID-contiguous partitions) or a relabelled graph + boundaries.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .graph import BlockedGraph, CSRGraph

__all__ = [
    "sequential_partition",
    "partition_into_n_blocks",
    "greedy_locality_partition",
]


def sequential_partition(graph: CSRGraph, block_size_bytes: int) -> BlockedGraph:
    """Paper default: vertices in ID order; each block's CSR slice (index +
    neighbor cells, 4 bytes each) stays within ``block_size_bytes``."""
    starts = [0]
    v = 0
    V = graph.num_vertices
    indptr = graph.indptr
    while v < V:
        # bytes of block [starts[-1], v]: (nv+1 + ne) * 4
        lo = starts[-1]
        # advance v as far as the budget allows (at least one vertex)
        hi = v + 1
        while hi < V:
            nbytes = 4 * ((hi + 1 - lo + 1) + int(indptr[hi + 1] - indptr[lo]))
            if nbytes > block_size_bytes:
                break
            hi += 1
        starts.append(hi)
        v = hi
    return BlockedGraph(graph, np.asarray(starts, dtype=np.int64))


def partition_into_n_blocks(graph: CSRGraph, num_blocks: int) -> BlockedGraph:
    """Split into exactly ``num_blocks`` blocks of near-equal edge count
    (the paper keeps blocks within 1.03x of each other for METIS runs)."""
    V, E = graph.num_vertices, graph.num_edges
    num_blocks = max(1, min(num_blocks, V))
    target = max(E // num_blocks, 1)
    starts = [0]
    for b in range(1, num_blocks):
        # first vertex whose cumulative edge count crosses b*target
        v = int(np.searchsorted(graph.indptr[1:], b * target, side="left")) + 1
        v = max(v, starts[-1] + 1)
        v = min(v, V - (num_blocks - b))  # leave room for remaining blocks
        starts.append(v)
    starts.append(V)
    return BlockedGraph(graph, np.asarray(starts, dtype=np.int64))


def greedy_locality_partition(
    graph: CSRGraph, num_blocks: int, *, rounds: int = 4, seed: int = 0
) -> Tuple[CSRGraph, BlockedGraph, np.ndarray]:
    """METIS stand-in: BFS grow + label-propagation refinement, then relabel
    vertices so blocks are ID-contiguous (the engine requires contiguity).

    Returns ``(relabelled_graph, blocked, perm)`` where ``perm[old] = new``.
    """
    V = graph.num_vertices
    num_blocks = max(1, min(num_blocks, V))
    cap = int(np.ceil(V / num_blocks))
    rng = np.random.default_rng(seed)
    label = np.full(V, -1, dtype=np.int64)
    sizes = np.zeros(num_blocks, dtype=np.int64)

    # --- seed blocks with BFS growth from high-degree roots -----------------
    order = np.argsort(-graph.degrees)
    b = 0
    for root in order:
        if label[root] != -1 or b >= num_blocks:
            continue
        frontier = [int(root)]
        while frontier and sizes[b] < cap:
            v = frontier.pop()
            if label[v] != -1:
                continue
            label[v] = b
            sizes[b] += 1
            for z in graph.neighbors(v):
                if label[z] == -1:
                    frontier.append(int(z))
        b += 1
    # leftovers round-robin into the emptiest block
    for v in np.where(label == -1)[0]:
        b = int(np.argmin(sizes))
        label[v] = b
        sizes[b] += 1

    # --- label propagation refinement with capacity ------------------------
    src = np.repeat(np.arange(V), graph.degrees.astype(np.int64))
    dst = graph.indices.astype(np.int64)
    for _ in range(rounds):
        for v in rng.permutation(V):
            s, e = graph.indptr[v], graph.indptr[v + 1]
            if s == e:
                continue
            nb = label[graph.indices[s:e]]
            cnt = np.bincount(nb, minlength=num_blocks)
            best = int(np.argmax(cnt))
            cur = int(label[v])
            if best != cur and cnt[best] > cnt[cur] and sizes[best] < int(1.1 * cap) + 1:
                label[v] = best
                sizes[best] += 1
                sizes[cur] -= 1
    del src, dst

    # --- relabel to contiguous ranges --------------------------------------
    perm_order = np.argsort(label, kind="stable")  # old ids grouped by block
    perm = np.empty(V, dtype=np.int64)
    perm[perm_order] = np.arange(V)
    relabelled = graph.relabel(perm)
    counts = np.bincount(label, minlength=num_blocks)
    counts = counts[counts > 0]
    starts = np.zeros(counts.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return relabelled, BlockedGraph(relabelled, starts), perm
