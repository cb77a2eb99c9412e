"""Fast numpy graph generators for the paper's synthetic studies (Table 5).

NetworkX (used by the paper) is far too slow at benchmark scale on one core;
these produce the same families — circulant, Erdős–Rényi, Barabási–Albert,
stochastic block model, plus Graph500-style RMAT for the Kron29 analogue —
as vectorised edge-list constructions.
"""

from __future__ import annotations

import numpy as np

from .graph import CSRGraph

__all__ = [
    "circulant_graph",
    "erdos_renyi",
    "barabasi_albert",
    "stochastic_block_model",
    "rmat",
]


def circulant_graph(n: int, offsets_count: int) -> CSRGraph:
    """CirculantG: vertex i connects to i±1..i±offsets_count (mod n)."""
    offs = np.arange(1, offsets_count + 1, dtype=np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), offs.shape[0])
    dst = (src + np.tile(offs, n)) % n
    return CSRGraph.from_edges(np.stack([src, dst], 1), n, symmetrize=True)


def erdos_renyi(n: int, num_edges: int, seed: int = 0) -> CSRGraph:
    """RandomG: G(n, m) by sampling m directed pairs then symmetrising."""
    rng = np.random.default_rng(seed)
    # oversample to survive self-loop/dup removal
    m = int(num_edges * 1.15) + 16
    src = rng.integers(0, n, m, dtype=np.int64)
    dst = rng.integers(0, n, m, dtype=np.int64)
    keep = src != dst
    edges = np.stack([src[keep], dst[keep]], 1)[:num_edges]
    return CSRGraph.from_edges(edges, n, symmetrize=True)


def barabasi_albert(n: int, m: int, seed: int = 0) -> CSRGraph:
    """BASF: preferential attachment, vectorised via the repeated-target trick
    (attach to a uniform sample of the current edge-endpoint multiset)."""
    rng = np.random.default_rng(seed)
    if n <= m:
        raise ValueError("n must exceed m")
    targets = list(range(m))
    repeated: list[int] = []
    src_all = np.empty((n - m) * m, dtype=np.int64)
    dst_all = np.empty((n - m) * m, dtype=np.int64)
    k = 0
    rep = np.array(targets, dtype=np.int64)
    for v in range(m, n):
        # choose m distinct-ish targets from the endpoint multiset
        pick = rep[rng.integers(0, rep.shape[0], m)]
        src_all[k : k + m] = v
        dst_all[k : k + m] = pick
        k += m
        rep = np.concatenate([rep, pick, np.full(m, v, dtype=np.int64)])
        if rep.shape[0] > 4_000_000:  # bound memory; subsample keeps proportions
            rep = rep[rng.integers(0, rep.shape[0], 2_000_000)]
    edges = np.stack([src_all, dst_all], 1)
    return CSRGraph.from_edges(edges, n, symmetrize=True)


def stochastic_block_model(
    sizes: list[int], p_in: float, p_out: float, seed: int = 0
) -> CSRGraph:
    """SBM with per-pair Binomial edge counts + uniform endpoint sampling."""
    rng = np.random.default_rng(seed)
    starts = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    n = int(starts[-1])
    chunks = []
    B = len(sizes)
    for i in range(B):
        for j in range(i, B):
            ni, nj = sizes[i], sizes[j]
            pairs = ni * (ni - 1) // 2 if i == j else ni * nj
            p = p_in if i == j else p_out
            m = rng.binomial(pairs, p)
            if m == 0:
                continue
            s = rng.integers(starts[i], starts[i + 1], m, dtype=np.int64)
            d = rng.integers(starts[j], starts[j + 1], m, dtype=np.int64)
            chunks.append(np.stack([s, d], 1))
    edges = np.concatenate(chunks, 0) if chunks else np.zeros((0, 2), np.int64)
    return CSRGraph.from_edges(edges, n, symmetrize=True)


def rmat(
    scale: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19,
    c: float = 0.19, seed: int = 0,
) -> CSRGraph:
    """Graph500 Kronecker/RMAT generator (Kron29 analogue, scaled down)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        # quadrant probabilities (a, b, c, d)
        src_bit = (r >= a + b).astype(np.int64)
        r2 = rng.random(m)
        thr = np.where(src_bit == 0, a / (a + b), c / max(1.0 - a - b, 1e-9))
        dst_bit = (r2 >= thr).astype(np.int64)
        src |= src_bit << bit
        dst |= dst_bit << bit
    edges = np.stack([src, dst], 1)
    return CSRGraph.from_edges(edges, n, symmetrize=True)
