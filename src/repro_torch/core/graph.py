"""Blocked CSR graph storage — the paper's on-disk layout (Fig. 2/6) in JAX.

The paper stores a graph as CSR partitioned into ``N_B`` blocks; a *Start
Vertex File* records the first vertex of each block, an *Index File* holds
per-vertex neighbor offsets and a *CSR File* the neighbor lists.  Here the
"disk" tier is host memory (numpy) and the "memory" tier is device memory
(jnp arrays); every movement across that boundary is metered by
:mod:`repro.core.stats` so block/vertex I/O counts match the paper's tables.

Blocks are materialised as *stacked, padded* arrays so that a resident block
(or block pair) always has a static shape — the property that lets the walk
advance loop be a single jitted function and lets the Pallas kernels pin a
block pair in VMEM with a fixed BlockSpec.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "CSRGraph",
    "BlockedGraph",
    "BlockView",
    "ResidentBlock",
    "block_of",
    "activated_bytes",
]


@dataclasses.dataclass
class CSRGraph:
    """Host-side CSR graph. ``indices`` rows are sorted (binary-search membership)."""

    indptr: np.ndarray  # [V+1] int64
    indices: np.ndarray  # [E]   int32, sorted within each row
    weights: Optional[np.ndarray] = None  # [E] float32 or None (unweighted)

    def __post_init__(self) -> None:
        self.indptr = np.asarray(self.indptr, dtype=np.int64)
        self.indices = np.asarray(self.indices, dtype=np.int32)
        if self.weights is not None:
            self.weights = np.asarray(self.weights, dtype=np.float32)
            if self.weights.shape != self.indices.shape:
                raise ValueError("weights must align with indices")

    # -- basic accessors ---------------------------------------------------
    @property
    def num_vertices(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def out_degree(self, v) -> np.ndarray:
        return (self.indptr[1:] - self.indptr[:-1])[v]

    @property
    def degrees(self) -> np.ndarray:
        return (self.indptr[1:] - self.indptr[:-1]).astype(np.int32)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v] : self.indptr[v + 1]]

    def neighbor_weights(self, v: int) -> Optional[np.ndarray]:
        if self.weights is None:
            return None
        return self.weights[self.indptr[v] : self.indptr[v + 1]]

    def csr_bytes(self) -> int:
        """Size of the CSR representation (4-byte cells, as in the paper's Fig. 5)."""
        return 4 * (self.indptr.shape[0] + self.indices.shape[0])

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_edges(
        cls,
        edges: np.ndarray,
        num_vertices: Optional[int] = None,
        *,
        symmetrize: bool = True,
        weights: Optional[np.ndarray] = None,
        dedup: bool = True,
    ) -> "CSRGraph":
        """Build from an edge list [M, 2]. ``symmetrize`` mirrors the paper
        ("All graphs are processed into undirected")."""
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if weights is not None:
            weights = np.asarray(weights, dtype=np.float32).reshape(-1)
        if num_vertices is None:
            num_vertices = int(edges.max()) + 1 if edges.size else 0
        if symmetrize and edges.size:
            edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
            if weights is not None:
                weights = np.concatenate([weights, weights], axis=0)
        if edges.size == 0:
            return cls(np.zeros(num_vertices + 1, np.int64), np.zeros(0, np.int32))
        # drop self loops (a second-order walk "return" step is still well
        # defined without them and the paper's datasets are simple graphs)
        keep = edges[:, 0] != edges[:, 1]
        edges = edges[keep]
        if weights is not None:
            weights = weights[keep]
        key = edges[:, 0] * np.int64(num_vertices) + edges[:, 1]
        order = np.argsort(key, kind="stable")
        key = key[order]
        edges = edges[order]
        if weights is not None:
            weights = weights[order]
        if dedup:
            uniq = np.ones(key.shape[0], dtype=bool)
            uniq[1:] = key[1:] != key[:-1]
            edges = edges[uniq]
            if weights is not None:
                weights = weights[uniq]
        counts = np.bincount(edges[:, 0], minlength=num_vertices).astype(np.int64)
        indptr = np.zeros(num_vertices + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr, edges[:, 1].astype(np.int32), weights)

    def relabel(self, perm: np.ndarray) -> "CSRGraph":
        """Relabel vertices: new_id = perm[old_id]. Used by custom partitions."""
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.shape[0])
        src = np.repeat(np.arange(self.num_vertices), self.degrees.astype(np.int64))
        edges = np.stack([perm[src], perm[self.indices]], axis=1)
        return CSRGraph.from_edges(
            edges,
            self.num_vertices,
            symmetrize=False,
            weights=self.weights,
            dedup=False,
        )


def block_of(block_starts: np.ndarray, v) -> np.ndarray:
    """B(v): the block ID owning vertex ``v`` (contiguous vertex ranges)."""
    return np.searchsorted(block_starts, v, side="right") - 1


def activated_bytes(degrees: np.ndarray, vertices: np.ndarray) -> int:
    """Bytes an on-demand load of ``vertices`` moves: one 8-byte index-entry
    pair plus the 4-byte neighbor cells per unique vertex (paper Fig. 5(b)).

    Shared by the in-RAM :class:`BlockedGraph` and the file-backed
    :class:`repro.io.DiskBlockedGraph` so both backends charge identically.
    """
    vertices = np.unique(np.asarray(vertices, dtype=np.int64))
    if vertices.size == 0:
        return 0
    deg = np.asarray(degrees)[vertices].astype(np.int64)
    return int(8 * vertices.size + 4 * deg.sum())


@dataclasses.dataclass
class ResidentBlock:
    """One block resident in "memory" (device arrays, statically padded).

    ``indptr`` is local (offsets into ``indices``); vertex ``v`` maps to local
    row ``v - start``.  ``indices`` holds *global* neighbor IDs, sorted per row.
    """

    block_id: int
    start: int  # first global vertex id
    nverts: int
    nedges: int
    indptr: np.ndarray  # [max_block_verts + 1] int32 (padded with nedges)
    indices: np.ndarray  # [max_block_edges] int32 (padded with -1)
    alias_j: Optional[np.ndarray] = None  # [max_block_edges] int32 alias index
    alias_q: Optional[np.ndarray] = None  # [max_block_edges] float32 alias prob

    def nbytes_full(self) -> int:
        """Bytes a full load moves: index slice + CSR slice (4-byte cells)."""
        return 4 * (self.nverts + 1) + 4 * self.nedges


@dataclasses.dataclass
class BlockView:
    """A (possibly partial) *view* of one block — the currency between the
    storage layer and execution.

    A view is a compacted local CSR over the vertices it holds: ``vids`` is
    the sorted array of global vertex ids with a row in the view (the remap
    table — the kernel resolves a global vertex to its compact row by binary
    search over ``vids``), ``indptr``/``indices`` the compact CSR.  Two kinds:

    * ``kind == "full"`` — every vertex of the block; ``vids`` is the
      contiguous range ``[start, start + nverts)``.  Built from a
      :class:`ResidentBlock` (a full block load).
    * ``kind == "activated"`` — only the bucket's activated vertices (the
      ``prev``/``cur`` of some walk), so device bytes are
      ``O(activated vertices)`` instead of ``O(block)``.  Built by
      ``partial_view`` on either graph backend, and *extended* mid-advance
      when a walk reaches a vertex that was not pre-activated.

    Rows a view holds are bit-identical to the full block's rows (same
    neighbor order, same row-local alias tables), which is what makes
    execution on an activated view produce the same walks as a full load.
    """

    block_id: int
    kind: str  # "full" | "activated"
    vids: np.ndarray  # [K] int32, sorted global vertex ids (the remap table)
    indptr: np.ndarray  # [K+1] int32, compact local offsets
    indices: np.ndarray  # [nnz] int32, global neighbor ids (sorted per row)
    alias_j: Optional[np.ndarray] = None  # [nnz] int32, row-local alias slots
    alias_q: Optional[np.ndarray] = None  # [nnz] float32

    @property
    def nverts(self) -> int:
        return int(self.vids.shape[0])

    @property
    def nedges(self) -> int:
        return int(self.indices.shape[0])

    def nbytes(self) -> int:
        """Data bytes of the compact view (remap + index + CSR, 4-byte cells,
        plus the alias pair when present)."""
        n = 4 * self.nverts + 4 * (self.nverts + 1) + 4 * self.nedges
        if self.alias_j is not None:
            n += 8 * self.nedges
        return n

    def has_vertices(self, vertices: np.ndarray) -> np.ndarray:
        """Boolean mask: which of ``vertices`` have a row in this view."""
        vertices = np.asarray(vertices)
        pos = np.searchsorted(self.vids, vertices)
        pos_c = np.minimum(pos, max(self.nverts - 1, 0))
        if self.nverts == 0:
            return np.zeros(vertices.shape, bool)
        return self.vids[pos_c] == vertices

    @classmethod
    def from_resident(cls, blk: ResidentBlock) -> "BlockView":
        """Full view of a materialised block (zero-copy slices)."""
        nv, ne = blk.nverts, blk.nedges
        return cls(
            block_id=blk.block_id,
            kind="full",
            vids=(blk.start + np.arange(nv)).astype(np.int32),
            indptr=blk.indptr[: nv + 1],
            indices=blk.indices[:ne],
            alias_j=None if blk.alias_j is None else blk.alias_j[:ne],
            alias_q=None if blk.alias_q is None else blk.alias_q[:ne],
        )

    @classmethod
    def from_rows(
        cls,
        block_id: int,
        vids: np.ndarray,
        segs: Sequence[np.ndarray],
        alias_segs: Optional[Sequence] = None,
        *,
        kind: str = "activated",
    ) -> "BlockView":
        """Assemble a view from per-vertex row segments (``vids`` sorted,
        ``segs[k]`` the neighbor list of ``vids[k]``)."""
        k = len(segs)
        indptr = np.zeros(k + 1, dtype=np.int32)
        if k:
            sizes = np.array([s.size for s in segs], dtype=np.int64)
            indptr[1:] = np.cumsum(sizes).astype(np.int32)
        indices = np.concatenate(segs).astype(np.int32) if k else np.zeros(0, np.int32)
        alias_j = alias_q = None
        if alias_segs is not None:
            alias_j = (
                np.concatenate([a for a, _ in alias_segs]).astype(np.int32)
                if k
                else np.zeros(0, np.int32)
            )
            alias_q = (
                np.concatenate([q for _, q in alias_segs]).astype(np.float32)
                if k
                else np.zeros(0, np.float32)
            )
        return cls(
            block_id=block_id,
            kind=kind,
            vids=np.asarray(vids, dtype=np.int32),
            indptr=indptr,
            indices=indices,
            alias_j=alias_j,
            alias_q=alias_q,
        )

    def row(self, k: int) -> np.ndarray:
        return self.indices[self.indptr[k] : self.indptr[k + 1]]

    def _alias_row(self, k: int):
        s, e = self.indptr[k], self.indptr[k + 1]
        return (self.alias_j[s:e], self.alias_q[s:e])

    def extended(self, other: "BlockView") -> "BlockView":
        """A new activated view holding this view's rows plus ``other``'s
        (the mid-advance *extension gather*: ``other`` carries the rows of
        vertices reached during execution that were not pre-activated).
        Vertex sets must be disjoint."""
        if other.block_id != self.block_id:
            raise ValueError("cannot extend a view with rows of another block")
        merged = np.concatenate([self.vids, other.vids])
        order = np.argsort(merged, kind="stable")
        views = [self] * self.nverts + [other] * other.nverts
        local = list(range(self.nverts)) + list(range(other.nverts))
        segs = [views[i].row(local[i]) for i in order]
        alias_segs = None
        if self.alias_j is not None:
            alias_segs = [views[i]._alias_row(local[i]) for i in order]
        return BlockView.from_rows(self.block_id, merged[order], segs, alias_segs, kind="activated")


class BlockedGraph:
    """A CSR graph partitioned into blocks with contiguous vertex ranges.

    Mirrors the paper's sequential partition (§6.2): vertices in ID order are
    packed into blocks such that each block's CSR slice fits ``block_size``
    bytes.  Custom partitions relabel the graph first (see
    :mod:`repro.core.partition`).
    """

    def __init__(self, graph: CSRGraph, block_starts: Sequence[int], *, build_alias: bool = False):
        block_starts = np.asarray(block_starts, dtype=np.int64)
        if block_starts[0] != 0 or block_starts[-1] != graph.num_vertices:
            raise ValueError("block_starts must span [0, V]")
        if np.any(np.diff(block_starts) <= 0):
            raise ValueError("blocks must be non-empty, increasing")
        self.graph = graph
        self.block_starts = block_starts
        self.num_blocks = int(block_starts.shape[0] - 1)
        nverts = np.diff(block_starts)
        estarts = graph.indptr[block_starts]
        nedges = np.diff(estarts)
        self.block_nverts = nverts.astype(np.int64)
        self.block_nedges = nedges.astype(np.int64)
        self.max_block_verts = int(nverts.max())
        self.max_block_edges = max(int(nedges.max()), 1)
        self._build_alias = build_alias
        self._blocks: dict[int, ResidentBlock] = {}
        # Waste budget (bytes) of the gap-aware on-demand read planner
        # (repro.io.ioplan).  The RAM backend performs no real reads, but the
        # BlockStore meters the planner's modelled gauges off this knob so
        # accounting is backend-invariant.  0 = planner off (per-vertex
        # reference reads).
        self.io_coalesce_gap = 0

    # -- backend-neutral surface (shared with repro.io.DiskBlockedGraph) ------
    # Engines and the BlockStore only touch this surface plus
    # ``materialize_block``; anything reaching for ``.graph`` directly (the
    # in-memory oracle, partitioners) requires the RAM backend.
    @property
    def num_vertices(self) -> int:
        return self.graph.num_vertices

    @property
    def num_edges(self) -> int:
        return self.graph.num_edges

    @property
    def degrees(self) -> np.ndarray:
        return self.graph.degrees

    @property
    def has_weights(self) -> bool:
        return self.graph.weights is not None

    def ensure_alias(self) -> None:
        """Ask for alias tables on every materialised block from now on."""
        self._build_alias = True

    def row_extents(self, vertices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Global CSR edge range ``[rs, re)`` per vertex of a sorted unique
        ``vertices`` array — resident metadata only, no I/O.  The read
        planner's input on either backend."""
        vs = np.asarray(vertices, dtype=np.int64)
        return self.graph.indptr[vs], self.graph.indptr[vs + 1]

    # -- paper Table 2 style metadata ---------------------------------------
    def edge_cut(self) -> float:
        """Fraction of edges whose endpoints live in different blocks."""
        src = np.repeat(np.arange(self.graph.num_vertices), self.graph.degrees.astype(np.int64))
        bs = block_of(self.block_starts, src)
        bd = block_of(self.block_starts, self.graph.indices)
        if len(bs) == 0:
            return 0.0
        return float(np.mean(bs != bd))

    def block_id_of(self, v) -> np.ndarray:
        return block_of(self.block_starts, v)

    # -- block materialisation ("disk read") --------------------------------
    def materialize_block(self, b: int) -> ResidentBlock:
        """Cut block ``b`` out of the CSR, padded to the global maxima.

        This is a *host* operation; the engine meters the transfer when it
        places the result in "memory".  Results are cached — the cache models
        the OS page cache, but the engine always charges the I/O (the paper
        bypasses the page cache for determinism in its accounting too).
        """
        if b in self._blocks:
            blk = self._blocks[b]
            if self._build_alias and blk.alias_j is None:
                self._attach_alias(blk)
            return blk
        s, e = int(self.block_starts[b]), int(self.block_starts[b + 1])
        es, ee = int(self.graph.indptr[s]), int(self.graph.indptr[e])
        nv, ne = e - s, ee - es
        indptr = np.full(self.max_block_verts + 1, ne, dtype=np.int32)
        indptr[: nv + 1] = (self.graph.indptr[s : e + 1] - es).astype(np.int32)
        indices = np.full(self.max_block_edges, -1, dtype=np.int32)
        indices[:ne] = self.graph.indices[es:ee]
        blk = ResidentBlock(b, s, nv, ne, indptr, indices)
        if self._build_alias:
            self._attach_alias(blk)
        self._blocks[b] = blk
        return blk

    def _attach_alias(self, blk: ResidentBlock) -> None:
        from .sampling import build_alias_rows  # local import: avoid cycle

        w = None
        if self.graph.weights is not None:
            s = int(self.block_starts[blk.block_id])
            es = int(self.graph.indptr[s])
            w = np.zeros(self.max_block_edges, dtype=np.float32)
            w[: blk.nedges] = self.graph.weights[es : es + blk.nedges]
        blk.alias_j, blk.alias_q = build_alias_rows(blk.indptr, blk.nverts, self.max_block_edges, w)

    def activated_load_bytes(self, vertices: np.ndarray) -> int:
        """Bytes moved by an on-demand load of ``vertices`` (index entry pair
        + each vertex's neighbor segment, as in the paper's Fig. 5(b))."""
        return activated_bytes(self.graph.degrees, vertices)

    def partial_view(self, b: int, vertices: np.ndarray) -> BlockView:
        """An *activated* :class:`BlockView` of block ``b``: a compacted
        local CSR over only the (unique) requested vertices plus the remap
        table.  Rows are cut straight from the host CSR; row-local alias
        tables are built with the same function a full block uses, so a row
        is bit-identical to its full-load twin.  Mirrors
        ``DiskBlockedGraph.partial_view`` (which performs real partial
        reads); the *engine* charges the transfer either way.
        """
        s, e = int(self.block_starts[b]), int(self.block_starts[b + 1])
        vids = np.unique(np.asarray(vertices, dtype=np.int64))
        if vids.size and (vids[0] < s or vids[-1] >= e):
            raise IndexError(f"vertices outside block {b} range [{s}, {e})")
        return self._rows_view(b, vids)

    def gather_view(self, vertices: np.ndarray) -> BlockView:
        """A cross-block activated view (``block_id == -1``): the rows of
        arbitrary vertices, compacted.  What a baseline's per-walk vertex
        fetches pin in "memory" (e.g. SOGW's out-of-block previous-vertex
        adjacencies), so execution uses exactly the rows the engine charged
        for."""
        return self._rows_view(-1, np.unique(np.asarray(vertices, dtype=np.int64)))

    def _rows_view(self, block_id: int, vids: np.ndarray) -> BlockView:
        g = self.graph
        segs = [g.indices[g.indptr[v] : g.indptr[v + 1]] for v in vids]
        alias_segs = None
        if self._build_alias:
            from .sampling import build_alias  # local import: avoid cycle

            alias_segs = []
            for k, v in enumerate(vids):
                w = (
                    g.weights[g.indptr[v] : g.indptr[v + 1]]
                    if g.weights is not None
                    else np.ones(segs[k].size)
                )
                if segs[k].size:
                    alias_segs.append(build_alias(w))
                else:
                    alias_segs.append((np.zeros(0, np.int32), np.zeros(0, np.float32)))
        return BlockView.from_rows(block_id, vids, segs, alias_segs)

    def describe(self) -> dict:
        return {
            "num_vertices": self.graph.num_vertices,
            "num_edges": self.graph.num_edges,
            "num_blocks": self.num_blocks,
            "max_block_verts": self.max_block_verts,
            "max_block_edges": self.max_block_edges,
            "csr_bytes": self.graph.csr_bytes(),
            "edge_cut": self.edge_cut(),
        }
