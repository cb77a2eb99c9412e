"""On-disk block container — the paper's Start-Vertex/Index/CSR files (Fig. 2)
packed into one file, plus a file-backed ``BlockedGraph`` twin.

Until this module existed, ``BlockedGraph.materialize_block`` cut blocks out
of a host-RAM CSR, so the metered "disk I/O" never touched a file descriptor.
:func:`write_block_file` serialises a :class:`~repro.core.graph.BlockedGraph`
into a single packed container with an offset index, and
:class:`DiskBlockedGraph` reads it back exposing the *same*
``materialize_block``/metadata surface — engines and the
:class:`~repro.io.blockstore.BlockStore` run unchanged and bit-identical,
but every full block load is now a real ``pread`` whose byte count equals
``ResidentBlock.nbytes_full()``, and on-demand loads are real per-vertex
partial reads whose byte count equals
:func:`~repro.core.graph.activated_bytes`.

Byte-level layout (everything little-endian)::

    offset  size                 field
    ------  -------------------  ----------------------------------------
    0       8                    magic  b"GRSWBLK1"
    8       4                    version (u32, =1)
    12      4                    flags (u32; bit 0: weights+alias present)
    16      8                    num_blocks  NB (u64)
    24      8                    num_vertices V (u64)
    32      8                    num_edges    E (u64)
    40      8                    max_block_verts (u64)
    48      8                    max_block_edges (u64)
    56      8                    reserved (u64, 0)
    64      (NB+1)*8             block_starts   (i64)  — Start Vertex File
    .       (NB+1)*8             block_offsets  (u64)  — byte offset of each
                                 block payload; last entry == file size
    .       V*4                  degrees (u32)        — per-vertex out-degree

    per block b, at block_offsets[b]:
      (nv+1)*4                   local indptr (i32)   — Index File slice
      ne*4                       global indices (i32) — CSR File slice
      [ne*4]                     edge weights (f32)       } only when
      [ne*4]                     alias_j, local (i32)     } flags bit 0
      [ne*4]                     alias_q (f32)            } is set

The charged quantities only ever count the Index + CSR slices (4-byte
cells), exactly like the in-RAM backend; weights/alias are derived data and
are tallied separately in :attr:`DiskBlockedGraph.aux_bytes_read`.
"""

from __future__ import annotations

import os
import struct
import tempfile
from typing import Dict, Iterable, Optional

import numpy as np

from repro_torch.core.graph import (
    BlockedGraph,
    BlockView,
    CSRGraph,
    ResidentBlock,
    activated_bytes,
    block_of,
)
from repro_torch.io.ioplan import execute_plan, plan_reads

__all__ = [
    "BLOCK_FILE_NAME",
    "BlockFileError",
    "DiskBlockedGraph",
    "write_and_open",
    "write_block_file",
]

MAGIC = b"GRSWBLK1"
VERSION = 1
FLAG_WEIGHTED = 1 << 0
_HEADER = struct.Struct("<8sII6Q")  # magic, version, flags, NB, V, E, maxv, maxe, rsvd
#: conventional file name inside a ``--graph-dir`` directory
BLOCK_FILE_NAME = "graph.grb"


class BlockFileError(RuntimeError):
    """Malformed, truncated, or version-incompatible block container."""


def write_block_file(bg: BlockedGraph, path: str) -> dict:
    """Serialise ``bg`` (an in-RAM blocked graph) into one packed container.

    Alias tables are built here with the exact function the RAM backend uses
    (:func:`repro_torch.core.sampling.build_alias_rows`), so a weighted graph read
    back from disk produces bit-identical walks.  Returns a small summary
    dict (``path``, ``file_bytes``, ``data_bytes``).
    """
    g = bg.graph
    nb = bg.num_blocks
    i32max = np.iinfo(np.int32).max
    if g.num_vertices > i32max or int(bg.max_block_edges) > i32max:
        # indices hold vertex ids, indptr holds within-block edge offsets —
        # both are 4-byte cells (the paper's layout); fail loudly instead of
        # wrapping negative and writing a corrupt-but-validating container
        raise BlockFileError(
            "graph exceeds the 4-byte cell format: need num_vertices and "
            "per-block edge counts <= int32 max"
        )
    weighted = g.weights is not None
    flags = FLAG_WEIGHTED if weighted else 0
    block_starts = bg.block_starts.astype(np.int64)
    degrees = g.degrees.astype(np.uint32)

    header = _HEADER.pack(
        MAGIC,
        VERSION,
        flags,
        nb,
        g.num_vertices,
        g.num_edges,
        bg.max_block_verts,
        bg.max_block_edges,
        0,
    )
    meta_bytes = _HEADER.size + 2 * 8 * (nb + 1) + 4 * g.num_vertices

    # offset index: payload sizes are fully determined by nverts/nedges
    per_edge = 4 + (12 if weighted else 0)  # indices + [weights, alias_j, alias_q]
    sizes = 4 * (bg.block_nverts + 1) + per_edge * bg.block_nedges
    block_offsets = np.zeros(nb + 1, dtype=np.uint64)
    block_offsets[0] = meta_bytes
    np.cumsum(sizes, out=block_offsets[1:].view(np.int64))
    block_offsets[1:] += np.uint64(meta_bytes)

    # unique temp in the destination directory (atomic publish, concurrent
    # writers to the same path never share a temp file), removed on any error
    fd, tmp_path = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".",
        suffix=".tmp",
        dir=os.path.dirname(os.path.abspath(path)),
    )
    data_bytes = 0
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(header)
            f.write(block_starts.tobytes())
            f.write(block_offsets.tobytes())
            f.write(degrees.tobytes())
            for b in range(nb):
                s, e = int(block_starts[b]), int(block_starts[b + 1])
                es, ee = int(g.indptr[s]), int(g.indptr[e])
                nv, ne = e - s, ee - es
                indptr = (g.indptr[s : e + 1] - es).astype(np.int32)
                indices = g.indices[es:ee].astype(np.int32)
                f.write(indptr.tobytes())
                f.write(indices.tobytes())
                data_bytes += 4 * (nv + 1) + 4 * ne
                if weighted:
                    from repro_torch.core.sampling import build_alias_rows

                    w = g.weights[es:ee].astype(np.float32)
                    aj, aq = build_alias_rows(indptr, nv, max(ne, 1), w)
                    f.write(w.tobytes())
                    f.write(aj[:ne].astype(np.int32).tobytes())
                    f.write(aq[:ne].astype(np.float32).tobytes())
            file_bytes = f.tell()
        if file_bytes != int(block_offsets[-1]):
            raise BlockFileError(
                f"writer bug: produced {file_bytes} bytes, offset index says "
                f"{int(block_offsets[-1])}"
            )
        os.replace(tmp_path, path)
    except BaseException:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        raise
    return {"path": path, "file_bytes": file_bytes, "data_bytes": data_bytes}


class DiskBlockedGraph:
    """File-backed twin of :class:`~repro.core.graph.BlockedGraph`.

    Exposes the backend-neutral surface engines and the
    :class:`~repro.io.blockstore.BlockStore` consume — ``block_starts``,
    ``num_blocks``, ``block_nverts``/``block_nedges``, the padded-shape
    maxima, ``materialize_block``, ``activated_load_bytes`` — but every
    block materialisation is a real positioned read (``os.pread``) against
    the packed container.  Only the offset index, ``block_starts`` and the
    per-vertex degree array live in RAM (the paper keeps the same metadata
    resident); the CSR payload never does, so graphs larger than host
    memory are representable.

    Real-I/O counters (never charged to :class:`~repro.core.stats.IOStats`
    — the *engine* charges deterministically, these verify it):

    * ``data_bytes_read`` — Index+CSR bytes read by full loads; equal to the
      sum of ``nbytes_full()`` over those loads.
    * ``aux_bytes_read`` — weight/alias bytes read by full loads.
    * ``ondemand_bytes_read`` — *useful* bytes read by :meth:`read_rows` /
      :meth:`partial_block`; equal to ``activated_load_bytes`` of the
      requested vertices whatever the coalescing gap.
    * ``ondemand_syscalls`` / ``coalesced_ranges`` / ``coalesce_waste_bytes``
      — what the on-demand read path actually issued: every ``pread``
      counts toward ``ondemand_syscalls``; with the gap-aware planner on
      (``io_coalesce_gap > 0``) each coalesced range is one syscall and the
      read-through hole bytes accumulate as waste.  These mirror the
      :class:`~repro.core.stats.IOStats` gauges of the same names and match
      them exactly when prefetch is off.

    ``io_coalesce_gap`` is the planner's waste budget in bytes; 0 keeps the
    per-vertex reference reads bit-for-bit.
    """

    def __init__(self, path: str, *, io_coalesce_gap: int = 0):
        if os.path.isdir(path):
            path = os.path.join(path, BLOCK_FILE_NAME)
        self.path = path
        self.io_coalesce_gap = int(io_coalesce_gap)
        self._fd = -1  # so __del__/close are safe if os.open raises
        self._fd = os.open(path, os.O_RDONLY)
        try:
            self._load_metadata()
        except Exception:
            os.close(self._fd)
            self._fd = -1
            raise
        self.full_loads = 0
        self.ondemand_reads = 0
        self.data_bytes_read = 0
        self.aux_bytes_read = 0
        self.ondemand_bytes_read = 0
        self.ondemand_syscalls = 0
        self.coalesced_ranges = 0
        self.coalesce_waste_bytes = 0

    # -- open/close -----------------------------------------------------------
    def _load_metadata(self) -> None:
        raw = self._pread_exact(0, _HEADER.size, what="header")
        magic, version, flags, nb, V, E, maxv, maxe, _rsvd = _HEADER.unpack(raw)
        if magic != MAGIC:
            raise BlockFileError(f"bad magic {magic!r}: not a GraSorw block file")
        if version != VERSION:
            raise BlockFileError(f"unsupported block file version {version}")
        self.num_blocks = int(nb)
        self._num_vertices = int(V)
        self._num_edges = int(E)
        self.max_block_verts = int(maxv)
        self.max_block_edges = int(maxe)
        self.weighted = bool(flags & FLAG_WEIGHTED)
        off = _HEADER.size
        self.block_starts = np.frombuffer(
            self._pread_exact(off, 8 * (nb + 1), what="block_starts"), np.int64
        ).copy()
        off += 8 * (nb + 1)
        self.block_offsets = np.frombuffer(
            self._pread_exact(off, 8 * (nb + 1), what="block_offsets"), np.uint64
        ).copy()
        off += 8 * (nb + 1)
        self._degrees = np.frombuffer(
            self._pread_exact(off, 4 * V, what="degrees"), np.uint32
        ).astype(np.int64)
        if self.block_starts[0] != 0 or self.block_starts[-1] != V:
            raise BlockFileError("block_starts must span [0, V]")
        self.block_nverts = np.diff(self.block_starts).astype(np.int64)
        if np.any(self.block_nverts <= 0):
            raise BlockFileError("blocks must be non-empty, increasing")
        # global CSR offsets, reconstructed from degrees (RAM metadata)
        self._indptr = np.zeros(V + 1, dtype=np.int64)
        np.cumsum(self._degrees, out=self._indptr[1:])
        if self._indptr[-1] != E:
            raise BlockFileError("degree table inconsistent with num_edges")
        estarts = self._indptr[self.block_starts]
        self.block_nedges = np.diff(estarts).astype(np.int64)
        # the padded-shape maxima must equal the actual block maxima — the
        # shapes engines jit against, and the RAM backend's invariant
        if self.max_block_verts != int(self.block_nverts.max()) or (
            self.max_block_edges != max(int(self.block_nedges.max()), 1)
        ):
            raise BlockFileError("header block maxima inconsistent with blocks")
        per_edge = 4 + (12 if self.weighted else 0)
        sizes = 4 * (self.block_nverts + 1) + per_edge * self.block_nedges
        expect = np.diff(self.block_offsets.astype(np.int64))
        if not np.array_equal(expect, sizes):
            raise BlockFileError("offset index inconsistent with block sizes")
        if os.fstat(self._fd).st_size != int(self.block_offsets[-1]):
            raise BlockFileError(
                "file size does not match offset index (truncated or corrupt)"
            )

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __enter__(self) -> "DiskBlockedGraph":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass

    def _pread_exact(self, offset: int, n: int, *, what: str) -> bytes:
        raw = os.pread(self._fd, n, offset)
        if len(raw) != n:
            raise BlockFileError(
                f"truncated block file: wanted {n} bytes of {what} at offset "
                f"{offset}, got {len(raw)}"
            )
        return raw

    # -- backend-neutral metadata surface -------------------------------------
    @property
    def num_vertices(self) -> int:
        return self._num_vertices

    @property
    def num_edges(self) -> int:
        return self._num_edges

    @property
    def degrees(self) -> np.ndarray:
        return self._degrees

    @property
    def has_weights(self) -> bool:
        return self.weighted

    def ensure_alias(self) -> None:
        if not self.weighted:
            raise BlockFileError(
                "block file was written without weights/alias tables"
            )

    def block_id_of(self, v) -> np.ndarray:
        return block_of(self.block_starts, v)

    def activated_load_bytes(self, vertices: np.ndarray) -> int:
        return activated_bytes(self._degrees, vertices)

    def row_extents(self, vertices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Global CSR edge range ``[rs, re)`` per vertex of a sorted unique
        ``vertices`` array — resident metadata (the reconstructed degree
        cumsum), no I/O.  The read planner's input on either backend."""
        vs = np.asarray(vertices, dtype=np.int64)
        return self._indptr[vs], self._indptr[vs + 1]

    def describe(self) -> dict:
        return {
            "num_vertices": self._num_vertices,
            "num_edges": self._num_edges,
            "num_blocks": self.num_blocks,
            "max_block_verts": self.max_block_verts,
            "max_block_edges": self.max_block_edges,
            "csr_bytes": 4 * (self._num_vertices + 1 + self._num_edges),
            "edge_cut": self.edge_cut(),
        }

    def edge_cut(self) -> float:
        """Fraction of cross-block edges, computed by streaming every block
        (a metadata/debug pass: not counted against the read counters)."""
        cut = 0
        for b in range(self.num_blocks):
            _, indices, _ = self._read_block_arrays(b, count=False, want_aux=False)
            cut += int(np.sum(block_of(self.block_starts, indices) != b))
        return cut / max(self._num_edges, 1)

    # -- full-load path --------------------------------------------------------
    def _read_block_arrays(self, b: int, *, count: bool = True, want_aux: bool = True):
        """Read block ``b``'s raw Index + CSR slices (and aux arrays)."""
        if not 0 <= b < self.num_blocks:
            raise IndexError(f"block {b} out of range [0, {self.num_blocks})")
        nv = int(self.block_nverts[b])
        ne = int(self.block_nedges[b])
        off = int(self.block_offsets[b])
        raw = self._pread_exact(off, 4 * (nv + 1) + 4 * ne, what=f"block {b}")
        indptr = np.frombuffer(raw, np.int32, count=nv + 1)
        indices = np.frombuffer(raw, np.int32, count=ne, offset=4 * (nv + 1))
        aux = None
        if count:
            self.data_bytes_read += len(raw)
        if self.weighted and want_aux:
            araw = self._pread_exact(
                off + 4 * (nv + 1) + 4 * ne, 12 * ne, what=f"block {b} aux"
            )
            weights = np.frombuffer(araw, np.float32, count=ne)
            alias_j = np.frombuffer(araw, np.int32, count=ne, offset=4 * ne)
            alias_q = np.frombuffer(araw, np.float32, count=ne, offset=8 * ne)
            aux = (weights, alias_j, alias_q)
            if count:
                self.aux_bytes_read += len(araw)
        return indptr, indices, aux

    def materialize_block(self, b: int) -> ResidentBlock:
        """Full load: one positioned read of the block's Index + CSR slices,
        padded to the container-wide maxima (identical arrays to the RAM
        backend's ``materialize_block``).  No caching here — the
        :class:`~repro.io.blockstore.BlockStore` LRU is the resident set."""
        indptr_raw, indices_raw, aux = self._read_block_arrays(b)
        nv = int(self.block_nverts[b])
        ne = int(self.block_nedges[b])
        indptr = np.full(self.max_block_verts + 1, ne, dtype=np.int32)
        indptr[: nv + 1] = indptr_raw
        indices = np.full(self.max_block_edges, -1, dtype=np.int32)
        indices[:ne] = indices_raw
        blk = ResidentBlock(b, int(self.block_starts[b]), nv, ne, indptr, indices)
        self.full_loads += 1
        if aux is not None:
            _w, aj, aq = aux
            alias_j = np.zeros(self.max_block_edges, dtype=np.int32)
            alias_q = np.ones(self.max_block_edges, dtype=np.float32)
            alias_j[:ne] = aj
            alias_q[:ne] = aq
            blk.alias_j, blk.alias_q = alias_j, alias_q
        return blk

    # -- on-demand path --------------------------------------------------------
    def _read_rows_ext(self, b: int, vertices: Iterable[int]):
        """Partial reads of block ``b``'s requested rows — the access
        pattern of the paper's Fig. 5(b).

        With ``io_coalesce_gap == 0`` (reference): for each unique vertex,
        one ``pread`` of its 8-byte index-entry pair then one of its
        neighbor segment.  With the planner on: the index pairs are fetched
        by a few gap-split ranged reads over ``[min_v, max_v]`` of the index
        region, the resulting row extents merge into gap-aware coalesced
        ranges, and segments are sliced out in memory — same bytes charged,
        far fewer syscalls.  Returns ``(vs, rows, extents)`` with ``vs``
        sorted, ``rows[k]`` the global neighbor ids of ``vs[k]`` and
        ``extents[k] = (rs, re)`` its within-block edge range (reused by the
        alias reader so the index pair is never fetched twice)."""
        s, e = int(self.block_starts[b]), int(self.block_starts[b + 1])
        vs = np.unique(np.asarray(list(vertices), dtype=np.int64))
        if vs.size == 0:
            # no pread was issued: not an on-demand read, nothing to count
            return vs, [], []
        if vs[0] < s or vs[-1] >= e:
            raise IndexError(f"vertices outside block {b} range [{s}, {e})")
        nv = int(self.block_nverts[b])
        off = int(self.block_offsets[b])
        indices_off = off + 4 * (nv + 1)
        rows = []
        extents = []
        nbytes = 0
        if self.io_coalesce_gap > 0:
            read = lambda o, n: self._pread_exact(o, n, what=f"coalesced range block {b}")
            lv = vs - s
            iplan = plan_reads(4 * lv, 4 * lv + 8, self.io_coalesce_gap)
            pairs = execute_plan(iplan, read, base=off)
            rplan_s = np.empty(vs.size, np.int64)
            rplan_e = np.empty(vs.size, np.int64)
            for k, buf in enumerate(pairs):
                pair = np.frombuffer(buf, np.int32)
                rplan_s[k], rplan_e[k] = int(pair[0]), int(pair[1])
                extents.append((int(pair[0]), int(pair[1])))
            rplan = plan_reads(4 * rplan_s, 4 * rplan_e, self.io_coalesce_gap)
            for seg in execute_plan(rplan, read, base=indices_off):
                rows.append(np.frombuffer(seg, np.int32).copy())
            nbytes = 8 * vs.size + 4 * int((rplan_e - rplan_s).sum())
            nranges = iplan.num_ranges + rplan.num_ranges
            self.ondemand_syscalls += nranges
            self.coalesced_ranges += nranges
            self.coalesce_waste_bytes += iplan.waste_bytes + rplan.waste_bytes
        else:
            for v in vs:
                lv = int(v) - s
                pair = np.frombuffer(
                    self._pread_exact(off + 4 * lv, 8, what=f"index pair v={v}"),
                    np.int32,
                )
                rs, re = int(pair[0]), int(pair[1])
                nbytes += 8
                seg = self._pread_exact(indices_off + 4 * rs, 4 * (re - rs), what=f"row v={v}")
                rows.append(np.frombuffer(seg, np.int32).copy())
                extents.append((rs, re))
                nbytes += 4 * (re - rs)
            self.ondemand_syscalls += 2 * int(vs.size)
        self.ondemand_reads += 1
        self.ondemand_bytes_read += nbytes
        return vs, rows, extents

    def read_rows(self, b: int, vertices: Iterable[int]) -> Dict[int, np.ndarray]:
        """On-demand load: ``{vertex: global neighbor ids}`` for each unique
        requested vertex of block ``b``.  The bytes read equal
        ``activated_load_bytes(vertices)`` by construction."""
        vs, rows, _ = self._read_rows_ext(b, vertices)
        return {int(v): seg for v, seg in zip(vs, rows)}

    def partial_view(self, b: int, vertices: Iterable[int]) -> BlockView:
        """An *activated* :class:`~repro.core.graph.BlockView` of block
        ``b``: compacted local CSR over only the (unique) requested vertices
        plus the remap table — what on-demand buckets execute on.

        Index + CSR bytes are tallied in ``ondemand_bytes_read`` (equal to
        ``activated_load_bytes``); for a weighted container the rows' alias
        segments are read too (derived data, tallied in ``aux_bytes_read``
        like a full load's).  Mirrors ``BlockedGraph.partial_view`` — same
        view, real reads.
        """
        vs, segs, extents = self._read_rows_ext(b, vertices)
        alias_segs = None
        if self.weighted:
            alias_segs = self._read_alias_rows(b, vs, extents)
        return BlockView.from_rows(b, vs, segs, alias_segs)

    def gather_view(self, vertices: Iterable[int]) -> BlockView:
        """A cross-block activated view (``block_id == -1``): per-vertex
        partial reads grouped by owning block.  Blocks hold contiguous
        vertex ranges, so concatenating the per-block (sorted) rows in
        block order yields a globally sorted remap table.  Real bytes are
        tallied like any on-demand read."""
        vs_all = np.unique(np.asarray(list(vertices), dtype=np.int64))
        owners = block_of(self.block_starts, vs_all)
        all_vs = []
        all_segs = []
        all_alias = [] if self.weighted else None
        for b in np.unique(owners):
            sub = vs_all[owners == b]
            vs, segs, extents = self._read_rows_ext(int(b), sub)
            all_vs.append(vs)
            all_segs.extend(segs)
            if self.weighted:
                all_alias.extend(self._read_alias_rows(int(b), vs, extents))
        vids = np.concatenate(all_vs) if all_vs else np.zeros(0, np.int64)
        return BlockView.from_rows(-1, vids, all_segs, all_alias)

    def _read_alias_rows(self, b: int, vs: np.ndarray, extents):
        """Partial reads of the rows' alias_j/alias_q segments, at the edge
        ranges ``extents`` already fetched by :meth:`_read_rows_ext` — no
        second index-pair read per vertex.  With the planner on, the alias
        extents parallel the row extents, so one plan covers both regions
        (executed twice with different base offsets)."""
        ne = int(self.block_nedges[b])
        nv = int(self.block_nverts[b])
        off = int(self.block_offsets[b])
        aux_off = off + 4 * (nv + 1) + 4 * ne  # weights, then alias_j, alias_q
        out = []
        nbytes = 0
        if self.io_coalesce_gap > 0 and len(vs):
            read = lambda o, n: self._pread_exact(o, n, what=f"coalesced alias block {b}")
            rs = np.asarray([x for x, _ in extents], np.int64)
            re = np.asarray([x for _, x in extents], np.int64)
            aplan = plan_reads(4 * rs, 4 * re, self.io_coalesce_gap)
            j_bufs = execute_plan(aplan, read, base=aux_off + 4 * ne)
            q_bufs = execute_plan(aplan, read, base=aux_off + 8 * ne)
            for jb, qb in zip(j_bufs, q_bufs):
                out.append(
                    (np.frombuffer(jb, np.int32).copy(), np.frombuffer(qb, np.float32).copy())
                )
            nbytes = 8 * int((re - rs).sum())
            self.ondemand_syscalls += 2 * aplan.num_ranges
            self.coalesced_ranges += 2 * aplan.num_ranges
            self.coalesce_waste_bytes += 2 * aplan.waste_bytes
        else:
            for v, (rs, re) in zip(vs, extents):
                rl = re - rs
                aj = np.frombuffer(
                    self._pread_exact(aux_off + 4 * ne + 4 * rs, 4 * rl, what=f"alias_j v={v}"),
                    np.int32,
                ).copy()
                aq = np.frombuffer(
                    self._pread_exact(aux_off + 8 * ne + 4 * rs, 4 * rl, what=f"alias_q v={v}"),
                    np.float32,
                ).copy()
                out.append((aj, aq))
                nbytes += 8 * rl
            self.ondemand_syscalls += 2 * len(vs)
        self.aux_bytes_read += nbytes
        return out

    def partial_block(self, b: int, vertices: Iterable[int]) -> ResidentBlock:
        """An *activated-vertex view* of block ``b``: a padded
        :class:`ResidentBlock` holding only the requested rows, compacted.

        Rows that were not requested come back empty (degree 0); requested
        rows hold the same neighbor lists a full load would.  Reads only the
        requested bytes (tallied in ``ondemand_bytes_read``).
        """
        rows = self.read_rows(b, vertices)
        nv = int(self.block_nverts[b])
        s = int(self.block_starts[b])
        indptr = np.zeros(self.max_block_verts + 1, dtype=np.int32)
        chunks = []
        fill = 0
        for lv in range(nv):
            indptr[lv] = fill
            seg = rows.get(s + lv)
            if seg is not None:
                chunks.append(seg)
                fill += seg.size
        indptr[nv:] = fill
        indices = np.full(self.max_block_edges, -1, dtype=np.int32)
        if chunks:
            cat = np.concatenate(chunks)
            indices[: cat.size] = cat
        return ResidentBlock(b, s, nv, fill, indptr, indices)

    # -- reconstruction --------------------------------------------------------
    def read_csr(self) -> CSRGraph:
        """Stream every block back into one host-RAM :class:`CSRGraph`
        (weights included when present).  Debug/oracle path — requires the
        whole graph to fit in memory, which is exactly what this backend
        otherwise avoids."""
        indices = np.empty(self._num_edges, dtype=np.int32)
        weights = np.empty(self._num_edges, dtype=np.float32) if self.weighted else None
        pos = 0
        for b in range(self.num_blocks):
            _, idx, aux = self._read_block_arrays(b, count=False)
            indices[pos : pos + idx.size] = idx
            if aux is not None:
                weights[pos : pos + idx.size] = aux[0]
            pos += idx.size
        return CSRGraph(self._indptr.copy(), indices, weights)

    def counters(self) -> dict:
        return {
            "full_loads": self.full_loads,
            "ondemand_reads": self.ondemand_reads,
            "data_bytes_read": self.data_bytes_read,
            "aux_bytes_read": self.aux_bytes_read,
            "ondemand_bytes_read": self.ondemand_bytes_read,
            "ondemand_syscalls": self.ondemand_syscalls,
            "coalesced_ranges": self.coalesced_ranges,
            "coalesce_waste_bytes": self.coalesce_waste_bytes,
        }


def write_and_open(
    bg: BlockedGraph,
    directory: Optional[str] = None,
    *,
    name: str = BLOCK_FILE_NAME,
    io_coalesce_gap: int = 0,
) -> DiskBlockedGraph:
    """Serialise ``bg`` into ``directory`` and open the container — the
    one-call disk-backend bootstrap shared by the launcher
    (``--graph-backend disk``) and the benchmark harness.
    ``io_coalesce_gap`` sets the opened reader's gap-aware read-planner
    waste budget (0 = per-vertex reference reads).

    When ``directory`` is ``None`` a scratch dir is created and removed at
    interpreter exit; pass an explicit directory to keep the container
    around for reuse across runs.
    """
    if directory is None:
        import atexit

        scratch = tempfile.TemporaryDirectory(prefix="grasorw_graph_")
        atexit.register(scratch.cleanup)
        directory = scratch.name
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    write_block_file(bg, path)
    return DiskBlockedGraph(path, io_coalesce_gap=io_coalesce_gap)
