"""Gap-aware read planner for the on-demand path (the paper's central claim
— random I/Os turned into sequential I/Os — applied to Fig. 5(b)'s access
pattern).

The per-vertex reference path issues four tiny ``pread``\\ s per activated
vertex: index-entry pair, row segment, alias_j, alias_q.  This module plans
the same transfer as a handful of large ranged reads instead:

1. the 8-byte index-entry pairs of a block's sorted activated vertices are
   fetched in one ranged read over ``[min_v, max_v]`` of the index region
   (or a few gap-split ranges);
2. the resulting row extents — and the parallel alias_j/alias_q extents —
   are merged into coalesced ranges under a waste budget ``gap_bytes``: a
   hole between two extents no larger than the budget is *read through*
   rather than paid for with a seek;
3. the plan executes as one ``pread`` per range and the per-vertex segments
   are sliced out in memory.

The planner is pure byte-extent math over resident metadata (degrees +
block starts), so the same function drives both the real executor
(:class:`repro.io.blockfile.DiskBlockedGraph`) and the *modelled*
deterministic gauges (:func:`model_ondemand_io`, charged through
``IOStats.note_ondemand_plan`` by the :class:`~repro.io.blockstore
.BlockStore` on either graph backend).  Merging and waste are invariant
under a constant offset shift, so planning in block-relative file
coordinates (executor) and in global CSR coordinates (model) yields the
same range count and the same waste — the property the real-vs-charged
counter tests pin.

Accounting stays honest: useful bytes (what ``activated_load_bytes``
charges) never change; the read-through hole bytes are metered separately
as ``coalesce_waste_bytes``.  ``gap_bytes <= 0`` means the planner is off
and the per-vertex reference path runs bit-for-bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import block_of

__all__ = ["ReadPlan", "plan_reads", "execute_plan", "model_ondemand_io"]


@dataclasses.dataclass(frozen=True)
class ReadPlan:
    """A batch of coalesced ranged reads plus the per-segment slice table.

    ``ranges`` are half-open ``[start, end)`` byte ranges in the caller's
    (region-relative) coordinates; ``seg_range[k]`` names the range holding
    requested extent ``k`` (``-1`` for an empty extent — no read at all),
    and ``seg_start``/``seg_len`` locate the extent so
    :func:`execute_plan` can slice it out of the range's buffer.
    """

    ranges: np.ndarray  # [R, 2] int64, merged half-open byte ranges
    seg_range: np.ndarray  # [K] int64, owning range per extent (-1: empty)
    seg_start: np.ndarray  # [K] int64, extent start (same coordinates)
    seg_len: np.ndarray  # [K] int64, extent length
    useful_bytes: int  # union of the requested extents
    waste_bytes: int  # read-through hole bytes: total - useful

    @property
    def num_ranges(self) -> int:
        return int(self.ranges.shape[0])

    @property
    def total_bytes(self) -> int:
        if self.ranges.shape[0] == 0:
            return 0
        return int((self.ranges[:, 1] - self.ranges[:, 0]).sum())


def plan_reads(starts, ends, gap_bytes: int = 0) -> ReadPlan:
    """Merge sorted byte extents into gap-aware coalesced ranges.

    ``starts``/``ends`` are parallel arrays of half-open extents, sorted by
    start (the natural order of a block's activated vertices).  The merge
    rule: an extent joins the open range when the hole between them is at
    most ``gap_bytes`` (``next_start - range_end <= gap_bytes``) — the hole
    is read through rather than seeked over.  Overlapping or adjacent
    extents always merge with zero waste, so at ``gap_bytes == 0`` the plan
    moves exactly the union of the requested extents (``waste_bytes == 0``).
    Empty extents consume no range (and no read).
    """
    starts = np.asarray(starts, dtype=np.int64).reshape(-1)
    ends = np.asarray(ends, dtype=np.int64).reshape(-1)
    if starts.shape != ends.shape:
        raise ValueError("starts and ends must be parallel arrays")
    if np.any(ends < starts):
        raise ValueError("extents must satisfy end >= start")
    if starts.size > 1 and np.any(np.diff(starts) < 0):
        raise ValueError("extents must be sorted by start")
    gap = max(int(gap_bytes), 0)
    seg_range = np.full(starts.size, -1, np.int64)
    ranges: list[list[int]] = []
    useful = 0
    cover_end: int | None = None  # union high-water mark (extents are sorted)
    cur: list[int] | None = None
    for k in range(starts.size):
        s0, e0 = int(starts[k]), int(ends[k])
        if e0 == s0:
            continue  # empty extent: nothing to read
        if cover_end is None or s0 >= cover_end:
            useful += e0 - s0
            cover_end = e0
        elif e0 > cover_end:
            useful += e0 - cover_end
            cover_end = e0
        if cur is not None and s0 - cur[1] <= gap:
            cur[1] = max(cur[1], e0)
        else:
            cur = [s0, e0]
            ranges.append(cur)
        seg_range[k] = len(ranges) - 1
    ranges_arr = np.asarray(ranges, np.int64).reshape(-1, 2)
    total = int((ranges_arr[:, 1] - ranges_arr[:, 0]).sum()) if ranges else 0
    return ReadPlan(
        ranges=ranges_arr,
        seg_range=seg_range,
        seg_start=starts.copy(),
        seg_len=ends - starts,
        useful_bytes=useful,
        waste_bytes=total - useful,
    )


def execute_plan(plan: ReadPlan, read, base: int = 0) -> list:
    """Execute ``plan``: one ``read(offset, length)`` per coalesced range,
    then slice the per-extent segments out in memory.  ``base`` shifts the
    plan's region-relative coordinates to absolute file offsets.  Returns
    one buffer (memoryview) per requested extent, ``b""`` for empty ones.
    """
    bufs = [read(base + int(s0), int(e0 - s0)) for s0, e0 in plan.ranges]
    out = []
    for k in range(plan.seg_range.size):
        r = int(plan.seg_range[k])
        if r < 0:
            out.append(b"")
            continue
        off = int(plan.seg_start[k] - plan.ranges[r, 0])
        out.append(memoryview(bufs[r])[off : off + int(plan.seg_len[k])])
    return out


def model_ondemand_io(bg, vertices, gap_bytes: int = 0) -> tuple[int, int, int]:
    """``(syscalls, coalesced_ranges, waste_bytes)`` an on-demand gather of
    ``vertices`` costs under the planner — pure metadata math (degrees +
    block starts), identical on the in-RAM and file-backed graph backends.

    With the planner off (``gap_bytes <= 0``) the reference path issues two
    ``pread``\\ s per unique vertex (index pair + row segment), plus two
    more (alias_j + alias_q) on a weighted graph, and no range was ever
    coalesced.  With the planner on, every region's extents merge under the
    waste budget exactly as the executor merges them (same
    :func:`plan_reads` on offset-shifted copies of the same extents), so
    the modelled gauges equal the real counters whenever the real reads
    happen (prefetch off).
    """
    vs = np.unique(np.asarray(vertices, dtype=np.int64))
    if vs.size == 0:
        return 0, 0, 0
    weighted = bool(bg.has_weights)
    if int(gap_bytes) <= 0:
        return (4 if weighted else 2) * int(vs.size), 0, 0
    rs, re = bg.row_extents(vs)
    owners = block_of(bg.block_starts, vs)
    syscalls = waste = 0
    for b in np.unique(owners):
        m = owners == b
        sub = vs[m]
        # index region: the 8-byte entry pair of each vertex (global
        # coordinates — a constant shift of the on-disk local offsets)
        iplan = plan_reads(4 * sub, 4 * sub + 8, gap_bytes)
        rplan = plan_reads(4 * rs[m], 4 * re[m], gap_bytes)
        n_ranges = iplan.num_ranges + rplan.num_ranges
        n_waste = iplan.waste_bytes + rplan.waste_bytes
        if weighted:
            # alias_j/alias_q extents parallel the row extents: the executor
            # reuses the row plan for both regions
            n_ranges += 2 * rplan.num_ranges
            n_waste += 2 * rplan.waste_bytes
        syscalls += n_ranges
        waste += n_waste
    return syscalls, syscalls, waste
