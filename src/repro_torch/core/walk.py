"""Walk state — struct-of-arrays batches plus the paper's 128-bit encoding.

The engine operates on SoA numpy/jnp batches (``src, prev, cur, hop``); the
disk-resident walk pools use the paper's 128-bit packed record (§6.1, Fig. 7)
so walk-I/O byte accounting matches the paper.  Our field layout (sums to 128):

    source vertex : 36 bits   (up to ~68.7 G vertices)
    prev vertex   : 36 bits
    cur offset    : 26 bits   (offset of cur within its block)
    prev block    : 10 bits   (<= 1024 blocks, as the paper)
    cur block     : 10 bits
    hop           : 10 bits   (<= 1024 steps, as the paper)

jnp has no uint128 (and uint64 needs x64 mode) so a packed record is 4 uint32
lanes; pack/unpack are pure vector ops usable under jit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["WalkBatch", "pack_walks", "unpack_walks", "WALK_BYTES"]

WALK_BYTES = 16

_SRC_BITS, _PREV_BITS, _CUR_BITS = 36, 36, 26
_BLK_BITS, _HOP_BITS = 10, 10


@dataclasses.dataclass
class WalkBatch:
    """SoA batch of walks (host numpy; device twins are plain dicts of jnp)."""

    src: np.ndarray  # [n] int64 — source vertex (walk identity / restart target)
    prev: np.ndarray  # [n] int64 — previous vertex u
    cur: np.ndarray  # [n] int64 — current vertex v
    hop: np.ndarray  # [n] int32 — steps taken so far

    def __post_init__(self) -> None:
        self.src = np.asarray(self.src, dtype=np.int64)
        self.prev = np.asarray(self.prev, dtype=np.int64)
        self.cur = np.asarray(self.cur, dtype=np.int64)
        self.hop = np.asarray(self.hop, dtype=np.int32)

    def __len__(self) -> int:
        return int(self.src.shape[0])

    def select(self, mask_or_idx) -> "WalkBatch":
        return WalkBatch(
            self.src[mask_or_idx],
            self.prev[mask_or_idx],
            self.cur[mask_or_idx],
            self.hop[mask_or_idx],
        )

    @staticmethod
    def concat(batches: list["WalkBatch"]) -> "WalkBatch":
        batches = [b for b in batches if len(b)]
        if not batches:
            return WalkBatch.empty()
        return WalkBatch(
            np.concatenate([b.src for b in batches]),
            np.concatenate([b.prev for b in batches]),
            np.concatenate([b.cur for b in batches]),
            np.concatenate([b.hop for b in batches]),
        )

    @staticmethod
    def empty() -> "WalkBatch":
        z64 = np.zeros(0, np.int64)
        return WalkBatch(z64, z64, z64, np.zeros(0, np.int32))


def _split_hi_lo(x: np.ndarray, lo_bits: int) -> Tuple[np.ndarray, np.ndarray]:
    return (x >> lo_bits).astype(np.uint32), (x & ((1 << lo_bits) - 1)).astype(np.uint32)


def pack_walks(batch: WalkBatch, block_starts: np.ndarray) -> np.ndarray:
    """Pack to the 128-bit record: returns uint32[n, 4].

    ``cur`` is stored as (cur_block, offset-in-block) exactly as the paper's
    Fig. 7 ("Cur Vertex is the offset of the current vertex in its residing
    block"); ``prev`` is stored as a full vertex id.
    """
    from .graph import block_of

    n = len(batch)
    src = batch.src.astype(np.uint64)
    prev = batch.prev.astype(np.uint64)
    cur_blk = block_of(block_starts, batch.cur).astype(np.uint64)
    prev_blk = block_of(block_starts, batch.prev).astype(np.uint64)
    cur_off = (batch.cur - block_starts[cur_blk.astype(np.int64)]).astype(np.uint64)
    hop = batch.hop.astype(np.uint64)

    if np.any(src >= (1 << _SRC_BITS)) or np.any(prev >= (1 << _PREV_BITS)):
        raise OverflowError("vertex id exceeds 36-bit walk encoding")
    if np.any(cur_off >= (1 << _CUR_BITS)):
        raise OverflowError("block offset exceeds 26-bit walk encoding")
    if np.any(cur_blk >= (1 << _BLK_BITS)) or np.any(hop >= (1 << _HOP_BITS)):
        raise OverflowError("block id / hop exceeds 10-bit walk encoding")

    # bit layout over a logical uint128, least significant first:
    # [hop:10][cur_blk:10][prev_blk:10][cur_off:26][prev:36][src:36]
    w = np.zeros((n, 4), dtype=np.uint64)  # 2x64 staging, then split to 4x32
    lo = hop | (cur_blk << 10) | (prev_blk << 20) | (cur_off << 30) | ((prev & 0xFF) << 56)
    hi = (prev >> 8) | (src << 28)  # 28 bits of prev + 36 bits of src = 64
    out = np.empty((n, 4), dtype=np.uint32)
    out[:, 0] = (lo & 0xFFFFFFFF).astype(np.uint32)
    out[:, 1] = (lo >> 32).astype(np.uint32)
    out[:, 2] = (hi & 0xFFFFFFFF).astype(np.uint32)
    out[:, 3] = (hi >> 32).astype(np.uint32)
    del w
    return out


def unpack_walks(packed: np.ndarray, block_starts: np.ndarray) -> WalkBatch:
    """Inverse of :func:`pack_walks`."""
    packed = np.asarray(packed, dtype=np.uint32)
    lo = packed[:, 0].astype(np.uint64) | (packed[:, 1].astype(np.uint64) << 32)
    hi = packed[:, 2].astype(np.uint64) | (packed[:, 3].astype(np.uint64) << 32)
    hop = (lo & 0x3FF).astype(np.int32)
    cur_blk = ((lo >> 10) & 0x3FF).astype(np.int64)
    cur_off = ((lo >> 30) & ((1 << 26) - 1)).astype(np.int64)
    prev = (((lo >> 56) & 0xFF) | ((hi & ((1 << 28) - 1)) << 8)).astype(np.int64)
    src = (hi >> 28).astype(np.int64)
    cur = block_starts[cur_blk] + cur_off
    return WalkBatch(src, prev, cur, hop)
