"""Storage/I/O subsystem: walk pools (the "disk" tier for walk state), the
block store (resident-block cache + background prefetch), and the on-disk
block container (:mod:`repro.io.blockfile`).

Engines in :mod:`repro.engines` persist walks exclusively through a
:class:`WalkPool` backend and load graph blocks exclusively through a
:class:`BlockStore`; the store serves either the in-RAM
:class:`repro.core.graph.BlockedGraph` or the file-backed
:class:`DiskBlockedGraph`, so this package is the seam for sharded pools,
async bucket pipelines, multi-device walkers, and graphs larger than host
memory.
"""

from .blockfile import (
    BLOCK_FILE_NAME,
    BlockFileError,
    DiskBlockedGraph,
    write_and_open,
    write_block_file,
)
from .blockstore import BlockStore
from .ioplan import ReadPlan, execute_plan, model_ondemand_io, plan_reads
from .walkpool import (
    AsyncWalkPool,
    DiskWalkPool,
    MemoryWalkPool,
    ShardedWalkPool,
    WalkPool,
    make_walk_pool,
    shard_of_block,
)

__all__ = [
    "AsyncWalkPool",
    "BLOCK_FILE_NAME",
    "BlockFileError",
    "BlockStore",
    "DiskBlockedGraph",
    "DiskWalkPool",
    "MemoryWalkPool",
    "ReadPlan",
    "ShardedWalkPool",
    "WalkPool",
    "execute_plan",
    "make_walk_pool",
    "model_ondemand_io",
    "plan_reads",
    "shard_of_block",
    "write_and_open",
    "write_block_file",
]
