"""GraSorw core (PyTorch port): graphs, partitions, buckets, scheduling,
loading and stats — jax-free numpy, kept as the port's own copy.

The engines (:mod:`repro_torch.engines`) and the storage layer
(:mod:`repro_torch.io`) are re-exported lazily (PEP 562): they import this
package's submodules, so eager re-imports here would be circular.
"""

import importlib

from .buckets import (
    bucket_ids,
    skewed_block_assignment,
    split_into_buckets,
    traditional_block_assignment,
)
from .generators import (
    barabasi_albert,
    circulant_graph,
    erdos_renyi,
    rmat,
    stochastic_block_model,
)
from .graph import BlockedGraph, BlockView, CSRGraph, ResidentBlock, block_of
from .loader import BlockLoadingModel, LinearCostModel
from .partition import (
    greedy_locality_partition,
    partition_into_n_blocks,
    sequential_partition,
)
from .scheduler import (
    make_scheduler,
    standard_block_io_bound,
    triangular_block_io_bound,
    triangular_pairs,
)
from .stats import HBM_V5E, ICI_V5E, SSD, DevicePreset, IOStats
from .transition import (
    DeepWalk,
    Node2vec,
    WalkTask,
    deepwalk_task,
    prnv_task,
    rwnv_task,
)
from .walk import WALK_BYTES, WalkBatch, pack_walks, unpack_walks

#: lazily re-exported names -> providing module (avoids import cycles)
_LAZY = {
    "BiBlockEngine": "repro_torch.engines",
    "EngineBase": "repro_torch.engines",
    "InMemoryWalker": "repro_torch.engines",
    "PlainBucketEngine": "repro_torch.engines",
    "SOGWEngine": "repro_torch.engines",
    "WalkResult": "repro_torch.engines",
    "ResidentPair": "repro_torch.engines",
    "pair_advance_ref": "repro_torch.engines",
    "BlockStore": "repro_torch.io",
    "BlockFileError": "repro_torch.io",
    "DiskBlockedGraph": "repro_torch.io",
    "write_block_file": "repro_torch.io",
    "write_and_open": "repro_torch.io",
    "DiskWalkPool": "repro_torch.io",
    "MemoryWalkPool": "repro_torch.io",
    "ShardedWalkPool": "repro_torch.io",
    "WalkPool": "repro_torch.io",
    "make_walk_pool": "repro_torch.io",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


__all__ = sorted(
    set(_LAZY)
    | {
        "BlockedGraph", "BlockView", "CSRGraph", "ResidentBlock", "block_of",
        "BlockLoadingModel", "LinearCostModel", "greedy_locality_partition",
        "partition_into_n_blocks", "sequential_partition", "make_scheduler",
        "standard_block_io_bound", "triangular_block_io_bound", "triangular_pairs",
        "DevicePreset", "IOStats", "SSD", "HBM_V5E", "ICI_V5E", "DeepWalk",
        "Node2vec", "WalkTask", "deepwalk_task", "prnv_task", "rwnv_task",
        "WalkBatch", "WALK_BYTES", "pack_walks", "unpack_walks", "bucket_ids",
        "skewed_block_assignment", "split_into_buckets",
        "traditional_block_assignment", "barabasi_albert", "circulant_graph",
        "erdos_renyi", "rmat", "stochastic_block_model",
    }
)
