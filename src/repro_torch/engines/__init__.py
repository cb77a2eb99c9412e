"""Walk engines (PyTorch port): the bi-block engine on the shared
:class:`EngineBase` plumbing, and the pair advance it runs on the device.
"""

from .base import EngineBase, ResidentPair, WalkResult, resolve_device
from .biblock import BiBlockEngine
from .pipeline import BucketCursor, BucketPipeline
from .step import pair_advance_ref, pow2_pad

__all__ = [
    "BiBlockEngine",
    "BucketCursor",
    "BucketPipeline",
    "EngineBase",
    "ResidentPair",
    "WalkResult",
    "pair_advance_ref",
    "pow2_pad",
    "resolve_device",
]
