"""Walk engines (PyTorch port) on the shared :class:`EngineBase` plumbing,
and the pair advance they run on the device.

* :class:`BiBlockEngine` — the paper's system (GraSorw).
* :class:`PlainBucketEngine` / :class:`SOGWEngine` — the §7 baselines
  (``SOGWEngine(static_cache=True)`` is SGSC).
* :class:`InMemoryWalker` — whole-graph fast path: the oracle for
  correctness tests and the corpus generator.
"""

from .base import EngineBase, ResidentPair, WalkResult, resolve_device
from .baselines import PlainBucketEngine, SOGWEngine
from .biblock import BiBlockEngine
from .inmemory import InMemoryWalker
from .pipeline import BucketCursor, BucketPipeline
from .step import pair_advance_ref, pow2_pad

__all__ = [
    "BiBlockEngine",
    "BucketCursor",
    "BucketPipeline",
    "EngineBase",
    "InMemoryWalker",
    "PlainBucketEngine",
    "ResidentPair",
    "SOGWEngine",
    "WalkResult",
    "pair_advance_ref",
    "pow2_pad",
    "resolve_device",
]
