"""Backward-compatibility shim — the engines live in :mod:`repro_torch.engines`.

The port's twin of ``repro.core.engine``: the same names, importable from
``repro_torch.core.engine``, with two differences.  The JAX package's
``advance_pair`` / ``pair_advance_impl`` (its jitted pair advance) have no
counterpart here; the port's plain pair advance is ``pair_advance_ref``
(the kernel is :func:`repro_torch.kernels.fused_advance_pair`).  And
``_DeviceBlockPair`` is :class:`ResidentPair`, as it is in the JAX package.
"""

from repro_torch.engines import (  # noqa: F401
    BiBlockEngine,
    EngineBase,
    InMemoryWalker,
    PlainBucketEngine,
    ResidentPair,
    SOGWEngine,
    WalkResult,
    pair_advance_ref,
    pow2_pad,
)
from repro_torch.engines.base import EngineBase as _EngineBase  # noqa: F401
from repro_torch.engines.step import pow2_pad as _pow2_pad  # noqa: F401

_DeviceBlockPair = ResidentPair

__all__ = [
    "WalkResult",
    "BiBlockEngine",
    "EngineBase",
    "PlainBucketEngine",
    "ResidentPair",
    "SOGWEngine",
    "InMemoryWalker",
    "pair_advance_ref",
    "pow2_pad",
    "_DeviceBlockPair",
    "_EngineBase",
    "_pow2_pad",
]
