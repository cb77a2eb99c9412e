"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version, and the single-hop kernel tier over them (the port of
``repro.kernels``).  Sources live in ``csrc/``; :mod:`.build` compiles them
with ``nvcc`` at first use.  Nothing here builds or imports a compiler when
the package is imported.
"""

from . import rng
from .bucket_hist import bucket_hist_kernel, bucket_hist_ref
from .node2vec_ref import node2vec_step_ref
from .ops import alias_step, node2vec_step
from .pair_advance import fused_advance_pair

__all__ = [
    "alias_step",
    "bucket_hist_kernel",
    "bucket_hist_ref",
    "fused_advance_pair",
    "node2vec_step",
    "node2vec_step_ref",
    "rng",
]
