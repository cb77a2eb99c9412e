"""Query serving (PyTorch port): point random-walk queries over the
disk-based engine.

The port of ``repro/serve``: the same front end, with every admitted batch
run by the port's bi-block engine on the card (the hand-written CUDA pair
advance) unless the server is asked for the CPU.  It turns a stream of
``(source, config)`` point queries into admission batches
(:mod:`~repro_torch.serve.admission`) that ride the stock triangular
bi-block sweep (§4.2) through the ``initial_walks`` / shared-``BlockStore``
seams of :class:`~repro_torch.engines.base.EngineBase`, pins the
query-traffic hot set of blocks in memory
(:mod:`~repro_torch.serve.policy`), and materializes per-query PPR /
neighbor-multiset answers with submit→answer latency
(:mod:`~repro_torch.serve.query`, :mod:`~repro_torch.serve.server`).

Everything is deterministic: the counter-based RNG makes served walks bit
identical to the equivalent direct batch run, and pinning changes only
what is *charged*, never what executes.  Answers, batch seeds and charges
equal the JAX package's server's bit for bit.
"""

from .admission import AdmissionQueue
from .policy import HotSetPolicy
from .query import QueryAnswer, QueryConfig, WalkQuery
from .server import WalkQueryServer

__all__ = [
    "AdmissionQueue",
    "HotSetPolicy",
    "QueryAnswer",
    "QueryConfig",
    "WalkQuery",
    "WalkQueryServer",
]
