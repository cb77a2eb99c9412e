"""Point-query vocabulary for the walk-serving front end.

The batch system answers "run W walks from *every* vertex" (RWNV, §7.1);
production traffic is millions of users asking "run a few walks from *my*
vertex" — personalized PageRank (the PRNV workload of Wu et al., §7.1) or
node2vec neighborhood samples for one item.  A :class:`WalkQuery` is one
such request: a source vertex plus the :class:`QueryConfig` describing its
walk population (Node2vec ``p``/``q`` of Eq. 1, max length, restart decay,
and ``samples`` — how many walks estimate this one answer).

Queries sharing a :class:`QueryConfig` can ride one engine run: the server
concatenates their sources into a single walk batch (every walk keeps a
contiguous walk-id range per query), so the triangular bi-block sweep
(§4.2) amortizes each block load across *all* concurrent queries — the
paper's bucket economics turned into a latency story.  A
:class:`QueryAnswer` is materialized from the walk endpoints the engine
retires for that query's walk ids: normalized, they are the Monte-Carlo
PPR estimate (walk-with-restart, §7.1); raw, they are the sampled
neighbor multiset.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.transition import Node2vec, WalkTask

__all__ = ["QueryConfig", "WalkQuery", "QueryAnswer"]


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    """Walk population of one point query.

    Queries with equal configs are admission-batched into one engine run
    (the config is the batching key), so keep the config space small in a
    serving deployment — a handful of products, not per-user knobs.
    """

    p: float = 1.0  # Node2vec return parameter (Eq. 1)
    q: float = 1.0  # Node2vec in-out parameter (Eq. 1)
    length: int = 20  # max hops per walk
    decay: float = 0.85  # continue probability per step (1 - restart prob)
    samples: int = 32  # walks estimating this query's answer

    def task(self, seed: int) -> WalkTask:
        """The :class:`WalkTask` an admitted batch of these queries runs
        as.  Walk sources are injected by the server (``initial_walks``
        engine seam), so the task only carries the shared model/termination
        settings — and the batch seed, which together with a walk's id
        fully determines its trajectory (counter-based RNG)."""
        return WalkTask(
            Node2vec(p=self.p, q=self.q),
            length=self.length,
            decay=self.decay,
            seed=seed,
        )


@dataclasses.dataclass
class WalkQuery:
    """One submitted query: identity, source, config, and its clock times
    (``t_submit`` at admission, ``t_answer`` when the answer materialized —
    the difference is the per-query serving latency)."""

    qid: int
    source: int
    config: QueryConfig
    t_submit: float
    t_answer: Optional[float] = None

    @property
    def latency(self) -> Optional[float]:
        if self.t_answer is None:
            return None
        return self.t_answer - self.t_submit


@dataclasses.dataclass
class QueryAnswer:
    """Materialized answer: the endpoint multiset of one query's walks.

    ``vertices``/``counts`` are the unique termination vertices and their
    visit counts — sparse, because a query's ``samples`` walks touch far
    fewer vertices than the graph holds.  Both read-outs the ROADMAP names
    come from this one multiset: :meth:`ppr` (normalized counts — the
    Monte-Carlo walk-with-restart PPR estimate) and
    :meth:`neighbor_multiset` (raw counts — node2vec neighborhood samples).
    """

    qid: int
    source: int
    num_walks: int
    vertices: np.ndarray  # unique endpoint vertex ids, sorted
    counts: np.ndarray  # visits at termination, aligned with ``vertices``
    latency: float  # submit -> answer seconds (wall clock)

    def ppr(self) -> Tuple[np.ndarray, np.ndarray]:
        """Sparse PPR estimate: ``(vertices, probabilities)``."""
        tot = max(int(self.counts.sum()), 1)
        return self.vertices, self.counts / tot

    def top(self, k: int = 10) -> List[Tuple[int, float]]:
        """The ``k`` highest-probability vertices (ties break low-id)."""
        verts, probs = self.ppr()
        order = np.lexsort((verts, -probs))[:k]
        return [(int(verts[i]), float(probs[i])) for i in order]

    def neighbor_multiset(self) -> Dict[int, int]:
        """Endpoint multiset as ``vertex -> count``."""
        return {int(v): int(c) for v, c in zip(self.vertices, self.counts)}

    def dense_counts(self, num_vertices: int) -> np.ndarray:
        """Dense ``[V]`` endpoint histogram (CRC checks, oracle compares)."""
        out = np.zeros(num_vertices, np.int64)
        out[self.vertices] = self.counts
        return out
