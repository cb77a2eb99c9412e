"""Random-walk transition models (paper §2.1) and walk tasks (§7.1).

A transition model owns the *math* of one step — proposal + acceptance — and
a task owns the walk population and termination rule.  Both are declarative
descriptions consumed by the engines; the actual batched step execution lives
in :mod:`repro.core.engine` / :mod:`repro.kernels`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "TransitionModel",
    "DeepWalk",
    "Node2vec",
    "WalkTask",
    "rwnv_task",
    "prnv_task",
    "deepwalk_task",
]


@dataclasses.dataclass(frozen=True)
class TransitionModel:
    """Base — first-order by default (p(z|v) ∝ a_vz via alias draw)."""

    #: second-order models need N(u); first-order models ignore it
    order: int = 1

    @property
    def name(self) -> str:
        return type(self).__name__.lower()

    def max_bias(self) -> float:
        return 1.0


@dataclasses.dataclass(frozen=True)
class DeepWalk(TransitionModel):
    """First-order: p(z|v) = a_vz / Z_v."""

    order: int = 1


@dataclasses.dataclass(frozen=True)
class Node2vec(TransitionModel):
    """Second-order with return parameter ``p`` and in-out parameter ``q``
    (Eq. 1).  ``p = q = 1`` is the paper's main experimental setting."""

    order: int = 2
    p: float = 1.0
    q: float = 1.0

    def max_bias(self) -> float:
        return max(1.0, 1.0 / self.p, 1.0 / self.q)


@dataclasses.dataclass(frozen=True)
class WalkTask:
    """A walk workload.

    RWNV: ``walks_per_vertex`` walks from *every* vertex, fixed ``length``.
    PRNV: ``total_walks`` walks from ``query_vertex`` with restart
    probability ``1 - decay`` and max length ``length`` (walk-with-restart
    second-order PageRank of Wu et al.).
    """

    model: TransitionModel
    length: int = 80
    walks_per_vertex: int = 10
    query_vertex: Optional[int] = None  # None => start from every vertex
    total_walks: Optional[int] = None  # only for query tasks
    decay: float = 1.0  # termination: continue with prob ``decay`` per step
    seed: int = 0

    def initial_walks(self, num_vertices: int) -> np.ndarray:
        """Source vertex per walk."""
        if self.query_vertex is not None:
            n = self.total_walks if self.total_walks is not None else 4 * num_vertices
            return np.full(n, self.query_vertex, dtype=np.int64)
        return np.repeat(np.arange(num_vertices, dtype=np.int64), self.walks_per_vertex)

    @property
    def uses_restart(self) -> bool:
        return self.decay < 1.0


def rwnv_task(
    p: float = 1.0, q: float = 1.0, *, walks_per_vertex: int = 10, length: int = 80, seed: int = 0
) -> WalkTask:
    """Random Walk generation with the Node2vec model (benchmark 1, §7.1)."""
    return WalkTask(Node2vec(p=p, q=q), length=length, walks_per_vertex=walks_per_vertex, seed=seed)


def prnv_task(
    query_vertex: int,
    num_vertices: int,
    *,
    p: float = 1.0,
    q: float = 1.0,
    decay: float = 0.85,
    length: int = 20,
    samples_per_vertex: int = 4,
    seed: int = 0,
) -> WalkTask:
    """PageRank Query with the Node2vec model (benchmark 2, §7.1)."""
    return WalkTask(
        Node2vec(p=p, q=q),
        length=length,
        query_vertex=query_vertex,
        total_walks=samples_per_vertex * num_vertices,
        decay=decay,
        seed=seed,
    )


def deepwalk_task(*, walks_per_vertex: int = 10, length: int = 80, seed: int = 0) -> WalkTask:
    """First-order DeepWalk task (paper §7.8)."""
    return WalkTask(DeepWalk(), length=length, walks_per_vertex=walks_per_vertex, seed=seed)
