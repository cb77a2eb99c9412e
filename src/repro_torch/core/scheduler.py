"""Block scheduling strategies (paper §4.1/§4.2 + Appendix A).

The minimal-current-block-I/O problem is NP-hard (reduction from shortest
common supersequence, Thm. 1), and the block access sequence of a walk is
only revealed online, so the paper adopts heuristics.  We implement every
strategy from Appendix A — they drive the baseline engines and the Table-8
benchmark — and the triangular pair schedule (Eq. 3) used by the bi-block
engine.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

__all__ = [
    "TimeSlotPlan",
    "triangular_pairs",
    "triangular_block_io_bound",
    "standard_block_io_bound",
    "CurrentBlockScheduler",
    "AlphabetScheduler",
    "IterationScheduler",
    "MinHeightScheduler",
    "MaxSumScheduler",
    "GraphWalkerScheduler",
    "make_scheduler",
]


def triangular_pairs(num_blocks: int) -> Iterator[tuple[int, list[int]]]:
    """Yield (current block b, ancillary ids b+1..N_B-1) — Alg. 1 lines 2/13."""
    for b in range(num_blocks - 1):
        yield b, list(range(b + 1, num_blocks))


class TimeSlotPlan:
    """The triangular slot order (Eq. 3) as an explicit, queryable plan.

    One *slot* is the execution of one current block within a superstep.
    Second-order tasks visit ``b = 0 .. N_B-2`` (the last block never owns a
    skewed pool: ``min(B(u), B(v)) < N_B-1`` whenever the pair spans blocks);
    first-order tasks visit every block (traditional ``B(cur)`` association,
    §7.8).  The plan is what the async bucket pipeline schedules from: it
    names the *next* slot (including the wrap into the next superstep) before
    the current one finishes, so the next slot's pool drain, bucket split and
    current-view load can start on background workers.  The plan is static;
    which slots actually *run* stays a property of the live pool counts, so
    planning can never change what executes.
    """

    def __init__(self, num_blocks: int, order: int = 2):
        self.num_blocks = num_blocks
        self.order = order
        last = num_blocks if order == 1 else max(num_blocks - 1, 1)
        self.slot_blocks = tuple(range(last))

    def slots(self) -> Iterator[int]:
        """Current-block ids of one superstep, in triangular order."""
        return iter(self.slot_blocks)

    def ancillary_after(self, b: int) -> range:
        """Ancillary block ids a slot on ``b`` may visit (strictly increasing
        bucket cursor, Alg. 1)."""
        return range(b + 1, self.num_blocks)

    def next_slot(self, b: int, has_walks) -> Optional[int]:
        """The next slot after ``b`` that currently has walks pending, probing
        the rest of this superstep first, then wrapping into the next one.

        ``has_walks(block) -> bool`` queries live state (pool counts plus any
        already-preloaded batches); a block that only *gains* walks after this
        call is simply picked later — a missed overlap, never a missed slot.
        """
        n = len(self.slot_blocks)
        for k in range(1, n + 1):
            cand = self.slot_blocks[(b + k) % n]
            if has_walks(cand):
                return cand
        return None


def triangular_block_io_bound(num_blocks: int) -> int:
    """Eq. 3: N_B - 1 + sum_{b=0}^{N_B-2} (N_B - 1 - b) = (N_B+2)(N_B-1)/2."""
    n = num_blocks
    return (n + 2) * (n - 1) // 2


def standard_block_io_bound(num_blocks: int) -> int:
    """Eq. 2: N_B + N_B (N_B - 1) = N_B^2."""
    return num_blocks * num_blocks


class CurrentBlockScheduler:
    """Chooses the next *current* block given per-block walk statistics.

    ``walk_counts[b]`` — number of stored walks whose pool is block b;
    ``min_hops[b]`` — smallest hop among them (inf when empty).
    """

    name = "base"

    def __init__(self, num_blocks: int, seed: int = 0):
        self.num_blocks = num_blocks
        self.rng = np.random.default_rng(seed)
        self.cursor = -1

    def next_block(self, walk_counts: np.ndarray, min_hops: np.ndarray) -> Optional[int]:
        raise NotImplementedError


class AlphabetScheduler(CurrentBlockScheduler):
    """b0..b_{N_B-1} cyclically, visiting empty blocks too (approx ratio N_B)."""

    name = "alphabet"

    def next_block(self, walk_counts, min_hops):
        if walk_counts.sum() == 0:
            return None
        self.cursor = (self.cursor + 1) % self.num_blocks
        return self.cursor


class IterationScheduler(CurrentBlockScheduler):
    """The paper's choice: Alphabet but skipping empty blocks."""

    name = "iteration"

    def next_block(self, walk_counts, min_hops):
        if walk_counts.sum() == 0:
            return None
        for _ in range(self.num_blocks):
            self.cursor = (self.cursor + 1) % self.num_blocks
            if walk_counts[self.cursor] > 0:
                return self.cursor
        return None


class MinHeightScheduler(CurrentBlockScheduler):
    """Block containing the walk with the fewest steps taken."""

    name = "min_height"

    def next_block(self, walk_counts, min_hops):
        if walk_counts.sum() == 0:
            return None
        masked = np.where(walk_counts > 0, min_hops, np.inf)
        return int(np.argmin(masked))


class MaxSumScheduler(CurrentBlockScheduler):
    """Block containing the most walks (GraphWalker's state-aware pick)."""

    name = "max_sum"

    def next_block(self, walk_counts, min_hops):
        if walk_counts.sum() == 0:
            return None
        return int(np.argmax(walk_counts))


class GraphWalkerScheduler(CurrentBlockScheduler):
    """Max-Sum with prob p (=0.8, GraphWalker's setting), else Min-Height."""

    name = "graphwalker"

    def __init__(self, num_blocks: int, seed: int = 0, p: float = 0.8):
        super().__init__(num_blocks, seed)
        self.p = p
        self._max = MaxSumScheduler(num_blocks, seed)
        self._min = MinHeightScheduler(num_blocks, seed)

    def next_block(self, walk_counts, min_hops):
        if walk_counts.sum() == 0:
            return None
        pick = self._max if self.rng.random() < self.p else self._min
        return pick.next_block(walk_counts, min_hops)


_SCHEDULERS = {
    s.name: s
    for s in (
        AlphabetScheduler,
        IterationScheduler,
        MinHeightScheduler,
        MaxSumScheduler,
        GraphWalkerScheduler,
    )
}


def make_scheduler(name: str, num_blocks: int, seed: int = 0) -> CurrentBlockScheduler:
    try:
        return _SCHEDULERS[name](num_blocks, seed)
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}; have {sorted(_SCHEDULERS)}")
