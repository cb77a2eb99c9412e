"""Admission batching: the throughput half of the latency/throughput dial.

One block load amortized over thousands of walks is the paper's central
economy (§4.2, §6.1).  A point query alone cannot buy it — ``samples`` of
32 walks would pay a whole triangular sweep.  The :class:`AdmissionQueue`
restores the economy by *batching admissions*: pending queries group by
:class:`~repro_torch.serve.query.QueryConfig` (one engine run serves one
config), and :meth:`pop_batch` admits up to ``max_batch`` of the oldest
group at once, FIFO within the group.  Every query in the admitted batch
rides the same sweep, so each block load is shared ``batch x samples``
ways — and every query in the batch answers at the same time, which is
exactly the tradeoff: larger admission batches amortize better (higher
throughput per I/O) but hold early arrivals longer (higher p50 latency).
``max_batch`` is the dial; ``chip_smoke.py``'s serving phase reports the
percentile consequences on the card.

Order is deterministic: groups are served oldest-head-first (smallest
pending query id), queries within a group in submission order — so the
walk-id layout of every admitted batch, and therefore (with the
counter-based RNG) every trajectory, is a pure function of the submission
sequence.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Deque, List, Optional, Tuple

from .query import QueryConfig, WalkQuery

__all__ = ["AdmissionQueue"]


class AdmissionQueue:
    """Pending point queries, grouped by config, admitted in FIFO batches."""

    def __init__(self, max_batch: int = 1024):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self._groups: "OrderedDict[QueryConfig, Deque[WalkQuery]]" = OrderedDict()

    def __len__(self) -> int:
        return sum(len(g) for g in self._groups.values())

    def submit(self, query: WalkQuery) -> None:
        self._groups.setdefault(query.config, deque()).append(query)

    def pop_batch(self) -> Optional[Tuple[QueryConfig, List[WalkQuery]]]:
        """Admit up to ``max_batch`` queries of one config — the group whose
        head query has waited longest (smallest qid) — or ``None`` when
        nothing is pending."""
        best = None
        for cfg, grp in self._groups.items():
            if grp and (best is None or grp[0].qid < self._groups[best][0].qid):
                best = cfg
        if best is None:
            return None
        grp = self._groups[best]
        batch = [grp.popleft() for _ in range(min(self.max_batch, len(grp)))]
        if not grp:
            del self._groups[best]
        return best, batch
