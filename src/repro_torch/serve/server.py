"""The walk-query server (PyTorch port): point queries riding the
triangular sweep.

The port of ``repro/serve/server.py``.  Every admitted batch runs as the
port's :class:`~repro_torch.engines.biblock.BiBlockEngine` on the server's
``device`` (``cuda`` unless asked for ``cpu``): the hand-written CUDA pair
advance on a card, its plain version on the CPU; answers, batch seeds and
charges equal the JAX server's.  Life of
a query:

1. **submit** — ``submit(source, config)`` stamps the arrival clock,
   records the source's block in the :class:`~repro.serve.policy
   .HotSetPolicy` histogram, and parks the query in the
   :class:`~repro.serve.admission.AdmissionQueue`.
2. **admit** — ``flush()`` pops admission batches (one config per batch,
   up to ``max_batch`` queries).  Each batch becomes *one* engine run: the
   queries' sources repeat ``samples`` times into a single walk array
   (query ``k`` owns the contiguous walk-id range ``[k·samples,
   (k+1)·samples)``), injected through the ``initial_walks`` seam of
   :class:`~repro_torch.engines.base.EngineBase`.
3. **sweep** — the run is a stock bi-block triangular sweep (§4.2) over
   the *shared* :class:`~repro_torch.io.BlockStore` and ``IOStats`` the server
   owns, with the policy's current hot set pinned: hot blocks load once
   and serve chargeless from memory, the cold tail keeps the paper's disk
   economics.  Walks persist with the skewed ``min(B(u), B(v))`` rule via
   the same ``core.buckets.push_by_block_assignment`` every tier uses, so
   thousands of concurrent queries amortize each block load — §4.2's
   bucket economics as a latency story.
4. **answer** — the engine's ``on_retire`` hook hands every terminating
   walk's ``(walk id, endpoint)`` back; walk ids fold to query ids and the
   per-query endpoint multisets materialize as
   :class:`~repro.serve.query.QueryAnswer`\\ s (PPR estimate / neighbor
   multiset).  ``t_answer`` stamps the clock; submit→answer is the
   per-query latency, summarized by :meth:`latency_summary` percentiles.

Determinism: batch ``k`` (0-based, across the server's lifetime) runs with
task seed ``seed + k``, and walk trajectories are pure functions of
``(seed, walk id)`` (counter-based RNG) — so a served batch is *bit
identical* to the equivalent direct batch run (same engine class, same
task seed, ``initial_walks`` = the same concatenated sources).  Pinning
never changes what executes, only what is charged.  ``chip_smoke.py``'s
serving phase asserts both on the card: served CRC == direct CRC, and
hot-set ``block_load`` charges strictly below pure LRU on a skewed mix.
Batches are served one after another, as the JAX server serves them, so
latencies mean the same thing.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.graph import block_of
from repro_torch.core.stats import SSD, DevicePreset, IOStats
from repro_torch.engines.base import resolve_device
from repro_torch.engines.biblock import BiBlockEngine
from repro_torch.io import BlockStore

from .admission import AdmissionQueue
from .policy import HotSetPolicy
from .query import QueryAnswer, QueryConfig, WalkQuery

__all__ = ["WalkQueryServer"]

DEFAULT_CONFIG = QueryConfig()


class WalkQueryServer:
    """Admission-batched point-query serving over one blocked graph.

    ``engine_kw`` flows to every batch's engine run (``pool``,
    ``loading``, ``async_pipeline``, ...), and so does ``device`` (resolved
    once here: a server asked for ``cuda`` on a host without one raises at
    construction); the block store and stats are server-owned and shared
    across runs, so hot-set pinning savings compound over the server's
    lifetime.  ``hot_blocks=0`` disables pinning
    (the pure-LRU reference).  ``advance_calls`` sums the engine runs'
    advances: on the card, one kernel launch each.
    """

    def __init__(
        self,
        bg,
        *,
        max_batch: int = 1024,
        hot_blocks: int = 2,
        hot_min_arrivals: int = 1,
        block_cache_blocks: int = 4,
        prefetch: bool = True,
        preset: DevicePreset = SSD,
        seed: int = 0,
        engine_cls=BiBlockEngine,
        device="cuda",
        **engine_kw,
    ):
        self.bg = bg
        self.seed = seed
        self.engine_cls = engine_cls
        self.device = resolve_device(device)
        self.engine_kw = dict(engine_kw, device=self.device)
        self.stats = IOStats(preset)
        self.blocks = BlockStore(
            bg,
            self.stats,
            enable_prefetch=prefetch,
            capacity=max(block_cache_blocks, 2),
        )
        self.admission = AdmissionQueue(max_batch)
        self.policy = HotSetPolicy(
            bg.num_blocks, max_pinned=hot_blocks, min_arrivals=hot_min_arrivals
        )
        self._queries: Dict[int, WalkQuery] = {}
        self._answers: Dict[int, QueryAnswer] = {}
        self._next_qid = 0
        self.batches_served = 0
        self.advance_calls = 0
        self._closed = False

    # -- the submit side -------------------------------------------------------
    def submit(self, source: int, config: QueryConfig = DEFAULT_CONFIG) -> int:
        """Enqueue one point query; returns its query id."""
        source = int(source)
        if not (0 <= source < self.bg.num_vertices):
            raise ValueError(f"query source {source} outside [0, {self.bg.num_vertices})")
        qid = self._next_qid
        self._next_qid += 1
        query = WalkQuery(qid, source, config, t_submit=time.perf_counter())
        self._queries[qid] = query
        self.policy.observe(int(block_of(self.bg.block_starts, np.array([source]))[0]))
        self.admission.submit(query)
        return qid

    def pending(self) -> int:
        return len(self.admission)

    # -- the serve side --------------------------------------------------------
    def batch_seed(self, k: int) -> int:
        """Task seed of the server's ``k``-th admitted batch — the seed a
        direct batch run must use to reproduce its walks bit-for-bit."""
        return self.seed + k

    def flush(self) -> List[QueryAnswer]:
        """Serve every pending query; returns their answers in qid order."""
        served: List[QueryAnswer] = []
        while True:
            popped = self.admission.pop_batch()
            if popped is None:
                return served
            served.extend(self._serve_batch(*popped))

    def _serve_batch(self, config: QueryConfig, queries: List[WalkQuery]) -> List[QueryAnswer]:
        # pin the policy's current hot set before the sweep touches blocks
        self.blocks.set_pinned(self.policy.hot_set())
        samples = config.samples
        sources = np.repeat(np.array([q.source for q in queries], np.int64), samples)
        # every terminating walk reports (wid, endpoint) exactly once
        wid_parts: List[np.ndarray] = []
        end_parts: List[np.ndarray] = []

        def collect(wid: np.ndarray, ends: np.ndarray) -> None:
            wid_parts.append(np.asarray(wid, np.int64).copy())
            end_parts.append(np.asarray(ends, np.int64).copy())

        task = config.task(self.batch_seed(self.batches_served))
        engine = self.engine_cls(
            self.bg,
            task,
            stats=self.stats,
            block_store=self.blocks,
            initial_walks=sources,
            on_retire=collect,
            **self.engine_kw,
        )
        self.advance_calls += engine.run().advance_calls
        self.batches_served += 1
        wid = np.concatenate(wid_parts) if wid_parts else np.zeros(0, np.int64)
        ends = np.concatenate(end_parts) if end_parts else np.zeros(0, np.int64)
        qidx = wid // samples  # contiguous per-query walk-id ranges
        t_answer = time.perf_counter()
        answers = []
        for k, query in enumerate(queries):
            verts, counts = np.unique(ends[qidx == k], return_counts=True)
            query.t_answer = t_answer
            ans = QueryAnswer(
                qid=query.qid,
                source=query.source,
                num_walks=samples,
                vertices=verts.astype(np.int64),
                counts=counts.astype(np.int64),
                latency=query.latency,
            )
            self._answers[query.qid] = ans
            answers.append(ans)
        return answers

    # -- read-outs -------------------------------------------------------------
    def answer(self, qid: int) -> Optional[QueryAnswer]:
        return self._answers.get(qid)

    def latencies(self) -> np.ndarray:
        """Submit→answer seconds of every answered query, in qid order."""
        return np.array(
            [q.latency for q in self._queries.values() if q.t_answer is not None]
        )

    def latency_summary(self) -> Dict[str, float]:
        """p50/p95/p99 per-query latency (seconds) plus the answered count."""
        lat = self.latencies()
        if lat.size == 0:
            return {"answered": 0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {
            "answered": int(lat.size),
            "p50": float(np.percentile(lat, 50)),
            "p95": float(np.percentile(lat, 95)),
            "p99": float(np.percentile(lat, 99)),
        }

    # -- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.blocks.close()

    def __enter__(self) -> "WalkQueryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
