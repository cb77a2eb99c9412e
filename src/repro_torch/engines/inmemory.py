"""In-memory oracle / corpus generator (whole-graph fast path).

The port of ``repro/engines/inmemory.py``.  Runs the out-of-core engines'
own advance (:meth:`EngineBase._advance`) once, with the whole graph as one
block whose full view fills both slots of the resident pair.  Because every
random draw is keyed per ``(walk id, hop)`` off the task seed, the oracle's
walks are *bit-identical* to the walks any out-of-core engine samples for
the same task — the strongest possible correctness pin for the engines.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from repro_torch.core.graph import BlockedGraph, BlockView
from repro_torch.core.stats import IOStats
from repro_torch.core.transition import WalkTask
from repro_torch.core.walk import WalkBatch

from .base import EngineBase, WalkResult, resolve_device

__all__ = ["InMemoryWalker"]


class InMemoryWalker:
    """Whole-graph walker: one advance call over every walk.  Ground truth
    for engine tests and the corpus generator feeding the LM data
    pipeline."""

    def __init__(
        self,
        bg: BlockedGraph,
        task: WalkTask,
        *,
        k_max: int = 16,
        device: Union[str, torch.device] = "cuda",
    ):
        if not hasattr(bg, "graph"):
            # e.g. repro_torch.io.DiskBlockedGraph: rebuild the host CSR explicitly
            raise TypeError(
                "InMemoryWalker needs the in-RAM BlockedGraph; for a disk "
                "backend, wrap bg.read_csr() in a BlockedGraph first"
            )
        self.bg = bg
        self.task = task
        self.k_max = k_max
        self.device = resolve_device(device)

    def run(self, *, record_walks: bool = True) -> WalkResult:
        g = self.bg.graph
        whole = BlockedGraph(g, [0, g.num_vertices])
        return _WholeGraph(
            whole, self.task, k_max=self.k_max, record_walks=record_walks,
            device=self.device, stats=IOStats(),
        ).run()  # fmt: skip


class _WholeGraph(EngineBase):
    """The whole graph as one block: its full view in both slots, one
    advance over every walk, which ends them all."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # the graph is resident from the start, outside the I/O accounting
        self.pair.stats = None

    def _run(self) -> WalkResult:
        view = BlockView.from_resident(self.bg.materialize_block(0))
        self.pair.set_slot(0, view)
        self.pair.set_slot(1, view)
        src = self._pending_init_src
        wid = np.arange(src.shape[0], dtype=np.int64)
        batch = WalkBatch(src, src, src, np.zeros(src.shape[0], np.int32))
        batch, alive = self._advance(batch, wid)
        if alive.any():
            raise RuntimeError("a walk outlived the whole-graph advance")
        self._retire(batch, wid, alive)
        return self.result()
