"""In-memory oracle / corpus generator (whole-graph fast path).

The port of ``repro/engines/inmemory.py``.  Runs the same view-pair
advance as the out-of-core engines with the whole graph packed into a
single full view — on the card through the hand-written CUDA kernel
(``advance_impl="cuda"``) or its plain PyTorch version (``"torch"``).
Because every random draw is keyed per ``(walk id, hop)`` off the task
seed, the oracle's walks are *bit-identical* to the walks any out-of-core
engine samples for the same task — the strongest possible correctness pin
for the engines.
"""

from __future__ import annotations

import time
from typing import Union

import numpy as np
import torch

from repro_torch.core.graph import BlockedGraph
from repro_torch.core.stats import IOStats
from repro_torch.core.transition import Node2vec, WalkTask
from repro_torch.kernels import pair_advance as _pair_advance
from repro_torch.kernels import rng

from .base import WalkResult, resolve_device
from .step import pair_advance_ref, pow2_pad, remap_search_iters

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
        advance_impl: str = "cuda",
        device: Union[str, torch.device] = "cuda",
    ):
        if not hasattr(bg, "graph"):
            # e.g. repro_torch.io.DiskBlockedGraph: rebuild the host CSR explicitly
            raise TypeError(
                "InMemoryWalker needs the in-RAM BlockedGraph; for a disk "
                "backend, wrap bg.read_csr() in a BlockedGraph first"
            )
        if advance_impl not in ("cuda", "torch"):
            raise ValueError(f"advance_impl must be 'cuda' or 'torch', got {advance_impl!r}")
        self.bg = bg
        self.task = task
        is_plain = isinstance(task.model, Node2vec) and task.model.p == task.model.q == 1.0
        self.k_max = 1 if is_plain else k_max
        if task.model.order == 1:
            self.k_max = 1
        self.advance_impl = advance_impl
        self.device = resolve_device(device)

    def run(self, *, record_walks: bool = True) -> WalkResult:
        bg, task = self.bg, self.task
        g = bg.graph
        stats = IOStats()
        src = task.initial_walks(g.num_vertices)
        n = src.shape[0]
        V = g.num_vertices
        # the whole graph as one full view; slot 1 aliases slot 0
        vids = np.arange(V, dtype=np.int32)
        nverts = np.array([V, V], np.int32)
        base0 = np.zeros(2, np.int32)
        indptr = g.indptr.astype(np.int32)
        indices = g.indices.astype(np.int32)
        has_alias = g.weights is not None
        if has_alias:
            from repro_torch.core.sampling import build_alias_rows

            alias_j, alias_q = build_alias_rows(indptr, V, max(g.num_edges, 1), g.weights)
        else:
            alias_j = np.zeros(1, np.int32)
            alias_q = np.ones(1, np.float32)

        N = pow2_pad(n)
        lanes = np.zeros((4, N), np.int32)  # wid, prev, cur, hop
        lanes[0, :n] = np.arange(n)
        lanes[1, :n] = src
        lanes[2, :n] = src
        alive = np.zeros(N, bool)
        alive[:n] = True
        dev = self.device
        pair = tuple(
            torch.as_tensor(a, device=dev)
            for a in (vids, nverts, base0, indptr, base0, indices, base0, alias_j, alias_q)
        )
        wid, prev, cur, hop = torch.as_tensor(lanes, device=dev).unbind(0)
        alive_dev = torch.as_tensor(alive, device=dev)
        if self.advance_impl == "cuda":
            advance = _pair_advance.fused_advance_pair
        else:
            advance = pair_advance_ref
        t0 = time.perf_counter()
        out = advance(
            *pair,
            wid,
            prev,
            cur,
            hop,
            alive_dev,
            rng.key_halves(task.seed),
            int(task.length),
            float(task.decay),
            float(getattr(task.model, "p", 1.0)),
            float(getattr(task.model, "q", 1.0)),
            order=task.model.order,
            k_max=self.k_max,
            n_iters=int(np.ceil(np.log2(max(g.num_edges, 2)))) + 2,
            v_iters=remap_search_iters(V),
            record=record_walks,
            has_alias=has_alias,
            max_len=int(task.length),
        )
        # the device-to-host copies synchronise, so exec_time covers the run
        prev_f, cur_f, hop_f, alive_f, steps, trace = (t.cpu().numpy() for t in out)
        stats.exec_time = time.perf_counter() - t0
        stats.steps_sampled = int(steps)
        counts = np.bincount(cur_f[:n], minlength=g.num_vertices).astype(np.int64)
        corpus = None
        if record_walks:
            corpus = np.full((n, task.length + 1), -1, np.int32)
            corpus[:, 0] = src
            t = trace[:n]
            for h in range(1, task.length + 1):
                m = t[:, h] >= 0
                corpus[m, h] = t[m, h]
        return WalkResult(n, int(steps), counts, corpus, stats, advance_calls=1)
