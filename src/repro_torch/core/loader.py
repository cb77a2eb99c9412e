"""Learning-based block loading model (paper §5).

Two loading methods exist for an ancillary block:

* **full load** — stream the whole block slice (index + CSR cells);
* **on-demand load** — gather only *activated* vertices (those that are the
  ``prev``/``cur`` of some walk in the bucket), at random-I/O cost, plus a
  trickle of extension gathers during execution when a walk reaches a vertex
  that was not pre-activated.

Selection is learned online (§5.2): per block, fit

    t_f = α_f · η + b_f          (full;   intercept = pure load cost)
    t_o = α_o · η                (on-demand; no intercept — empty W is free)

over ``η = |W| / N_v`` and switch at ``η₀ = b_f / (α_o − α_f)``.  Costs fed
to the regression are the *simulated* device costs from
:mod:`repro.core.stats` so training is deterministic; the same class accepts
wall-clock samples when run on real hardware.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Literal, Optional

__all__ = ["LinearCostModel", "BlockLoadingModel", "LoadDecision"]

LoadDecision = Literal["full", "ondemand"]


@dataclasses.dataclass
class LinearCostModel:
    """Least-squares y = a·x (+ b) with online sample accumulation."""

    with_intercept: bool
    sx: float = 0.0
    sy: float = 0.0
    sxx: float = 0.0
    sxy: float = 0.0
    n: int = 0

    def add(self, x: float, y: float) -> None:
        self.sx += x
        self.sy += y
        self.sxx += x * x
        self.sxy += x * y
        self.n += 1

    def fit(self) -> tuple[float, float]:
        """Returns (a, b); b = 0 for the no-intercept model."""
        if self.n == 0:
            return 0.0, 0.0
        if not self.with_intercept:
            return (self.sxy / self.sxx if self.sxx > 0 else 0.0), 0.0
        det = self.n * self.sxx - self.sx * self.sx
        if abs(det) < 1e-18:
            return 0.0, self.sy / self.n
        a = (self.n * self.sxy - self.sx * self.sy) / det
        b = (self.sy * self.sxx - self.sx * self.sxy) / det
        return a, b


class BlockLoadingModel:
    """Per-block η-threshold selector with a global fallback model.

    Modes:
      * ``train_full`` / ``train_ondemand`` — force one method and collect
        (η, t) samples (the paper's two profiling runs);
      * ``auto`` — use learned η₀ per block (global η₀ until a block has
        enough of its own samples).
    """

    def __init__(
        self,
        num_blocks: int,
        mode: Literal["auto", "train_full", "train_ondemand", "full", "ondemand"] = "auto",
        min_samples: int = 4,
        default_eta0: float = 0.15,
    ):
        self.num_blocks = num_blocks
        self.mode = mode
        self.min_samples = min_samples
        self.default_eta0 = default_eta0
        self._full: Dict[int, LinearCostModel] = {}
        self._ond: Dict[int, LinearCostModel] = {}
        self._gfull = LinearCostModel(with_intercept=True)
        self._gond = LinearCostModel(with_intercept=False)

    # -- cost model ----------------------------------------------------------
    @staticmethod
    def ondemand_cost(
        preset,
        n_vertices: int,
        nbytes: int,
        *,
        seeks: int | None = None,
        waste_bytes: int = 0,
    ) -> float:
        """Modelled on-demand cost with the per-seek term.

        The reference path pays one random I/O per activated vertex
        (``seeks=None`` — exactly ``preset.rand_cost``).  With the gap-aware
        read planner on, cost is a function of the *coalesced ranges* the
        plan actually issued, not the raw vertex count: one seek per range
        plus streaming over useful + read-through waste bytes.  Feeding this
        to :meth:`observe` makes the learned full-vs-on-demand threshold
        η₀ reflect coalesced reality.
        """
        if seeks is None:
            return preset.rand_cost(n_vertices, nbytes)
        return seeks * preset.rand_latency + (nbytes + waste_bytes) / preset.rand_bandwidth

    # -- sample collection ---------------------------------------------------
    def observe(self, block_id: int, eta: float, cost: float, method: LoadDecision) -> None:
        if method == "full":
            self._full.setdefault(block_id, LinearCostModel(True)).add(eta, cost)
            self._gfull.add(eta, cost)
        else:
            self._ond.setdefault(block_id, LinearCostModel(False)).add(eta, cost)
            self._gond.add(eta, cost)

    # -- threshold -------------------------------------------------------------
    @staticmethod
    def _eta0(full: LinearCostModel, ond: LinearCostModel) -> Optional[float]:
        a_f, b_f = full.fit()
        a_o, _ = ond.fit()
        if a_o - a_f <= 1e-12 or b_f <= 0:
            return None
        return b_f / (a_o - a_f)

    def eta0(self, block_id: int) -> float:
        f = self._full.get(block_id)
        o = self._ond.get(block_id)
        if f is not None and o is not None and f.n >= self.min_samples and o.n >= self.min_samples:
            t = self._eta0(f, o)
            if t is not None:
                return t
        if self._gfull.n >= self.min_samples and self._gond.n >= self.min_samples:
            t = self._eta0(self._gfull, self._gond)
            if t is not None:
                return t
        return self.default_eta0

    # -- decision ---------------------------------------------------------------
    def choose(self, block_id: int, num_walks: int, block_nverts: int) -> LoadDecision:
        if self.mode in ("train_full", "full"):
            return "full"
        if self.mode in ("train_ondemand", "ondemand"):
            return "ondemand"
        eta = num_walks / max(block_nverts, 1)
        return "full" if eta > self.eta0(block_id) else "ondemand"

    def summary(self) -> dict:
        a_f, b_f = self._gfull.fit()
        a_o, _ = self._gond.fit()
        return {
            "global_alpha_f": a_f,
            "global_b_f": b_f,
            "global_alpha_o": a_o,
            "global_eta0": self._eta0(self._gfull, self._gond),
            "full_samples": self._gfull.n,
            "ondemand_samples": self._gond.n,
        }
