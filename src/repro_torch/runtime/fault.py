"""Fault tolerance / elasticity / straggler mitigation for the train loop.

The port of ``repro/runtime/fault.py`` over torch trees: the same classes
and loop, with checkpoints from :mod:`repro_torch.checkpoint` (the JAX
package's on-disk format) and the metrics read with ``item()``.  Where the
JAX text below speaks of a mesh and ``NamedSharding``, the port takes a
tree of ``torch.device``.

What a 1000+-node deployment needs, scaled to the abstractions this
repo can exercise without real hardware (all of it is tested against the
in-process trainer in examples/train_lm_on_walks.py and tests/):

* **Checkpoint/restart** — `ResilientTrainer.run` owns the step loop; every
  ``ckpt_every`` steps it snapshots (params, opt_state, data cursor, rng)
  via the async CheckpointManager.  `resume()` restores the newest
  *committed* checkpoint — including onto a different mesh shape (elastic
  re-mesh: restore re-device_puts against the new NamedShardings).
* **Straggler detection** — per-step wall times feed an EMA watchdog; a
  step slower than ``straggler_factor`` x EMA is logged and counted.  On
  real fleets the same signal triggers hot-spare swap; here it feeds
  metrics and the test asserts the detector fires on an injected delay.
* **Failure injection** — `FailureInjector` raises at a scheduled step so
  tests can prove end-to-end crash -> restart -> bitwise-identical resume.
* **Heartbeat** — a background thread stamps a file every interval; an
  external supervisor (launch script) can detect a hung step loop.
"""

from __future__ import annotations

import dataclasses
import time
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional

from repro_torch.checkpoint import CheckpointManager, latest_step, restore_checkpoint

__all__ = ["FailureInjector", "Heartbeat", "StragglerWatchdog", "ResilientTrainer"]


class FailureInjector:
    """Deterministically crash at the given steps (tests / chaos drills)."""

    def __init__(self, fail_at_steps=()):
        self.fail_at = set(fail_at_steps)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")


class Heartbeat:
    def __init__(self, path: str | Path, interval_s: float = 5.0):
        self.path = Path(path)
        self.interval = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        def beat():
            while not self._stop.wait(self.interval):
                self.path.write_text(str(time.time()))

        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(str(time.time()))
        self._thread = threading.Thread(target=beat, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1)

    def age(self) -> float:
        try:
            return time.time() - float(self.path.read_text())
        except FileNotFoundError:
            return float("inf")


class StragglerWatchdog:
    """EMA step-time watchdog: flags steps slower than factor x EMA."""

    def __init__(self, factor: float = 3.0, alpha: float = 0.2, warmup: int = 3):
        self.factor = factor
        self.alpha = alpha
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.n = 0
        self.stragglers: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = self.n > self.warmup and dt > self.factor * self.ema
        if is_straggler:
            self.stragglers.append((step, dt, self.ema))
        else:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return is_straggler


@dataclasses.dataclass
class ResilientTrainer:
    """Owns the step loop: data cursor, checkpoints, watchdog, restart."""

    train_step: Callable  # (params, opt_state, batch) -> (params, opt_state, metrics)
    ckpt_dir: str | Path
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    injector: Optional[FailureInjector] = None
    heartbeat_path: Optional[str | Path] = None

    def run(
        self,
        params,
        opt_state,
        batches: Iterator[dict],
        *,
        num_steps: int,
        start_step: int = 0,
        on_metrics: Optional[Callable[[int, Dict[str, Any]], None]] = None,
    ):
        mgr = CheckpointManager(self.ckpt_dir, keep=self.keep)
        watchdog = StragglerWatchdog(self.straggler_factor)
        hb = Heartbeat(self.heartbeat_path) if self.heartbeat_path else None
        if hb:
            hb.start()
        step = start_step
        last_cursor = None
        try:
            for batch in batches:
                if step >= num_steps:
                    break
                cursor = batch.pop("cursor", None)
                batch.pop("epoch", None)
                if self.injector:
                    self.injector.maybe_fail(step)
                t0 = time.perf_counter()
                params, opt_state, metrics = self.train_step(
                    params, opt_state, batch
                )
                # block so the watchdog sees real step time (``item`` waits
                # for the card)
                metrics = {k: float(v.item()) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                straggler = watchdog.observe(step, dt)
                metrics.update(step_time=dt, straggler=straggler)
                if on_metrics:
                    on_metrics(step, metrics)
                step += 1
                last_cursor = cursor
                if step % self.ckpt_every == 0:
                    mgr.save_async(
                        step,
                        {"params": params, "opt_state": opt_state},
                        extra={"cursor": cursor, "step": step},
                    )
            mgr.save_async(
                step,
                {"params": params, "opt_state": opt_state},
                extra={"cursor": last_cursor, "step": step},
            )
            mgr.wait()
        finally:
            if hb:
                hb.stop()
        return params, opt_state, {"stragglers": watchdog.stragglers, "step": step}

    def resume(self, params_like, opt_like, *, shardings=None):
        """Restore the latest committed state (onto ``shardings``, a tree
        of ``torch.device`` matching ``{"params", "opt_state"}``, where
        given).  Returns (params, opt_state, start_step, cursor) or None if
        fresh."""
        step = latest_step(self.ckpt_dir)
        if step is None:
            return None
        tree, extra = restore_checkpoint(
            self.ckpt_dir,
            {"params": params_like, "opt_state": opt_like},
            shardings=shardings,
        )
        return tree["params"], tree["opt_state"], extra["step"], extra.get("cursor")
