"""The traced window: ``torch.profiler`` on the card and a sampler of the host.

:class:`TracedWindow` wraps the measured window of a ``--trace 1`` run.  It
records CPU and CUDA activity with ``torch.profiler`` and, on a thread of
its own, samples every ``interval`` seconds the innermost ``repro_torch``
function on the main thread's stack.  :func:`reduce_trace` then reads the
exported Chrome trace:

* ``busy_s``: the union of the device intervals (kernels, copies, memsets)
  inside the window; the idle share is ``1 - busy_s / window_s``;
* ``device_ops``: device seconds by operation name, largest first;
* ``idle_gaps``: the host function that the sampler saw at each instant the
  device was idle, as seconds by function, largest first;
* ``kernels``: per kernel name, device seconds, launches and threads
  launched (grid x block), which the kernel roofline readers need.

The host clock and the trace's clock are aligned by a ``record_function``
mark whose host time is known.
"""

from __future__ import annotations

import bisect
import json
import math
import sys
import threading
import time
from pathlib import Path

__all__ = ["TracedWindow", "merge_intervals", "reduce_trace"]

#: Chrome-trace categories that are work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "walkbench.window"


def merge_intervals(intervals):
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_label(frame) -> str:
    """Innermost frame of the program on a stack, as ``package/module.py:function``."""
    while frame is not None:
        path = frame.f_code.co_filename.replace("\\", "/")
        cut = path.rfind("/repro_torch/")
        if cut >= 0:
            return f"{path[cut + 1:]}:{frame.f_code.co_name}"
        frame = frame.f_back
    return "harness"


class _Sampler(threading.Thread):
    def __init__(self, target_thread: int, interval: float):
        super().__init__(name="walkbench-sampler", daemon=True)
        self.target = target_thread
        self.interval = interval
        self.samples: list[tuple[float, str]] = []
        self._halt = threading.Event()

    def run(self) -> None:
        while not self._halt.wait(self.interval):
            frame = sys._current_frames().get(self.target)
            self.samples.append((time.perf_counter(), _host_label(frame)))

    def stop(self) -> None:
        self._halt.set()
        self.join()


class TracedWindow:
    """Profile the window; ``mark()`` once at its start, ``stop()`` at its end."""

    def __init__(self, trace_path: Path, interval: float = 0.005):
        from torch.profiler import ProfilerActivity, profile

        self.trace_path = Path(trace_path)
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._sampler = _Sampler(threading.get_ident(), interval)
        self.mark_host_s = None
        self.t_start = self.t_end = None

    def start(self) -> None:
        self._prof.__enter__()

    def mark(self) -> float:
        """Start the window: returns its host start time."""
        from torch.profiler import record_function

        with record_function(MARK):
            self.mark_host_s = time.perf_counter()
        self._sampler.start()
        self.t_start = self.mark_host_s
        return self.t_start

    def stop(self, t_end: float) -> None:
        self.t_end = t_end
        self._sampler.stop()
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(str(self.trace_path))

    def reduce(self) -> dict:
        with open(self.trace_path) as f:
            events = json.load(f)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return reduce_trace(
            events,
            mark_host_s=self.mark_host_s,
            t_start=self.t_start,
            t_end=self.t_end,
            samples=self._sampler.samples,
            interval=self._sampler.interval,
        )


def reduce_trace(events, *, mark_host_s, t_start, t_end, samples, interval, top=10) -> dict:
    """Busy time, device operations, idle time by host function, kernels."""
    mark = [
        e
        for e in events
        if e.get("name") == MARK and e.get("ph") == "X" and e.get("cat") == "user_annotation"
    ]
    if not mark:
        raise RuntimeError(f"the trace holds no {MARK!r} mark")
    # trace microseconds -> host seconds
    offset = mark_host_s - float(mark[0]["ts"]) / 1e6
    busy, ops, kernels = [], {}, {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"]) / 1e6 + offset
        b = a + float(e.get("dur", 0.0)) / 1e6
        a, b = max(a, t_start), min(b, t_end)
        if b <= a:
            continue
        busy.append((a, b))
        name = str(e.get("name", "?"))
        ops[name] = ops.get(name, 0.0) + (b - a)
        if e["cat"] == "kernel":
            k = kernels.setdefault(name, {"seconds": 0.0, "launches": 0, "threads": 0})
            k["seconds"] += b - a
            k["launches"] += 1
            args = e.get("args", {})
            grid, block = args.get("grid"), args.get("block")
            if k["threads"] is not None and grid and block:
                k["threads"] += math.prod(int(g) for g in [*grid, *block])
            else:
                k["threads"] = None
    merged = merge_intervals(busy)
    busy_s = sum(b - a for a, b in merged)
    starts = [a for a, _ in merged]
    idle = {}
    for t, label in samples:
        if not t_start <= t <= t_end:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and merged[i][0] <= t < merged[i][1]:
            continue
        idle[label] = idle.get(label, 0.0) + interval

    def by_time(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {
        "busy_s": busy_s,
        "window_s": t_end - t_start,
        "device_ops": by_time(ops),
        "idle_gaps": by_time(idle),
        "kernels": kernels,
    }
