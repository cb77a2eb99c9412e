"""Where the time of one launcher run goes, host and device.

    PYTHONPATH=src python -m repro_torch.launch.profile_walk [--top 25] \\
        [--json report.json] -- <repro_torch.launch.walk flags>

Runs the launcher's path (:func:`repro_torch.launch.walk.main`) twice:

1. with the engines' spans on (:mod:`repro_torch.core.spans`) and, on a
   card, under ``torch.profiler``: each span's self time by name, the
   loader's decisions, and on a card the device time by kernel and copy,
   the device's busy time (the union of its intervals) and idle share of
   the engines' time, and each idle second put down to the innermost span
   open on this thread; for a first-order task, the bi-block slots' walk
   visits and hops per visit (the ``slot`` spans' steps over the
   ``slot.visits`` counter);
2. under :mod:`cProfile`: the host functions with the most cumulative and
   own time.

The engines' time runs from the first engine's ``IOStats`` creation to the
end of the run, so graph generation is outside it; ``exec_s`` and
``steps`` sum over the engines the walk flags select (``--engine``, by
default the launcher's biblock and sogw).  Needs a CUDA device unless the
walk flags say ``--device cpu`` (then the device half is empty).
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import tempfile
import time
from pathlib import Path

from repro_torch.core import spans

#: Chrome-trace categories that are work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "profile_walk.mark"


def _timed_main(walk_argv):
    import torch

    from repro_torch.launch import walk

    t0 = time.perf_counter()
    results = [res for _, res in walk.main(walk_argv)]
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    return results, t0, results[0].stats.wall_start, t_end


def _exec_s(results) -> float:
    return sum(res.stats.exec_time for res in results)


def merge_intervals(intervals):
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _device_intervals(trace_path: Path, mark_ns: int, lo: int, hi: int):
    """Device intervals of an exported trace on ``perf_counter_ns``, cut to
    ``[lo, hi)``, with their names."""
    with open(trace_path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    marks = [e for e in events if e.get("name") == MARK and e.get("ph") == "X"]
    if not marks:
        raise RuntimeError(f"the trace holds no {MARK!r} mark")
    offset = mark_ns - float(marks[0]["ts"]) * 1e3  # trace us -> host ns
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a = float(e["ts"]) * 1e3 + offset
        a, b = max(a, lo), min(a + float(e.get("dur", 0.0)) * 1e3, hi)
        if b > a:
            out.append((a, b, str(e.get("name", "?"))))
    return out


def _device_report(trace_path: Path, mark_ns: int, lo: int, hi: int, recorded) -> dict:
    """Busy time as the union of the device's intervals, time by name, and
    the idle time by innermost span."""
    intervals = _device_intervals(trace_path, mark_ns, lo, hi)
    by_name = {}
    for a, b, name in intervals:
        row = by_name.setdefault(name[:120], {"count": 0, "device_ms": 0.0})
        row["count"] += 1
        row["device_ms"] += (b - a) / 1e6
    rows = [dict(name=k, **v) for k, v in by_name.items()]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = merge_intervals((a, b) for a, b, _ in intervals)
    idle, t = [], lo
    for a, b in busy:
        if a > t:
            idle.append((t, a))
        t = b
    if hi > t:
        idle.append((t, hi))
    idle_by, unspanned = spans.attribute_idle(idle, recorded)
    idle_ns = sum(b - a for a, b in idle)
    coarse = sum(v for k, v in idle_by.items() if k in spans.COARSE)
    busy_s = sum(b - a for a, b in busy) / 1e9
    return dict(
        device_busy_s=busy_s,
        device_idle_share=1.0 - busy_s / ((hi - lo) / 1e9),
        by_name=rows,
        idle_by_span=sorted(([k, v / 1e9] for k, v in idle_by.items()), key=lambda r: -r[1]),
        idle_unspanned_s=unspanned / 1e9,
        # idle time that no leaf span covers: under no span or a coarse one
        idle_unattributed_share=(unspanned + coarse) / idle_ns if idle_ns else 0.0,
    )


def span_profile(walk_argv, cuda: bool) -> dict:
    """The run with spans on, under ``torch.profiler`` when ``cuda``."""
    spans.take()
    spans.enable()
    try:
        if cuda:
            from torch.profiler import ProfilerActivity, profile, record_function

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function(MARK):
                    mark_ns = time.perf_counter_ns()
                results, t0, t_run, t_end = _timed_main(walk_argv)
        else:
            results, t0, t_run, t_end = _timed_main(walk_argv)
    finally:
        spans.disable()
    recorded, counts = spans.take()
    out = dict(
        wall_s=t_end - t0,
        run_s=t_end - t_run,
        exec_s=_exec_s(results),
        steps=sum(res.steps_sampled for res in results),
    )
    if cuda:
        with tempfile.TemporaryDirectory(prefix="profile_walk_") as tmp:
            trace_path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(trace_path))
            lo, hi = int(t_run * 1e9), int(t_end * 1e9)
            out["device"] = _device_report(trace_path, mark_ns, lo, hi, recorded)
    table = sorted(spans.self_times(recorded).items(), key=lambda kv: -kv[1]["self_ns"])
    out["spans"] = {k: {"n": v["n"], "self_s": v["self_ns"] / 1e9} for k, v in table}
    out["counts"] = counts
    visits = counts.get("slot.visits", 0)
    if visits:
        slot_steps = sum(s.attrs.get("steps", 0) for s in recorded if s.name == "slot")
        out["first_order"] = dict(
            visits=visits, steps=slot_steps, hops_per_visit=slot_steps / visits
        )
    return out


def host_profile(walk_argv, top: int) -> dict:
    prof = cProfile.Profile()
    prof.enable()
    results, t0, t_run, t_end = _timed_main(walk_argv)
    prof.disable()
    stats = pstats.Stats(prof)
    out = {"wall_s": t_end - t0, "run_s": t_end - t_run, "exec_s": _exec_s(results)}
    for key in ("cumulative", "tottime"):
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(top)
        out[key] = buf.getvalue()
    out["total_calls"] = stats.total_calls
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=25, help="host functions to list")
    ap.add_argument("--json", default=None, help="write the full report here")
    ap.add_argument("walk_argv", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    walk_argv = [a for a in args.walk_argv if a != "--"]
    report = {"walk_argv": walk_argv}
    run = span_profile(walk_argv, cuda="cpu" not in walk_argv)
    report["spans"] = run.pop("spans")
    report["counts"] = run.pop("counts")
    first_order = run.pop("first_order", None)
    device = run.pop("device", None)
    if device is not None:
        report["device"] = d = {**run, **device}
        print(
            f"[device] run {d['run_s']:.2f}s, busy {d['device_busy_s']:.3f}s, "
            f"idle share {d['device_idle_share']:.4f}"
        )
        for r in d["by_name"][:10]:
            print(f"[device] {r['device_ms']:10.3f} ms  x{r['count']:6d}  {r['name']}")
        for name, s in d["idle_by_span"][:10]:
            print(f"[idle] {s:10.4f} s  {name}")
        print(f"[idle] {d['idle_unspanned_s']:10.4f} s  (no span)")
        print(f"[idle] unattributed share {d['idle_unattributed_share']:.4f}")
    for name, row in report["spans"].items():
        print(f"[spans] {row['self_s']:10.4f} s  x{row['n']:7d}  {name}")
    for name, n in sorted(report["counts"].items()):
        print(f"[counts] {n:8d}  {name}")
    if first_order is not None:
        report["first_order"] = first_order
        print(
            f"[first-order] {first_order['steps']} steps over {first_order['visits']} "
            f"walk visits: {first_order['hops_per_visit']:.3f} hops per visit"
        )
    report["host"] = host_profile(walk_argv, args.top)
    print(report["host"]["cumulative"])
    print(report["host"]["tottime"])
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
