"""Where the time of one launcher run goes, host and device.

    PYTHONPATH=src python -m repro_torch.launch.profile_walk [--top 25] \\
        [--json report.json] -- <repro_torch.launch.walk flags>

Runs the launcher's path (:func:`repro_torch.launch.walk.main`) twice:

1. under ``torch.profiler`` (CUDA activity only): device time by kernel and
   copy, and the device's busy and idle share of the engine's time;
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
import time


def _timed_main(walk_argv):
    import torch

    from repro_torch.launch import walk

    t0 = time.perf_counter()
    results = [res for _, res in walk.main(walk_argv)]
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    return results, t_end - t0, t_end - results[0].stats.wall_start


def _exec_s(results) -> float:
    return sum(res.stats.exec_time for res in results)


def device_profile(walk_argv) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        results, wall, run_s = _timed_main(walk_argv)
    rows = []
    busy_us = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us <= 0:
            continue
        busy_us += dev_us
        rows.append(dict(name=ev.key[:120], count=ev.count, device_ms=dev_us / 1e3))
    rows.sort(key=lambda r: -r["device_ms"])
    return dict(
        wall_s=wall,
        run_s=run_s,
        exec_s=_exec_s(results),
        steps=sum(res.steps_sampled for res in results),
        device_busy_s=busy_us / 1e6,
        device_idle_share=1.0 - busy_us / 1e6 / run_s,
        by_name=rows,
    )


def host_profile(walk_argv, top: int) -> dict:
    prof = cProfile.Profile()
    prof.enable()
    results, wall, run_s = _timed_main(walk_argv)
    prof.disable()
    stats = pstats.Stats(prof)
    out = {"wall_s": wall, "run_s": run_s, "exec_s": _exec_s(results)}
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
    if "cpu" not in walk_argv:
        report["device"] = device_profile(walk_argv)
        d = report["device"]
        print(
            f"[device] run {d['run_s']:.2f}s, busy {d['device_busy_s']:.3f}s, "
            f"idle share {d['device_idle_share']:.4f}"
        )
        for r in d["by_name"][:10]:
            print(f"[device] {r['device_ms']:10.3f} ms  x{r['count']:6d}  {r['name']}")
    report["host"] = host_profile(walk_argv, args.top)
    print(report["host"]["cumulative"])
    print(report["host"]["tottime"])
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
