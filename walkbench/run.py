"""Run one cell of the benchmark on the card and print its result line.

    python3 walkbench/run.py --workload rwnv.graph500-s18-disk16 --seed 7 \\
        --seconds 30 --trace 0

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and ``checks`` last); the last lines of standard error give
each compared number beside its limit.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics.

The run exits with a code other than 0, and prints no result, when there is
no CUDA device (or fewer than the cell asks for), when the program is not
beside the benchmark, and when JAX or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: whole top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    loaded = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    # the benchmark's own package and the program beside it; never this
    # directory itself, whose module names could shadow others
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).parent]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # the kernels' build cache: a fixed directory inside the checkout
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "src" / "repro_torch" / "kernels" / "_build")

    from walkbench import harness

    cell = harness.resolve_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {cell.name} needs {cell.chips} CUDA device(s); found {have}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here when the program is not beside the benchmark)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    result = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), t_process=T_PROCESS, log=log
    )
    found = forbidden_modules()
    if found:
        print(f"modules that no run may load are loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0 if result["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
