"""The control of ``correct``: the reference at a lower precision, put in the
program's place, must come out as not correct.

    python3 walkbench/control.py --workload rwnv.graph500-s18-disk16 \\
        --seeds 11 12 13 --tasks 2

For each seed it makes the cell's graph and the first ``--tasks`` tasks of a
run, walks them with the reference computing its draws and the proposal
product in bfloat16 (the precision below the configuration's float32), and
hands those outputs to the run's own check as if the program had made
them.  It prints one JSON line a seed with the compared numbers and the
verdict.  The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_outputs(cell, seed: int, tasks: int, device: str, draw_dtype):
    """The first ``tasks`` tasks of a run of ``cell``, walked by the
    reference at ``draw_dtype``, as the check takes a run's outputs."""
    import torch

    from walkbench import graph500, harness, reference

    config, traffic = cell.config, cell.traffic
    edges = harness.make_edges(config, seed, device)
    queries = None
    if traffic["starts"] == "one_query":
        queries = graph500.non_isolated(edges, harness.num_vertices(config))
    adj = reference.build_adjacency(edges, harness.num_vertices(config), device)
    params = harness.walk_params(traffic)
    outputs = []
    for k in range(tasks):
        plan = harness.task_plan(traffic, seed, k, queries)
        src = torch.as_tensor(harness.walk_sources(traffic, config, plan))
        w = reference.walk(adj, src, seed=plan["seed"], draw_dtype=draw_dtype, **params)
        corpus = None if w.corpus is None else w.corpus.cpu().numpy()
        outputs.append(
            harness.TaskOutput(plan, corpus, w.endpoint_counts.cpu().numpy(), w.steps)
        )
    return edges, outputs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--tasks", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT)]
    import torch

    from walkbench import harness

    cell = harness.resolve_cell(args.workload)
    failed_all = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        edges, outputs = control_outputs(cell, seed, args.tasks, "cuda", torch.bfloat16)
        numbers, bad = harness.check(outputs, edges, cell.config, cell.traffic, "cuda")
        correct = harness.verdict(numbers)
        failed_all &= not correct
        line = dict(workload=cell.name, seed=seed, tasks=args.tasks, correct=correct,
                    bad_tasks=bad, numbers=numbers, seconds=time.perf_counter() - t0)  # fmt: skip
        print(json.dumps(line), flush=True)
    print(json.dumps({"control_rejected_on_every_seed": failed_all}))
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
