"""One run of one cell of the benchmark of ``repro_torch``'s bi-block engine.

A cell (``workloads`` in ``BENCHMARK.json``) names a configuration, which is
a graph, where it lives and the memory budget (``configs/<name>.json``), and
a traffic mix, which is the walk task (``traffic/<name>.json``).  A run:

1. set-up: makes the Graph500 edge list from the seed, hands it to the
   program (CSR build and partition, and the on-disk container for a disk
   configuration), and runs one warm-up task on a sixteenth of the walks,
   cut to 2 hops;
2. the window: whole tasks back to back, each a new
   ``BiBlockEngine(bg, task, ...).run()``, until ``seconds`` have passed;
   task ``k`` takes its walk seed, and its query vertex, from the seed and
   ``k``;
3. the check, once the window has closed and the device's peak is read:
   the plain reference (:mod:`walkbench.reference`) walks every walk of
   every task again, and each task's corpus, endpoint counts and steps
   must equal it (limits in :data:`LIMITS`);
4. the metrics: ``metrics/<name>.py`` reads each metric that the cell
   reports from the run's record.

Nothing here is specific to one cell: a new configuration, traffic mix or
metric is a new file and a new entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional

import numpy as np

from walkbench import graph500, reference

__all__ = ["Cell", "LIMITS", "TaskOutput", "check", "resolve_cell", "run_cell"]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: every compared number, and the most it may read in a correct run: the
#: reference reproduces each walk exactly, so a sound run reads 0
LIMITS = {"walks_mismatched": 0, "endpoints_mismatched": 0, "steps_mismatched": 0}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve_cell(name: str, spec: Optional[dict] = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    spec = load_spec(root) if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
    )


def metric_reader(name: str):
    """``read(record) -> float | None`` of ``metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"walkbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# -- the traffic: tasks and their walk sources ------------------------------------------------


def num_vertices(config: dict) -> int:
    return 1 << int(config["scale"])


def make_edges(config: dict, seed: int, device: str) -> np.ndarray:
    return graph500.kronecker_edges(
        config["scale"], config["edge_factor"], config["A"], config["B"], config["C"], seed, device
    )


def task_plan(traffic: dict, seed: int, k: int, queries: Optional[np.ndarray]) -> dict:
    """Task ``k``'s walk seed and, for a query task, its query vertex
    (``k = -1``: the warm-up task)."""
    rng = graph500.task_rng(seed, k)
    plan = {"k": k, "seed": int(rng.integers(0, 2**31)), "query": None}
    if traffic["starts"] == "one_query":
        plan["query"] = int(queries[rng.integers(0, queries.size)])
    return plan


def walk_sources(traffic: dict, config: dict, plan: dict) -> np.ndarray:
    """Source of walk ``w`` for every walk id of the task."""
    V = num_vertices(config)
    if traffic["starts"] == "every_vertex":
        return np.repeat(np.arange(V, dtype=np.int64), int(config["walks_per_vertex"]))
    return np.full(int(traffic["samples_per_vertex"]) * V, plan["query"], np.int64)


def walk_params(traffic: dict) -> dict:
    """The walk law of the traffic, as the reference takes it."""
    second_order = traffic["model"] == "node2vec"
    return dict(
        length=int(traffic["length"]),
        p=float(traffic["p"]) if second_order else 1.0,
        q=float(traffic["q"]) if second_order else 1.0,
        decay=float(traffic["decay"]),
        k_max=int(traffic["max_proposals"]),
        record=bool(traffic["record_walks"]),
    )


def program_task(traffic: dict, config: dict, plan: dict):
    from repro_torch.core import DeepWalk, Node2vec, WalkTask

    if traffic["model"] == "node2vec":
        model = Node2vec(p=float(traffic["p"]), q=float(traffic["q"]))
    else:
        model = DeepWalk()
    kw = dict(length=int(traffic["length"]), decay=float(traffic["decay"]), seed=plan["seed"])
    if traffic["starts"] == "every_vertex":
        return WalkTask(model, walks_per_vertex=int(config["walks_per_vertex"]), **kw)
    total = int(traffic["samples_per_vertex"]) * num_vertices(config)
    return WalkTask(model, query_vertex=plan["query"], total_walks=total, **kw)


def engine_kwargs(config: dict, traffic: dict, device: str) -> dict:
    return dict(
        record_walks=bool(traffic["record_walks"]),
        k_max=int(traffic["max_proposals"]),
        pool=config["walk_pool"],
        pool_flush_walks=int(config["pool_flush_walks"]),
        device=device,
    )


# -- the program ------------------------------------------------------------------------------


def build_graph(config: dict, edges: np.ndarray, workdir: Path):
    """The program's graph: CSR, blocks, and the container for a disk graph."""
    from repro_torch.core import CSRGraph, partition_into_n_blocks

    g = CSRGraph.from_edges(edges, num_vertices(config))
    bg = partition_into_n_blocks(g, int(config["blocks"]))
    if config["graph_storage"] == "disk":
        from repro_torch.io import write_and_open

        bg = write_and_open(bg, str(workdir / "graph"))
    elif config["graph_storage"] != "ram":
        raise ValueError(f"graph_storage must be 'ram' or 'disk', got {config['graph_storage']!r}")
    return bg


@dataclasses.dataclass
class TaskOutput:
    """What one task of the window produced, as the check reads it."""

    plan: dict
    corpus: Optional[np.ndarray]
    endpoint_counts: np.ndarray
    steps: int


def _task_record(res, wall_s: float) -> dict:
    s = res.stats
    return dict(
        wall_s=wall_s,
        exec_s=s.exec_time,
        steps=int(res.steps_sampled),
        advance_calls=int(res.advance_calls),
        num_walks=int(res.num_walks),
        block_bytes=int(s.block_bytes),
        vertex_bytes=int(s.vertex_bytes),
        ondemand_bytes=int(s.ondemand_bytes),
        walk_bytes_written=int(s.walk_bytes_written),
        walk_bytes_read=int(s.walk_bytes_read),
    )


# -- the check --------------------------------------------------------------------------------


def check(
    outputs: list,
    edges: np.ndarray,
    config: dict,
    traffic: dict,
    device: str,
    draw_dtype=None,
) -> dict:
    """Walk every task of ``outputs`` again with the reference.  Returns the
    compared numbers (:data:`LIMITS`), summed over the tasks, and the number
    of tasks whose output differs."""
    import torch

    draw_dtype = torch.float32 if draw_dtype is None else draw_dtype
    params = walk_params(traffic)
    adj = reference.build_adjacency(edges, num_vertices(config), device)
    numbers = dict.fromkeys(LIMITS, 0)
    bad_tasks = 0
    for out in outputs:
        src = torch.as_tensor(walk_sources(traffic, config, out.plan))
        ref = reference.walk(adj, src, seed=out.plan["seed"], draw_dtype=draw_dtype, **params)
        task = dict.fromkeys(LIMITS, 0)
        if params["record"]:
            got = out.corpus
            if got is None or tuple(got.shape) != tuple(ref.corpus.shape):
                task["walks_mismatched"] = int(src.numel())
            else:
                got = torch.as_tensor(got).to(ref.corpus.device)
                task["walks_mismatched"] = int((got != ref.corpus).any(dim=1).sum())
        ends = torch.as_tensor(out.endpoint_counts).to(ref.endpoint_counts.device)
        if ends.shape != ref.endpoint_counts.shape:
            task["endpoints_mismatched"] = adj.num_vertices
        else:
            task["endpoints_mismatched"] = int((ends != ref.endpoint_counts).sum())
        task["steps_mismatched"] = abs(int(out.steps) - ref.steps)
        bad_tasks += any(task.values())
        for k, v in task.items():
            numbers[k] += v
        del ref
    return numbers, bad_tasks


def verdict(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


# -- a run ------------------------------------------------------------------------------------


def run_cell(
    cell: Cell,
    seed: int,
    seconds: float,
    trace: bool,
    *,
    device: str = "cuda",
    t_process: Optional[float] = None,
    log=print,
) -> dict:
    """Set up, measure for ``seconds``, check, and read the cell's metrics.
    Returns the result line's object (``checks`` last)."""
    import torch

    from repro_torch.core import BiBlockEngine

    t0 = time.perf_counter() if t_process is None else t_process
    cuda = device == "cuda"
    config, traffic = cell.config, cell.traffic
    edges = make_edges(config, seed, device)
    if cuda:
        # the peak is the program's: the generator's buffers are gone
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    queries = None
    if traffic["starts"] == "one_query":
        queries = graph500.non_isolated(edges, num_vertices(config))
    kw = engine_kwargs(config, traffic, device)
    tasks, outputs, failed = [], [], 0
    traced = None
    with tempfile.TemporaryDirectory(prefix="walkbench_") as work:
        work = Path(work)
        t_g = time.perf_counter()
        bg = build_graph(config, edges, work)
        graph_build_s = time.perf_counter() - t_g
        # warm-up: the cell's own task on every 16th walk, cut to 2 hops (the
        # kernel takes any lane count; what warms is the kernels' build and
        # load, the CUDA context and the engine's code paths)
        plan = task_plan(traffic, seed, -1, queries)
        warm = walk_sources(traffic, config, plan)[::16]
        task = dataclasses.replace(program_task(traffic, config, plan), length=2)
        BiBlockEngine(bg, task, initial_walks=warm, **kw).run()
        if cuda:
            torch.cuda.synchronize()
        log(
            f"set-up: edges {t_g - t0:.3f} s from the process's start, graph build "
            f"{graph_build_s:.3f} s, warm-up {time.perf_counter() - t_g - graph_build_s:.3f} s"
        )
        if trace:
            from walkbench.devtrace import TracedWindow

            traced = TracedWindow(work / "trace.json")
            traced.start()
            t_start = traced.mark()
        else:
            t_start = time.perf_counter()
        setup_s = t_start - t0
        k = 0
        t_end = t_start
        res = None
        while k == 0 or t_end - t_start < seconds:
            plan = task_plan(traffic, seed, k, queries)
            t_a = time.perf_counter()
            try:
                res = BiBlockEngine(bg, program_task(traffic, config, plan), **kw).run()
            except Exception:
                failed += 1
                log(f"task {k} raised:\n{traceback.format_exc()}")
                t_end = time.perf_counter()
                break
            t_end = time.perf_counter()
            tasks.append(_task_record(res, t_end - t_a))
            log(f"task {k}: {json.dumps(tasks[-1])}")
            outputs.append(TaskOutput(plan, res.corpus, res.endpoint_counts, res.steps_sampled))
            k += 1
        if cuda:
            torch.cuda.synchronize()
        breakdown = None
        if traced is not None:
            traced.stop(t_end)
            breakdown = traced.reduce()
        memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        close = getattr(bg, "close", None)
        if close is not None:
            close()
        del bg, res
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_c = time.perf_counter()
    numbers, bad_tasks = check(outputs, edges, config, traffic, device)
    log(f"check of {len(outputs)} tasks took {time.perf_counter() - t_c:.3f} s")
    record = dict(
        setup_s=setup_s,
        graph_build_s=graph_build_s,
        window_s=t_end - t_start,
        tasks=tasks,
        record_walks=bool(traffic["record_walks"]),
        weighted=False,
        device_kind=torch.cuda.get_device_name() if cuda else "cpu",
        trace=breakdown,
    )
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = metric_reader(m["name"])(record) if tasks else None
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {
        "correct": bool(tasks) and failed == 0 and verdict(numbers),
        "attempted": len(tasks) + failed,
        "failed": failed + bad_tasks,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": record["device_kind"],
            "count": cell.chips,
            "memory_peak_bytes": memory_peak,
        },
    }
    if breakdown is not None:
        result["device"]["busy_s"] = breakdown["busy_s"]
        result["device"]["window_s"] = breakdown["window_s"]
        result["breakdown"] = {k: breakdown[k] for k in ("device_ops", "idle_gaps")}
    result["checks"] = {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}
    return result
