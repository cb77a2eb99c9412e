"""Quickstart on the PyTorch port: second-order walks on a synthetic graph with GraSorw.

The twin of ``examples/quickstart.py`` on ``repro_torch``: the same
arguments (plus ``--device``, ``cuda`` by default), graph, tasks and
printed lines; every walk advance runs on the device (the CUDA pair advance
on the card, its plain PyTorch version with ``--device cpu``), so the same
counts and the same top-8 list as the JAX example.

Runs the bi-block engine vs the SOGW baseline on a synthetic graph and
prints the paper's headline quantities (block I/Os, vertex I/Os, simulated
wall time), then a PageRank query (PRNV).

    PYTHONPATH=src python examples/torch_port/quickstart.py [--vertices 5000]
        [--blocks 8] [--length 20] [--device cuda|cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np

from repro_torch.core import (
    BiBlockEngine,
    SOGWEngine,
    erdos_renyi,
    partition_into_n_blocks,
    prnv_task,
    rwnv_task,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=5000)
    ap.add_argument("--avg-degree", type=int, default=16)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--walks-per-vertex", type=int, default=2)
    ap.add_argument("--length", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    device_kw = dict(device=args.device)

    n_edges = args.vertices * args.avg_degree // 2
    print(f"building graph ({args.vertices} vertices, ~{2 * n_edges:,} directed edges)...")
    g = erdos_renyi(args.vertices, n_edges, seed=0)
    bg = partition_into_n_blocks(g, args.blocks)
    print(f"  blocks={bg.num_blocks} edge_cut={bg.edge_cut():.2%}")

    task = rwnv_task(walks_per_vertex=args.walks_per_vertex, length=args.length, seed=0)
    print(
        f"\nRWNV: {task.walks_per_vertex} walks/vertex x len {task.length} "
        f"({task.walks_per_vertex * g.num_vertices * task.length:,} samples)"
    )

    print("\n[GraSorw bi-block engine — disk walk pool + block prefetch]")
    res = BiBlockEngine(bg, task, pool="disk", pool_flush_walks=512, **device_kw).run()
    s = res.stats
    c = res.block_store_counters
    print(f"  block I/Os    : {s.block_ios:6d}  ({s.block_bytes / 1e6:.1f} MB)")
    print(f"  vertex I/Os   : {s.vertex_ios:6d}")
    print(f"  on-demand I/Os: {s.ondemand_ios:6d}")
    print(
        f"  walk spills   : {s.walk_bytes_written / 1e6:.2f} MB written "
        f"(16-byte packed records), {s.walk_bytes_read / 1e6:.2f} MB read"
    )
    print(
        f"  prefetch      : {c['prefetch_hits']} hits / "
        f"{c['prefetch_issued']} issued ({c['cache_hits']} LRU hits)"
    )
    print(
        f"  sim wall time : {s.sim_wall_time:.3f}s "
        f"(I/O {s.sim_io_time:.3f}s + exec {s.exec_time:.3f}s)"
    )
    print(f"  learned eta0  : {res.loader_summary['global_eta0']}")

    print("\n[SOGW baseline (GraphWalker + per-step vertex I/O)]")
    res2 = SOGWEngine(bg, task, **device_kw).run()
    s2 = res2.stats
    print(f"  block I/Os    : {s2.block_ios:6d}")
    print(f"  vertex I/Os   : {s2.vertex_ios:6d}  ({s2.vertex_bytes / 1e6:.1f} MB)")
    print(f"  sim wall time : {s2.sim_wall_time:.3f}s")
    print(
        f"\n  ==> GraSorw speedup: {s2.sim_wall_time / s.sim_wall_time:.1f}x "
        f"(I/O time reduction {s2.sim_io_time / max(s.sim_io_time, 1e-12):.1f}x)"
    )

    print("\nPRNV: second-order PageRank query from vertex 7")
    taskq = prnv_task(7, g.num_vertices, samples_per_vertex=2, seed=1)
    resq = BiBlockEngine(bg, taskq, **device_kw).run()
    ppr = resq.ppr_estimate()
    top = np.argsort(-ppr)[:8]
    print("  top-8 vertices:", [(int(v), round(float(ppr[v]), 4)) for v in top])


if __name__ == "__main__":
    main()
