"""Walk-engine launcher of the PyTorch port: run a GraSorw task.

    PYTHONPATH=src python -m repro_torch.launch.walk --task rwnv --vertices 5000 \\
        --engine biblock [--engine sogw|sgsc|pb|oracle] [--p 4 --q 0.25] \\
        [--graph-backend disk --graph-dir /path/to/dir] [--pool disk] \\
        [--no-async-pipeline] [--pool-shards 4] \\
        [--device cuda|cpu]

The flags, engines and CSV columns of ``python -m repro.launch.walk`` (by
default the ``biblock`` and ``sogw`` engines), with the device chosen by
``--device``, which reaches every engine: ``cuda`` (the default) runs the
hand-written CUDA kernel, ``cpu`` its plain PyTorch version.
"""

from __future__ import annotations

import argparse

CSV_HEADER = (
    "engine,block_ios,vertex_ios,ondemand_ios,ondemand_syscalls,"
    "coalesced_ranges,coalesce_waste_bytes,walk_bytes_written,"
    "peak_resident_bytes,prefetch_hits,overlapped_load_bytes,"
    "pipeline_stall_slots,writer_queue_peak,sim_io_s,exec_s,sim_wall_s"
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=("rwnv", "prnv", "deepwalk"), default="rwnv")
    ap.add_argument(
        "--engine",
        action="append",
        default=None,
        choices=("biblock", "pb", "sogw", "sgsc", "oracle"),
    )
    ap.add_argument("--vertices", type=int, default=5000)
    ap.add_argument("--avg-degree", type=int, default=16)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--walks-per-vertex", type=int, default=2)
    ap.add_argument("--length", type=int, default=20)
    ap.add_argument("--p", type=float, default=1.0)
    ap.add_argument("--q", type=float, default=1.0)
    ap.add_argument("--query", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loading", default="auto", choices=("auto", "full", "ondemand"))
    ap.add_argument("--pool", default="memory", choices=("memory", "disk"))
    ap.add_argument("--pool-flush-walks", type=int, default=1 << 18)
    ap.add_argument("--no-prefetch", action="store_true")
    ap.add_argument("--no-async-pipeline", action="store_true")
    ap.add_argument("--writer-queue", type=int, default=64)
    ap.add_argument("--pool-shards", type=int, default=1)
    ap.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="where the resident pair and the advance live (cpu runs the "
        "plain PyTorch version)",
    )
    ap.add_argument("--graph-backend", default="ram", choices=("ram", "disk"))
    ap.add_argument("--graph-dir", default=None)
    ap.add_argument("--io-coalesce-gap", type=int, default=0)
    return ap.parse_args(argv)


def csv_row(name: str, res) -> str:
    s = res.stats
    hits = (res.block_store_counters or {}).get("prefetch_hits", 0)
    return (
        f"{name},{s.block_ios},{s.vertex_ios},{s.ondemand_ios},"
        f"{s.ondemand_syscalls},{s.coalesced_ranges},{s.coalesce_waste_bytes},"
        f"{s.walk_bytes_written},{s.peak_resident_bytes},{hits},"
        f"{s.overlapped_load_bytes},{s.pipeline_stall_slots},"
        f"{s.writer_queue_peak},"
        f"{s.sim_io_time:.4f},{s.exec_time:.4f},{s.sim_wall_time:.4f}"
    )


def main(argv=None) -> list:
    """Run the task, print the CSV, and return ``[(engine, WalkResult)]``."""
    args = parse_args(argv)

    from repro_torch.core import (
        BiBlockEngine,
        InMemoryWalker,
        PlainBucketEngine,
        SOGWEngine,
        deepwalk_task,
        erdos_renyi,
        partition_into_n_blocks,
        prnv_task,
        rwnv_task,
    )

    g = erdos_renyi(args.vertices, args.vertices * args.avg_degree // 2, seed=args.seed)
    bg_ram = partition_into_n_blocks(g, args.blocks)
    if args.graph_backend == "disk":
        from repro_torch.io import write_and_open

        # default scratch dir is removed at exit; an explicit --graph-dir
        # persists so the container can be reused across runs
        bg = write_and_open(bg_ram, args.graph_dir, io_coalesce_gap=args.io_coalesce_gap)
    else:
        bg = bg_ram
        bg.io_coalesce_gap = args.io_coalesce_gap
    if args.task == "rwnv":
        task = rwnv_task(
            p=args.p,
            q=args.q,
            walks_per_vertex=args.walks_per_vertex,
            length=args.length,
            seed=args.seed,
        )
    elif args.task == "prnv":
        task = prnv_task(args.query, g.num_vertices, p=args.p, q=args.q, seed=args.seed)
    else:
        task = deepwalk_task(
            walks_per_vertex=args.walks_per_vertex, length=args.length, seed=args.seed
        )

    device_kw = dict(device=args.device)
    pool_kw = dict(
        device_kw,
        pool=args.pool,
        pool_flush_walks=args.pool_flush_walks,
        prefetch=not args.no_prefetch,
    )
    biblock_kw = dict(
        pool_kw,
        loading=args.loading,
        async_pipeline=not args.no_async_pipeline,
        writer_queue=args.writer_queue,
        pool_shards=args.pool_shards,
    )
    print(CSV_HEADER)
    results = []
    for name in args.engine or ["biblock", "sogw"]:
        if name == "biblock":
            res = BiBlockEngine(bg, task, **biblock_kw).run()
        elif name == "pb":
            res = PlainBucketEngine(bg, task, **pool_kw).run()
        elif name == "sogw":
            res = SOGWEngine(bg, task, **pool_kw).run()
        elif name == "sgsc":
            res = SOGWEngine(bg, task, static_cache=True, **pool_kw).run()
        else:
            # the oracle needs the whole CSR in RAM regardless of backend
            res = InMemoryWalker(bg_ram, task, **device_kw).run(record_walks=False)
        print(csv_row(name, res), flush=True)
        results.append((name, res))
    return results


if __name__ == "__main__":
    main()
