"""Query-serving launcher of the PyTorch port: drive a skewed point-query mix.

    PYTHONPATH=src python -m repro_torch.launch.serve --vertices 3000 --blocks 10 \\
        --queries 96 --samples 32 --max-batch 32 [--hot-blocks 2] \\
        [--skew 0.85] [--p 4 --q 0.25] [--length 20] [--decay 0.85] \\
        [--pool disk] [--graph-backend disk --graph-dir DIR] \\
        [--no-async-pipeline] [--advance cuda|torch] [--device cuda|cpu] [--seed 0]

The flags and CSV of ``python -m repro.launch.serve``: builds a
Barabási–Albert graph, submits ``--queries`` point queries whose sources
concentrate on the hottest block with probability ``--skew`` (uniform
otherwise), serves them through :class:`repro_torch.serve.WalkQueryServer`
in admission batches of ``--max-batch``, and prints the per-query latency
percentiles plus the hot-set pinning ledger.  ``--hot-blocks 0`` is the
pure-LRU reference.  ``--advance`` picks the hand-written CUDA kernel or its
plain PyTorch version, ``--device`` the device (``cuda`` by default; there
is no fallback to the CPU).
"""

from __future__ import annotations

import argparse

import numpy as np

CSV_HEADER = (
    "queries,batches,p50_ms,p95_ms,p99_ms,block_ios,pinned_blocks,"
    "pinned_hits,pinned_bytes_saved,ondemand_syscalls,"
    "coalesced_ranges,coalesce_waste_bytes"
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=3000)
    ap.add_argument("--avg-degree", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=10)
    ap.add_argument("--queries", type=int, default=96, help="point queries to submit")
    ap.add_argument("--samples", type=int, default=32, help="walks per query")
    ap.add_argument(
        "--max-batch",
        type=int,
        default=32,
        help="admission batch size: the latency/throughput dial "
        "(larger batches amortize block loads better but hold "
        "early arrivals longer)",
    )
    ap.add_argument(
        "--hot-blocks",
        type=int,
        default=2,
        help="blocks the hot-set policy may pin resident "
        "(0 disables pinning: the pure-LRU reference)",
    )
    ap.add_argument(
        "--skew",
        type=float,
        default=0.85,
        help="fraction of query sources drawn from the highest-degree "
        "block (the rest are uniform over all vertices)",
    )
    ap.add_argument("--p", type=float, default=1.0)
    ap.add_argument("--q", type=float, default=1.0)
    ap.add_argument("--length", type=int, default=20)
    ap.add_argument("--decay", type=float, default=0.85)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--block-cache",
        type=int,
        default=4,
        help="LRU capacity (blocks) of the server's shared BlockStore",
    )
    ap.add_argument("--pool", default="memory", choices=("memory", "disk"))
    ap.add_argument(
        "--no-async-pipeline",
        action="store_true",
        help="serve each batch in the serial reference mode",
    )
    ap.add_argument(
        "--advance",
        default="cuda",
        choices=("cuda", "torch"),
        help="UpdateWalk implementation: the hand-written CUDA kernel or its "
        "plain PyTorch version — answers are bit-identical either way",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="where every batch's resident pair and advance live (cpu runs "
        "the plain PyTorch version)",
    )
    ap.add_argument("--graph-backend", default="ram", choices=("ram", "disk"))
    ap.add_argument("--graph-dir", default=None)
    ap.add_argument(
        "--io-coalesce-gap",
        type=int,
        default=0,
        help="waste budget (bytes) of the gap-aware on-demand read planner; "
        "0 = planner off, per-vertex reference reads",
    )
    return ap.parse_args(argv)


def skewed_sources(bg, n: int, skew: float, rng) -> list:
    """``n`` query sources: from block 0 with probability ``skew``, else
    uniform over the graph.  BA preferential attachment puts the hubs at
    the low vertex ids, so block 0 is the natural hot block."""
    hot_lo, hot_hi = int(bg.block_starts[0]), int(bg.block_starts[1])
    return [int(rng.integers(hot_lo, hot_hi)) if rng.random() < skew
            else int(rng.integers(0, bg.num_vertices)) for _ in range(n)]  # fmt: skip


def main(argv=None):
    """Serve the mix, print the CSV, and return ``(answers, server)``; the
    server is closed, its ``stats``, ``latency_summary()``,
    ``batches_served`` and ``advance_calls`` stay readable."""
    args = parse_args(argv)

    from repro_torch.core import barabasi_albert, partition_into_n_blocks
    from repro_torch.serve import QueryConfig, WalkQueryServer

    g = barabasi_albert(args.vertices, max(args.avg_degree // 2, 1), seed=args.seed + 2)
    bg = partition_into_n_blocks(g, args.blocks)
    if args.graph_backend == "disk":
        from repro_torch.io import write_and_open

        bg = write_and_open(bg, args.graph_dir, io_coalesce_gap=args.io_coalesce_gap)
    else:
        bg.io_coalesce_gap = args.io_coalesce_gap

    config = QueryConfig(
        p=args.p, q=args.q, length=args.length, decay=args.decay, samples=args.samples
    )
    sources = skewed_sources(bg, args.queries, args.skew, np.random.default_rng(args.seed + 7))
    with WalkQueryServer(
        bg,
        max_batch=args.max_batch,
        hot_blocks=args.hot_blocks,
        block_cache_blocks=args.block_cache,
        seed=args.seed,
        pool=args.pool,
        async_pipeline=not args.no_async_pipeline,
        advance_impl=args.advance,
        device=args.device,
    ) as server:
        for source in sources:
            server.submit(source, config)
        answers = server.flush()
        lat = server.latency_summary()
        s = server.stats
        print(CSV_HEADER)
        print(
            f"{len(answers)},{server.batches_served},"
            f"{lat['p50'] * 1e3:.2f},{lat['p95'] * 1e3:.2f},{lat['p99'] * 1e3:.2f},"
            f"{s.block_ios},{s.hot_pinned_blocks},{s.pinned_block_hits},"
            f"{s.pinned_bytes_saved},{s.ondemand_syscalls},"
            f"{s.coalesced_ranges},{s.coalesce_waste_bytes}",
            flush=True,
        )
    return answers, server


if __name__ == "__main__":
    main()
