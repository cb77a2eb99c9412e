"""Second-order PageRank point queries through the PyTorch port's serving layer.

The twin of ``examples/pagerank_query.py`` on ``repro_torch``: the same
queries (three sources under three Node2vec settings) go through
`repro_torch.serve.WalkQueryServer` — queries sharing a (p, q) setting
admission-batch into one bi-block sweep on the card, the hot-set policy
pins the traffic's hottest blocks — and every query's served estimate is
checked against a dedicated PRNV run of the port's in-memory oracle by
total-variation distance.  Same arguments and seeds, so the same top-5
lists and distances as the JAX example.

    PYTHONPATH=src python examples/torch_port/pagerank_query.py [--vertices 3000]
        [--samples 256] [--length 20] [--hot-blocks 2]
        [--device cuda|cpu]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np

from repro_torch.core import InMemoryWalker, barabasi_albert, partition_into_n_blocks, prnv_task
from repro_torch.serve import QueryConfig, WalkQueryServer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=3000)
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--samples", type=int, default=256, help="walks per query")
    ap.add_argument("--length", type=int, default=20)
    ap.add_argument("--hot-blocks", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    device_kw = dict(device=args.device)

    g = barabasi_albert(args.vertices, 6, seed=args.seed)
    bg = partition_into_n_blocks(g, args.blocks)
    queries = [0, 17, min(256, args.vertices - 1)]
    settings = ((1.0, 1.0), (4.0, 0.25), (0.25, 4.0))

    with WalkQueryServer(bg, hot_blocks=args.hot_blocks, seed=args.seed, **device_kw) as server:
        configs = {}
        for p, q in settings:
            cfg = QueryConfig(p=p, q=q, length=args.length, samples=args.samples)
            configs[(p, q)] = cfg
            for v in queries:
                server.submit(v, cfg)
        # one flush serves all three configs, one admission batch each
        answers = {a.qid: a for a in server.flush()}

        qid = 0
        for p, q in settings:
            print(f"\n=== Node2vec(p={p}, q={q}) ===")
            for v in queries:
                a = answers[qid]
                qid += 1
                # oracle reference: a dense PRNV estimate from the same vertex
                task = prnv_task(
                    v,
                    g.num_vertices,
                    p=p,
                    q=q,
                    length=args.length,
                    samples_per_vertex=2,
                    seed=args.seed + 1,
                )
                oracle = InMemoryWalker(bg, task, **device_kw).run(record_walks=False)
                served = a.dense_counts(g.num_vertices) / max(int(a.counts.sum()), 1)
                tv = 0.5 * np.abs(served - oracle.ppr_estimate()).sum()
                print(
                    f"  query {v:5d}: top5={[t for t, _ in a.top(5)]}  "
                    f"latency={a.latency * 1e3:.1f} ms  "
                    f"TV(served, oracle)={tv:.3f}"
                )
        s = server.stats
        lat = server.latency_summary()
        print(
            f"\nserved {lat['answered']} queries in {server.batches_served} "
            f"admission batches: p50={lat['p50'] * 1e3:.1f} ms  "
            f"p95={lat['p95'] * 1e3:.1f} ms"
        )
        print(
            f"block loads={s.block_ios}  pinned hits={s.pinned_block_hits}  "
            f"bytes saved={s.pinned_bytes_saved}"
        )


if __name__ == "__main__":
    main()
