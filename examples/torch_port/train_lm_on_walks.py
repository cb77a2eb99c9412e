"""End to end on the PyTorch port: GraSorw walk corpus -> train a ~100M-param LM.

The twin of ``examples/train_lm_on_walks.py`` on ``repro_torch``: the same
arguments (plus ``--device``, ``cuda`` by default), configs, corpus and
printed lines; the walks come from the port's bi-block engine (the CUDA
pair advance on the card) and the model trains with the port's step, which
updates the parameters and the optimiser state in place.

This is the production integration the paper enables: Node2vec walk
generation as the corpus engine, then a llama-family model (scaled to ~100M
params so a few hundred CPU steps are feasible) trained on vertex-token
sequences with the resilient trainer (checkpoint/restart, straggler
watchdog).

    PYTHONPATH=src python examples/torch_port/train_lm_on_walks.py [--steps 300] [--tiny]
        [--device cuda|cpu]
"""

import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch

from repro_torch.core import BiBlockEngine, erdos_renyi, partition_into_n_blocks, rwnv_task
from repro_torch.data import WalkCorpus
from repro_torch.models import model_init
from repro_torch.models.common import ModelConfig, tree_leaves
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.runtime import ResilientTrainer
from repro_torch.train import make_train_step


def lm_100m(vocab: int) -> ModelConfig:
    """~100M llama-family config (8L x 768, GQA 12/4)."""
    return ModelConfig(
        name="walklm-100m",
        d_model=768,
        n_layers=8,
        n_heads=12,
        n_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=vocab,
        segments=((("attn+mlp",), 8),),
        mlp_type="swiglu",
        dtype=torch.float32,
        remat_policy="none",
    )


def lm_tiny(vocab: int) -> ModelConfig:
    """Micro config for smoke runs (2L x 128) — same code path, seconds to train."""
    return ModelConfig(
        name="walklm-tiny",
        d_model=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=vocab,
        segments=((("attn+mlp",), 2),),
        mlp_type="swiglu",
        dtype=torch.float32,
        remat_policy="none",
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--vertices", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=str(Path(tempfile.gettempdir()) / "walklm_ckpt"))
    ap.add_argument(
        "--tiny",
        action="store_true",
        help="micro model and short walks: the full pipeline end to end in seconds",
    )
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    print("phase 1: walk generation (GraSorw bi-block engine)")
    g = erdos_renyi(args.vertices, args.vertices * 8, seed=0)
    bg = partition_into_n_blocks(g, 6)
    walk_len = 10 if args.tiny else 40
    task = rwnv_task(walks_per_vertex=4, length=walk_len, seed=0)
    t0 = time.time()
    res = BiBlockEngine(bg, task, record_walks=True, device=args.device).run()
    print(
        f"  {res.num_walks:,} walks x {task.length} steps in "
        f"{time.time() - t0:.1f}s wall ({res.stats.block_ios} block I/Os)"
    )
    corpus = WalkCorpus.from_walks(res.corpus, g.num_vertices)

    print("phase 2: LM training on the walk corpus")
    cfg = lm_tiny(corpus.vocab_size) if args.tiny else lm_100m(corpus.vocab_size)
    params = model_init(0, cfg, device=args.device)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"  model: {cfg.name}  params={n / 1e6:.1f}M")
    opt_cfg = OptConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps)
    step = make_train_step(cfg, opt_cfg)
    opt = adamw_init(params)

    trainer = ResilientTrainer(
        train_step=step,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=100,
        heartbeat_path=Path(args.ckpt_dir) / "heartbeat",
    )
    resumed = None
    try:
        resumed = trainer.resume(params, opt)
    except Exception:
        pass
    start = 0
    cursor = 0
    if resumed is not None:
        params, opt, start, cursor = resumed
        cursor = cursor or 0
        print(f"  resumed from checkpoint at step {start}")

    losses = []

    def on_metrics(s, m):
        losses.append(m["loss"])
        if s % 20 == 0:
            tail = "  [straggler]" if m["straggler"] else ""
            print(
                f"  step {s:4d}  loss {m['loss']:.4f}  "
                f"lr {m['lr']:.2e}  {m['step_time'] * 1e3:.0f} ms{tail}"
            )

    params, opt, info = trainer.run(
        params,
        opt,
        corpus.batches(args.batch, args.seq, cursor=cursor, seed=1),
        num_steps=args.steps,
        start_step=start,
        on_metrics=on_metrics,
    )
    print(
        f"done: step {info['step']}  final loss {losses[-1]:.4f}  "
        f"(first {losses[0]:.4f}); stragglers flagged: {len(info['stragglers'])}"
    )


if __name__ == "__main__":
    main()
