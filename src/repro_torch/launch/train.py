"""Train launcher of the PyTorch port: walk corpus -> resilient LM training.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        [--reduced] [--steps 50] [--device cuda|cpu]

The flags and printed lines of ``python -m repro.launch.train``, plus
``--device`` (``cuda`` by default; asked for ``cuda`` without a card, it
raises).  It assembles config -> walk corpus (``BiBlockEngine`` on the
device, the CUDA pair advance on the card) -> ``WalkCorpus`` -> params ->
``make_train_step`` -> AdamW state -> ``ResilientTrainer``, which resumes
from the newest committed checkpoint in ``--ckpt-dir`` and writes one
every ``max(steps // 4, 10)`` steps and at the end.  The step updates the
parameters and the optimiser state in place, where the JAX launcher
donates them to ``jit``.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=str(Path(tempfile.gettempdir()) / "repro_train_ckpt"))
    ap.add_argument("--graph-vertices", type=int, default=2000)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="where the walks, the parameters and the step run",
    )
    return ap.parse_args(argv)


def main(argv=None, *, on_metrics=None):
    """Train and print the JAX launcher's lines.  ``on_metrics(step,
    metrics)``, where given, is called after each step beside the printed
    lines.  Returns the trainer's ``(params, opt_state, info)``."""
    args = parse_args(argv)

    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core import BiBlockEngine, erdos_renyi, partition_into_n_blocks, rwnv_task
    from repro_torch.data import WalkCorpus
    from repro_torch.engines import resolve_device
    from repro_torch.models import model_init
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.runtime import ResilientTrainer
    from repro_torch.train import make_train_step

    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"arch={cfg.name} devices={n_dev}")

    # data: walk corpus from the paper's engine
    g = erdos_renyi(args.graph_vertices, args.graph_vertices * 8, seed=0)
    bg = partition_into_n_blocks(g, 6)
    res = BiBlockEngine(
        bg, rwnv_task(walks_per_vertex=2, length=32), record_walks=True, device=dev
    ).run()
    corpus = WalkCorpus.from_walks(res.corpus, g.num_vertices)
    print(f"corpus: {len(corpus):,} walks, vocab {corpus.vocab_size:,}")

    params = model_init(0, cfg, device=dev)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps)
    step = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)
    opt = adamw_init(params)
    trainer = ResilientTrainer(
        train_step=step, ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 4, 10),
        heartbeat_path=Path(args.ckpt_dir) / "heartbeat",
    )  # fmt: skip
    resumed = trainer.resume(params, opt)
    start, cursor = 0, 0
    if resumed:
        params, opt, start, cursor = resumed
        cursor = cursor or 0
        print(f"resumed at step {start}")

    def log_metrics(s, m):
        if s % 10 == 0:
            print(f"step {s:4d} loss {m['loss']:.4f} ({m['step_time']*1e3:.0f} ms)")
        if on_metrics:
            on_metrics(s, m)

    params, opt, info = trainer.run(
        params, opt,
        corpus.batches(args.batch, args.seq, cursor=cursor, seed=1),
        num_steps=args.steps, start_step=start, on_metrics=log_metrics,
    )  # fmt: skip
    print(f"finished at step {info['step']}; checkpoints in {args.ckpt_dir}")
    return params, opt, info


if __name__ == "__main__":
    main()
