"""Batched serving demo on the PyTorch port: prefill + decode loop on a
reduced config.

The twin of ``examples/serve_lm.py`` on ``repro_torch``: prefill a batch of
prompts, then decode tokens step by step against the KV caches, greedily.
Same arguments and printed lines; the weights come from the port's own
``model_init`` (seed 0), so the tokens differ from the JAX example's.

    PYTHONPATH=src python examples/torch_port/serve_lm.py [--arch llama3.2-1b]
        [--device cuda|cpu]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.models import model_caches, model_init, model_prefill
from repro_torch.models.common import tree_map
from repro_torch.train import make_decode_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    cfg = reduced_config(args.arch)
    if cfg.skip_decode:
        raise SystemExit(f"{args.arch} has no decode step")
    params = model_init(0, cfg, device=args.device)
    dev = params["embed"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(0)
    B, P = args.batch, args.prompt_len
    prompts = torch.as_tensor(rng.integers(1, cfg.vocab_size, (B, P)).astype(np.int32), device=dev)

    batch = {"tokens": prompts}
    if cfg.frontend == "vision":
        batch["prefix"] = torch.zeros((B, cfg.num_prefix, cfg.d_model), dtype=cfg.dtype, device=dev)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.as_tensor(
            rng.standard_normal((B, P, cfg.d_model)).astype(np.float32), device=dev
        )

    max_len = P + args.new_tokens + (cfg.num_prefix if cfg.frontend == "vision" else 0)
    t0 = time.time()
    logits, pcaches = model_prefill(params, batch, cfg)
    sync()
    print(f"prefill: batch={B} len={P} in {time.time() - t0:.2f}s")

    # copy the prefill caches into the fixed decode buffers (zero beyond)
    def pad(got, tgt):
        tgt[tuple(slice(0, n) for n in got.shape)] = got
        return tgt

    caches = tree_map(pad, pcaches, model_caches(cfg, B, max_len, enc_len=P, device=dev))

    decode = make_decode_step(cfg)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    out = [tok]
    pos = P + (cfg.num_prefix if cfg.frontend == "vision" else 0)
    t0 = time.time()
    for i in range(args.new_tokens - 1):
        tok, _, caches = decode(params, {"token": tok, "cache_len": pos + i}, caches)
        tok = tok[:, None]
        out.append(tok)
    sync()
    dt = time.time() - t0
    seqs = torch.cat(out, dim=1).cpu().numpy()
    print(
        f"decoded {args.new_tokens} tokens per seq in {dt:.2f}s "
        f"({B * args.new_tokens / dt:.1f} tok/s)"
    )
    for b in range(B):
        print(f"  seq {b}: {seqs[b].tolist()}")


if __name__ == "__main__":
    main()
