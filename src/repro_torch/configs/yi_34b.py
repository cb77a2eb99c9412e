"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8, head_dim 128)
d_ff=20480 vocab=64000, llama-arch  [arXiv:2403.04652].

56 heads is NOT divisible by the 16-way model axis — the sharding rules
shard the flattened head*dim projections (7168 % 16 == 0) and never the
head axis, so this config needs no special casing (DESIGN.md §4.1).
"""

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b",
        d_model=7168,
        n_layers=60,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64_000,
        segments=((("attn+mlp",), 60),),
        rope_theta=5e6,
        mlp_type="swiglu",
        train_microbatches=4,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-reduced",
        d_model=64,
        n_layers=2,
        n_heads=7,  # keep the non-power-of-two head count in the smoke test
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        segments=((("attn+mlp",), 2),),
        mlp_type="swiglu",
        dtype=torch.float32,  # CPU smoke tests execute; f32 avoids CPU bf16-dot gaps
        remat_policy="none",
    )
