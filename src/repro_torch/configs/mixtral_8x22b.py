"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8, head_dim 128)
d_ff=16384, 8 experts top-2, sliding-window attention  [arXiv:2401.04088].

8 experts < 16-way model axis -> experts are tensor-parallel (per-expert
FFN dim sharded), not expert-parallel.
"""

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        d_model=6144,
        n_layers=56,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=32_768,
        segments=((("local+moe",), 56),),  # SWA + MoE every layer
        window=4096,
        n_experts=8,
        top_k=2,
        moe_d_ff=16384,
        moe_shard_experts=True,
        moe_virtual_split=2,  # 8 experts x 2 halves = 16-way EP (see Perf log)
        rope_theta=1e6,
        mlp_type="swiglu",
        train_microbatches=4,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-reduced",
        d_model=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        segments=((("local+moe",), 2),),
        window=32,
        n_experts=4,
        top_k=2,
        moe_d_ff=128,
        capacity_factor=8.0,  # no token drops in the smoke configs
        mlp_type="swiglu",
        dtype=torch.float32,  # CPU smoke tests execute; f32 avoids CPU bf16-dot gaps
        remat_policy="none",
    )
