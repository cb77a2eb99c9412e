"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (kv=32, head_dim 96)
d_ff=8192 vocab=32064, RoPE + SwiGLU  [arXiv:2404.14219]."""

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        d_model=3072,
        n_layers=32,
        n_heads=32,
        n_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32_064,
        segments=((("attn+mlp",), 32),),
        rope_theta=1e4,
        mlp_type="swiglu",
        train_microbatches=2,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b-reduced",
        d_model=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        segments=((("attn+mlp",), 2),),
        mlp_type="swiglu",
        dtype=torch.float32,  # CPU smoke tests execute; f32 avoids CPU bf16-dot gaps
        remat_policy="none",
    )
