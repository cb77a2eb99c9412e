"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (kv=16) d_ff=2816
vocab=151936, QKV bias  [hf:Qwen/Qwen1.5-0.5B]."""

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        d_model=1024,
        n_layers=24,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=2816,
        vocab_size=151_936,
        segments=((("attn+mlp",), 24),),
        qkv_bias=True,
        rope_theta=1e6,
        mlp_type="swiglu",
        train_microbatches=2,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b-reduced",
        d_model=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        segments=((("attn+mlp",), 2),),
        qkv_bias=True,
        mlp_type="swiglu",
        dtype=torch.float32,  # CPU smoke tests execute; f32 avoids CPU bf16-dot gaps
        remat_policy="none",
    )
