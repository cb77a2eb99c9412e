"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256  [hf:meta-llama/Llama-3.2-1B]."""

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b",
        d_model=2048,
        n_layers=16,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=128_256,
        segments=((("attn+mlp",), 16),),
        rope_theta=5e5,
        mlp_type="swiglu",
        tie_embeddings=True,  # llama 3.2 ties in/out embeddings
        train_microbatches=2,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-reduced",
        d_model=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        segments=((("attn+mlp",), 2),),
        mlp_type="swiglu",
        dtype=torch.float32,  # CPU smoke tests execute; f32 avoids CPU bf16-dot gaps
        remat_policy="none",
    )
