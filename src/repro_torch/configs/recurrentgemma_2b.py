"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1:2 attn:recurrent.

26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 vocab=256000,
lru_width=2560, local window 2048  [arXiv:2402.19427].
Sub-quadratic (local attention + linear recurrence) -> runs long_500k.
Pattern: (rglru, rglru, local) repeated; 26 = 8*3 + 2 trailing recurrents.
"""

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        d_model=2560,
        n_layers=26,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256_000,
        segments=(
            (("rglru+mlp", "rglru+mlp", "local+mlp"), 8),
            (("rglru+mlp", "rglru+mlp"), 1),
        ),
        window=2048,
        mlp_type="geglu",
        lru_width=2560,
        conv_width=4,
        rope_theta=1e4,
        subquadratic=True,
        tie_embeddings=True,  # Griffin/Gemma tie in/out embeddings
        train_microbatches=2,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-reduced",
        d_model=64,
        n_layers=3,
        n_heads=2,
        n_kv_heads=1,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        segments=((("rglru+mlp", "rglru+mlp", "local+mlp"), 1),),
        window=16,
        mlp_type="geglu",
        lru_width=64,
        conv_width=4,
        subquadratic=True,
        dtype=torch.float32,  # CPU smoke tests execute; f32 avoids CPU bf16-dot gaps
        remat_policy="none",
    )
