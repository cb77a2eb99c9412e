"""mamba2-2.7b [ssm]: 64L d_model=2560 attn-free, ssm_state=128,
expand=2 (d_inner 5120), head_dim 64 (80 heads), vocab=50280 — SSD
[arXiv:2405.21060].  O(1)-state decode -> runs long_500k.
"""

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        d_model=2560,
        n_layers=64,
        n_heads=0,
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50_280,
        segments=((("ssd",), 64),),
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        conv_width=4,
        subquadratic=True,
        train_microbatches=2,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-reduced",
        d_model=64,
        n_layers=3,
        n_heads=0,
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=512,
        segments=((("ssd",), 3),),
        ssm_state=16,
        ssm_expand=2,
        ssm_head_dim=16,
        conv_width=4,
        subquadratic=True,
        dtype=torch.float32,  # CPU smoke tests execute; f32 avoids CPU bf16-dot gaps
        remat_policy="none",
    )
