"""internvl2-1b [vlm]: InternLM2 backbone 24L d_model=896 14H (GQA kv=2)
d_ff=4864 vocab=151655; InternViT frontend is a STUB — input_specs supplies
precomputed patch embeddings prepended to the token sequence
[arXiv:2404.16821].
"""

import torch

from repro_torch.models.common import ModelConfig

NUM_PATCHES = 256  # stub frontend: one image -> 256 patch embeddings


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        d_model=896,
        n_layers=24,
        n_heads=14,
        n_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab_size=151_655,
        segments=((("attn+mlp",), 24),),
        rope_theta=1e6,
        mlp_type="swiglu",
        frontend="vision",
        num_prefix=NUM_PATCHES,
        train_microbatches=2,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b-reduced",
        d_model=64,
        n_layers=2,
        n_heads=2,
        n_kv_heads=1,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        segments=((("attn+mlp",), 2),),
        mlp_type="swiglu",
        frontend="vision",
        num_prefix=8,
        dtype=torch.float32,  # CPU smoke tests execute; f32 avoids CPU bf16-dot gaps
        remat_policy="none",
    )
