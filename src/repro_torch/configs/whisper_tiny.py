"""whisper-tiny [audio]: enc-dec, 4+4L d_model=384 6H d_ff=1536
vocab=51865, conv frontend STUB (input_specs supplies frame embeddings)
[arXiv:2212.04356].

Pure full attention -> long_500k skipped. Vocab padded 51865 -> 51968 for
16-way shardability (DESIGN.md §4.1).
"""

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        d_model=384,
        n_layers=4,  # decoder layers
        n_encoder_layers=4,
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51_865,
        segments=((("attn+mlp",), 4),),  # decoder structure (used for caches)
        mlp_type="gelu",
        learned_pos=True,
        max_pos=32_768,
        frontend="audio",
        train_microbatches=1,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-reduced",
        d_model=64,
        n_layers=2,
        n_encoder_layers=2,
        n_heads=2,
        n_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab_size=512,
        segments=((("attn+mlp",), 2),),
        mlp_type="gelu",
        learned_pos=True,
        max_pos=128,
        frontend="audio",
        dtype=torch.float32,  # CPU smoke tests execute; f32 avoids CPU bf16-dot gaps
        remat_policy="none",
    )
