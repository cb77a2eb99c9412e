"""deepseek-v2-236b [moe]: 60L d_model=5120 128H, MLA kv_lora=512,
160 routed experts top-6 + 2 shared, expert d_ff=1536, vocab=102400
[arXiv:2405.04434].

First layer is dense (d_ff 12288); remaining 59 are MoE.  160 % 16 == 0 ->
true expert parallelism over the model axis (XLA all_to_all dispatch).
MLA decode uses the absorbed formulation (latent-space attention).
"""

import torch

from repro_torch.models.common import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        d_model=5120,
        n_layers=60,
        n_heads=128,
        n_kv_heads=128,  # MLA: full MHA over latent (spec lists kv=128)
        head_dim=128,
        d_ff=12288,  # the dense first layer
        vocab_size=102_400,
        segments=(
            (("mla+mlp",), 1),
            (("mla+moe",), 59),
        ),
        n_experts=160,
        n_shared_experts=2,
        top_k=6,
        moe_d_ff=1536,
        moe_shard_experts=True,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        rope_theta=1e4,
        mlp_type="swiglu",
        train_microbatches=4,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-reduced",
        d_model=64,
        n_layers=3,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=256,
        vocab_size=512,
        segments=(
            (("mla+mlp",), 1),
            (("mla+moe",), 2),
        ),
        n_experts=8,
        n_shared_experts=2,
        top_k=2,
        moe_d_ff=64,
        kv_lora_rank=32,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
        capacity_factor=8.0,  # no token drops in the smoke configs
        mlp_type="swiglu",
        dtype=torch.float32,  # CPU smoke tests execute; f32 avoids CPU bf16-dot gaps
        remat_policy="none",
    )
