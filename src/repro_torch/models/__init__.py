"""Assigned-architecture model zoo (PyTorch port of ``repro.models``).

Pure functions over parameter trees with the JAX package's layout;
:class:`~repro_torch.models.module.DecoderLM` holds a tree as an
``nn.Module``.  Every kind of the JAX package runs: decoders with
attention, sliding-window, latent (MLA), SSD (mamba2) or RG-LRU blocks and
dense or MoE MLPs, VLM prefix included, and the encoder-decoder (whisper).
"""

from .common import ModelConfig, padded_vocab
from .registry import (
    init_params_shape,
    model_caches,
    model_decode,
    model_forward,
    model_init,
    model_prefill,
)

__all__ = [
    "ModelConfig", "padded_vocab", "init_params_shape", "model_caches",
    "model_decode", "model_forward", "model_init", "model_prefill",
]  # fmt: skip
