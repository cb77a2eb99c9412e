"""Assigned-architecture model zoo (PyTorch port of ``repro.models``).

Pure functions over parameter trees with the JAX package's layout;
:class:`~repro_torch.models.module.DecoderLM` holds a tree as an
``nn.Module``.  The decoders with attention, sliding-window or latent
(MLA) attention blocks and dense or MoE MLPs run, VLM prefix included; the
SSD and RG-LRU block kinds and the encoder-decoder kind raise
``NotImplementedError``.
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
