"""Assigned-architecture model zoo (PyTorch port of ``repro.models``).

Pure functions over parameter trees with the JAX package's layout;
:class:`~repro_torch.models.module.DecoderLM` holds a tree as an
``nn.Module``.  The dense decoders (attention + MLP blocks, VLM prefix)
run; the other block kinds raise ``NotImplementedError``.
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
