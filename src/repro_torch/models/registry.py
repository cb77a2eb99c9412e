"""Model facade: one entry point per model kind, dispatched from the config.

The port of ``repro/models/registry.py``.  The decoder LM (dense, MoE,
MLA) and the VLM-prefixed LM run; the encoder-decoder kind raises
``NotImplementedError`` until ``models/encdec.py`` is ported.  The train
layer talks only to these functions + `init_params_shape`.

Batch schema (the JAX package's):
  LM     : {tokens [B,S] int, labels [B,S] int}
  VLM    : + prefix [B,P,D]       (stub frontend output)
  decode : {token [B,1] int, cache_len int} + caches tree

Parameters and caches are created on ``device`` — ``cuda`` unless the
caller asks for ``cpu`` (no fallback: without a CUDA device the default
raises).
"""

from __future__ import annotations

from typing import Any, Dict, Union

import torch

from repro_torch.engines.base import resolve_device

from . import transformer
from .common import ModelConfig

__all__ = [
    "model_init",
    "model_forward",
    "model_prefill",
    "model_decode",
    "model_caches",
    "init_params_shape",
]


def _no_encdec(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder kind is not ported to PyTorch yet "
            "(models/encdec.py, ROADMAP.md section 1, item 6)"
        )


def model_init(key: Union[int, torch.Generator], cfg: ModelConfig, *, device="cuda"):
    """Parameters on ``device``, drawn from ``key``: a seed, or a
    ``torch.Generator`` on that device."""
    _no_encdec(cfg)
    dev = resolve_device(device)
    gen = key
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(key))
    with dev:
        return transformer.init_params(gen, cfg)


def init_params_shape(cfg: ModelConfig):
    """The parameter tree on the meta device: shapes and dtypes, no storage."""
    _no_encdec(cfg)
    with torch.device("meta"):
        return transformer.init_params(torch.Generator(), cfg)


def model_forward(params, batch: Dict[str, Any], cfg: ModelConfig):
    """Teacher-forced logits over the *label-aligned* region + aux loss."""
    _no_encdec(cfg)
    prefix = batch.get("prefix")
    logits, aux = transformer.forward(params, batch["tokens"], cfg, prefix_embeds=prefix)
    if prefix is not None:
        logits = logits[:, prefix.shape[1] :]  # labels align with tokens
    return logits, aux


def model_prefill(params, batch: Dict[str, Any], cfg: ModelConfig):
    _no_encdec(cfg)
    return transformer.prefill(params, batch["tokens"], cfg, prefix_embeds=batch.get("prefix"))


def model_caches(cfg: ModelConfig, batch: int, max_len: int, *, enc_len: int = 0, device="cuda"):
    """Zero caches on ``device``; ``enc_len`` is the encoder-decoder kind's."""
    _no_encdec(cfg)
    with resolve_device(device):
        return transformer.init_caches(cfg, batch, max_len)


def model_decode(params, token, caches, cache_len, cfg: ModelConfig):
    """One token against ``caches``, which are updated in place."""
    _no_encdec(cfg)
    return transformer.decode_step(params, token, caches, cache_len, cfg)
