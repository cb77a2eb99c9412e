"""Model facade: one entry point per model kind, dispatched from the config.

The port of ``repro/models/registry.py``: one entry point per model kind
(decoder LM, VLM-prefixed LM, encoder-decoder).  The train layer talks
only to these functions + `init_params_shape`.

Batch schema (the JAX package's):
  LM     : {tokens [B,S] int, labels [B,S] int}
  VLM    : + prefix [B,P,D]       (stub frontend output)
  audio  : {frames [B,Se,D], tokens [B,Sd] int, labels [B,Sd] int}
  decode : {token [B,1] int, cache_len int} + caches tree

Parameters and caches are created on ``device`` — ``cuda`` unless the
caller asks for ``cpu`` (no fallback: without a CUDA device the default
raises).
"""

from __future__ import annotations

from typing import Any, Dict, Union

import torch

from repro_torch.engines.base import resolve_device

from . import encdec, transformer
from .common import ModelConfig

__all__ = [
    "model_init",
    "model_forward",
    "model_prefill",
    "model_decode",
    "model_caches",
    "init_params_shape",
]


def _init(gen: torch.Generator, cfg: ModelConfig):
    if cfg.is_encoder_decoder:
        return encdec.encdec_init(gen, cfg)
    return transformer.init_params(gen, cfg)


def model_init(key: Union[int, torch.Generator], cfg: ModelConfig, *, device="cuda"):
    """Parameters on ``device``, drawn from ``key``: a seed, or a
    ``torch.Generator`` on that device."""
    dev = resolve_device(device)
    gen = key
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(key))
    with dev:
        return _init(gen, cfg)


def init_params_shape(cfg: ModelConfig):
    """The parameter tree on the meta device: shapes and dtypes, no storage."""
    with torch.device("meta"):
        return _init(torch.Generator(), cfg)


def model_forward(params, batch: Dict[str, Any], cfg: ModelConfig):
    """Teacher-forced logits over the *label-aligned* region + aux loss."""
    if cfg.is_encoder_decoder:
        return encdec.encdec_forward(params, batch["frames"], batch["tokens"], cfg)
    prefix = batch.get("prefix")
    logits, aux = transformer.forward(params, batch["tokens"], cfg, prefix_embeds=prefix)
    if prefix is not None:
        logits = logits[:, prefix.shape[1] :]  # labels align with tokens
    return logits, aux


def model_prefill(params, batch: Dict[str, Any], cfg: ModelConfig):
    if cfg.is_encoder_decoder:
        return encdec.encdec_prefill(params, batch["frames"], batch["tokens"], cfg)
    return transformer.prefill(params, batch["tokens"], cfg, prefix_embeds=batch.get("prefix"))


def model_caches(cfg: ModelConfig, batch: int, max_len: int, *, enc_len: int = 0, device="cuda"):
    """Zero caches on ``device`` (``"meta"`` too: shapes and dtypes only);
    ``enc_len`` is the encoder-decoder kind's (``max_len`` when 0, as in the
    JAX package)."""
    meta = torch.device(device).type == "meta"
    with torch.device("meta") if meta else resolve_device(device):
        if cfg.is_encoder_decoder:
            return encdec.init_decoder_caches(cfg, batch, max_len, enc_len or max_len)
        return transformer.init_caches(cfg, batch, max_len)


def model_decode(params, token, caches, cache_len, cfg: ModelConfig):
    """One token against ``caches``, which are updated in place."""
    if cfg.is_encoder_decoder:
        return encdec.encdec_decode_step(params, token, caches, cache_len, cfg)
    return transformer.decode_step(params, token, caches, cache_len, cfg)
