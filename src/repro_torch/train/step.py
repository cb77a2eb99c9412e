"""Serve step factories (the port of ``repro/train/step.py``'s serving half).

``make_prefill_step`` / ``make_decode_step`` are the serving twins: prefill
a batch of prompts into caches, then one greedy token per call against
them.  ``make_loss_fn`` and ``make_train_step`` come with the training
slice.
"""

from __future__ import annotations

import torch

from repro_torch.models import model_decode, model_prefill
from repro_torch.models.common import ModelConfig

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        logits, caches = model_prefill(params, batch, cfg)
        return logits, caches

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """Greedy decoding: the next token is the ``argmax`` of the logits, as in
    the JAX package, whose ``sample`` flag no caller sets (it takes the
    ``argmax`` either way).  The step updates ``caches`` in place."""

    def decode_step(params, batch, caches):
        logits, new_caches = model_decode(
            params, batch["token"], caches, batch["cache_len"], cfg
        )
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, new_caches

    return decode_step
