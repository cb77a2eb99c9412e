"""Train / serve step factories (the port of ``repro/train/step.py``).

``make_train_step`` builds the ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` function: forward (+ MoE aux loss), backward, AdamW
with fp32 master, optional gradient accumulation over microbatches (one
after another — trades step latency for activation memory).  The
parameters and the optimiser state are updated in place (where the JAX
launcher donates them) and returned.

``make_prefill_step`` / ``make_decode_step`` are the serving twins: prefill
a batch of prompts into caches, then one greedy token per call against
them.
"""

from __future__ import annotations

import torch

from repro_torch.models import model_decode, model_forward, model_prefill
from repro_torch.models.common import ModelConfig, tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.sharding.context import gathered, is_dtensor

from .loss import lm_loss

__all__ = ["make_loss_fn", "make_train_step", "make_prefill_step", "make_decode_step"]

AUX_WEIGHT = 0.01  # MoE load-balance loss weight


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch):
        logits, aux = model_forward(params, batch, cfg)
        ce, n = lm_loss(logits, batch["labels"], cfg)
        loss = ce + AUX_WEIGHT * aux
        return loss, {"ce": ce, "aux": aux, "tokens": n}

    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, metrics),
    grads), the grads a tree of ``params``' layout and dtypes, nothing left
    recording.  The caller's tensors are not set to require grad."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt: OptConfig, *, microbatches: int = 1):
    loss_fn = make_loss_fn(cfg)

    def train_step(params, opt_state, batch):
        # the corpus yields numpy batches, which the JAX step's ``jit``
        # takes as they are: move them to the parameters' device (a no-op
        # for a tensor already there)
        device = tree_leaves(params)[0].device
        batch = tree_map(lambda x: torch.as_tensor(x, device=device), batch)
        if microbatches == 1:
            (loss, metrics), grads = _value_and_grad(loss_fn, params, batch)
        else:
            def split(x):
                b = x.shape[0]
                if is_dtensor(x):
                    # a view cannot move the batch's split to the rows of
                    # each microbatch: gather the batch, then split the rows
                    from torch.distributed.tensor import Shard

                    places = [Shard(p.dim + 1) if p.is_shard() else p for p in x.placements]
                    x = gathered(x, 0).reshape(microbatches, b // microbatches, *x.shape[1:])
                    return x.redistribute(x.device_mesh, places)
                return x.reshape(microbatches, b // microbatches, *x.shape[1:])

            mb = tree_map(split, batch)
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(microbatches):
                (l, metrics), g = _value_and_grad(loss_fn, params, tree_map(lambda x: x[i], mb))
                for acc, gi in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(gi.float())
                del g
                loss = loss + l
            for acc in tree_leaves(grads):
                acc.div_(microbatches)
            loss = loss / microbatches
            # the metrics are the last microbatch's, as the JAX scan's ``x[-1]``
        new_params, new_opt, om = adamw_update(grads, opt_state, params, opt)
        metrics = dict(metrics, loss=loss, **om)
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        logits, caches = model_prefill(params, batch, cfg)
        return logits, caches

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, sample: bool = False):
    """The next token is the ``argmax`` of the logits whether or not
    ``sample`` is set: both branches of the JAX package's step take it.
    The ``argmax`` runs over the vocabulary's ids only: the head's padded
    columns (``vocab_padded``) are never trained, as the loss masks them,
    and the JAX package's step can return one of them, an id that is no
    token; where the vocabulary needs no padding the two steps agree.
    The step updates ``caches`` in place."""

    def decode_step(params, batch, caches):
        logits, new_caches = model_decode(
            params, batch["token"], caches, batch["cache_len"], cfg
        )
        # DTensor's argmax cannot reduce over a split vocabulary: gather it
        real = gathered(logits, -1)[..., : cfg.vocab_size]
        next_tok = torch.argmax(real, dim=-1).to(torch.int32)
        return next_tok, logits, new_caches

    return decode_step
