"""AdamW with float32 master weights, global-norm clipping, cosine schedule.

The port of ``repro/optim/adamw.py``: plain functions over parameter trees
(nested dicts and lists of tensors), with the JAX module's arithmetic in
the same order and in float32 — the schedule and the bias corrections are
float32 computations on the step tensor, the update is element-wise per
leaf, weight decay applies to every leaf, and the new parameters are the
master cast back to each parameter's dtype.

Where the JAX launcher donates ``params`` and ``opt_state`` to the jitted
step, :func:`adamw_update` writes the optimiser state (master, m, v) and
the parameters in place and returns trees that hold those same tensors:
the caller must not keep the old values through the old references.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map

__all__ = ["OptConfig", "adamw_init", "adamw_update", "lr_schedule"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(cfg: OptConfig, step):
    """The learning rate at ``step`` (an integer tensor), a float32 0-d
    tensor: linear warm-up, then a cosine down to ``min_lr_frac``."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


class AdamWState(NamedTuple):
    step: torch.Tensor
    master: Any  # fp32 copy of params
    m: Any
    v: Any


def adamw_init(params) -> AdamWState:
    """Zero moments and a float32 master that is a copy of every leaf, a
    float32 leaf included (the master never aliases a parameter)."""
    device = tree_leaves(params)[0].device
    f32 = lambda p: p.detach().to(torch.float32, copy=True)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        master=tree_map(f32, params),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: OptConfig):
    """Returns (new_params_in_model_dtype, new_state, metrics).

    ``params`` supplies the model dtypes the new parameters are cast back to
    (bf16 compute / fp32 master split).  The state's master, m and v and the
    parameters are updated in place; ``grads`` are left as they are.
    """
    g_leaves = [g.float() for g in tree_leaves(grads)]
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in g_leaves) + 1e-20)
    scale = torch.clamp_max(cfg.clip_norm / gnorm, 1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1t = 1 - cfg.b1 ** step.to(torch.float32)
    b2t = 1 - cfg.b2 ** step.to(torch.float32)

    leaves = zip(g_leaves, *map(tree_leaves, (state.m, state.v, state.master, params)))
    for g, m, v, master, p in leaves:
        # the JAX module's expression, one rounding per operation in the
        # same order:
        #   g = g * scale
        #   m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g * g
        #   p = p - lr * (m / b1t / (sqrt(v / b2t) + eps) + weight_decay * p)
        g = g * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        upd = torch.sqrt(v / b2t).add_(cfg.eps)
        upd = torch.div(m / b1t, upd, out=upd)
        upd.add_(cfg.weight_decay * master)
        master.sub_(upd.mul_(lr))
        del upd
        p.copy_(master)
    return (
        params,
        AdamWState(step=step, master=state.master, m=state.m, v=state.v),
        {"grad_norm": gnorm, "lr": lr},
    )
