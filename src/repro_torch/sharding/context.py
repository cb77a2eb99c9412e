"""Ambient activation-placement rules.

The port of ``repro/sharding/context.py``.  The model code is
mesh-agnostic; a launcher publishes a ``{key -> spec}`` dict here and the
model may call ``constrain(x, key)`` at the few points that matter.  The
port's models leave those calls out: on the plain tensors they run on,
``constrain`` is the identity.

Keys of the JAX package's models:
  residual   — [B, S, D] embedding output / layer-scan carry
  logits     — [B, S, vocab_padded]
and the raw entries ``models/moe.py`` reads through :func:`get_rule`:
``moe_ep_axis``, ``moe_dp_axes`` and ``mesh`` (the expert-parallel
dispatch).
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from typing import Dict, Optional

__all__ = ["activation_rules", "constrain", "default_rules"]

_RULES: contextvars.ContextVar[Optional[Dict[str, object]]] = contextvars.ContextVar(
    "activation_rules", default=None
)


@contextmanager
def activation_rules(rules: Optional[Dict[str, object]]):
    token = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(token)


def constrain(x, key: str):
    """``x`` placed by the rule for ``key``: the identity where no rule is
    published and on a plain tensor; a DTensor is redistributed over its
    own mesh to the rule's placements (:func:`rules.named`).  A rule naming
    an axis the mesh lacks leaves ``x`` as it is, as the JAX function
    does when its constraint fails."""
    from torch.distributed.tensor import DTensor

    rules = _RULES.get()
    if not rules or key not in rules or not isinstance(x, DTensor):
        return x
    from .rules import named

    try:
        placements = named(x.device_mesh, rules[key])
    except ValueError:  # an axis name the mesh does not have
        return x
    return x.redistribute(x.device_mesh, placements)


def get_rule(key: str, default=None):
    """Raw access to a published rule (non-spec entries allowed)."""
    rules = _RULES.get()
    if not rules:
        return default
    return rules.get(key, default)


def default_rules(mesh, batch: int, seq: int, d_model: int):
    """Sequence-sharded residuals when divisible; batch over dp axes."""
    from .rules import _axis_size, _axis_sizes, _spec, dp_axes

    dp = dp_axes(mesh)
    dp_n = _axis_size(mesh, dp)
    b_ax = dp if (dp and batch % dp_n == 0) else None
    model_n = _axis_sizes(mesh).get("model", 1)
    s_ax = "model" if seq % model_n == 0 else None
    return {
        "residual": _spec(b_ax, s_ax, None),
        "logits": _spec(b_ax, s_ax, None),
        # expert-parallel MoE dispatch (moe.py reads these raw entries)
        "moe_ep_axis": "model" if model_n > 1 else None,
        "moe_dp_axes": b_ax,
        "mesh": mesh,
    }
