"""Ambient activation-placement rules.

The port of ``repro/sharding/context.py``.  The model code is
mesh-agnostic; a launcher publishes a ``{key -> spec}`` dict here and the
model calls ``constrain(x, key)`` at the few points that matter: the
identity on a plain tensor, a ``redistribute`` on a DTensor.

Where a model function takes DTensors but computes on each rank's shard
(the flash loop, the cache writes, the expert-parallel dispatch: the
counterparts of JAX's ``shard_map``), it places its inputs with
:func:`local_shard` and its result with :func:`from_shards`.

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

import numpy as np
import torch

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
    rules = _RULES.get()
    if not rules or key not in rules or not is_dtensor(x):
        return x
    from .rules import named

    try:
        placements = named(x.device_mesh, rules[key])
    except ValueError:  # an axis name the mesh does not have
        return x
    return x.redistribute(x.device_mesh, placements)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (placed over a ``DeviceMesh``)."""
    if type(x) is torch.Tensor:  # the plain path, without the import
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local_shard(x, placements, grad_placements=None):
    """This rank's shard of the DTensor ``x`` redistributed to
    ``placements``; its gradient comes back as ``grad_placements`` (the
    same placements when ``None``; ``Partial()`` where ranks that hold the
    same values use them for different outputs)."""
    if list(x.placements) != list(placements):
        x = x.redistribute(x.device_mesh, placements)
    return x.to_local(grad_placements=grad_placements)


def gathered(x, dim: int):
    """``x`` whole along dim ``dim``: a DTensor split along it is gathered
    (``Replicate`` on the mesh dims that split it); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    dim %= x.ndim
    places = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    return x if places == list(x.placements) else x.redistribute(x.device_mesh, places)


def pointwise(fn, x):
    """``fn``, an element-wise function, of ``x``: of each rank's shard of a
    DTensor (for an op DTensor has no rule for), of anything else as it is."""
    if not is_dtensor(x):
        return fn(x)
    x = reduced(x)
    return from_shards(fn(x.to_local()), x.device_mesh, x.placements, x.shape)


def aligned(x, ref):
    """``x`` placed as DTensor ``ref`` along the dims they share (``ref``'s
    splits of dims past ``x``'s last are dropped): a slice where ``x`` is
    whole, so the two meet shard to shard."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    places = [p if p.is_shard() and p.dim < x.ndim else Replicate() for p in ref.placements]
    return x if list(x.placements) == places else x.redistribute(mesh, places)


def last_row(x, dim: int):
    """``x.select(dim, -1)``.  A DTensor split evenly along ``dim`` gathers
    each shard's last row, not the whole dim, and selects the last."""
    if not is_dtensor(x):
        return x.select(dim, -1)
    mesh, places = x.device_mesh, list(x.placements)
    n = int(np.prod([mesh.size(i) for i, p in enumerate(places) if p.is_shard(dim)]))
    if n == 1 or x.shape[dim] % n:
        return x.select(dim, -1)
    local = x.to_local()
    shape = list(x.shape)
    shape[dim] = n
    last = local.narrow(dim, local.shape[dim] - 1, 1)
    return from_shards(last, mesh, places, shape).select(dim, -1)


def unbound(x):
    """``x.unbind(0)``: of a DTensor, each rank unbinds its shard (dim 0
    must not be split), so the other dims keep their split."""
    if not is_dtensor(x):
        return x.unbind(0)
    from torch.distributed.tensor import Shard

    if any(p.is_shard(0) for p in x.placements):
        raise ValueError(f"cannot unbind a dim that is split: {x.placements}")
    places = [Shard(p.dim - 1) if p.is_shard() else p for p in x.placements]
    return tuple(from_shards(t, x.device_mesh, places, x.shape[1:]) for t in x.to_local().unbind(0))


def write_at(x, dim: int, index: int, value) -> None:
    """``x.select(dim, index).copy_(value)`` in place; of a DTensor ``x``,
    the rank whose shard holds ``index`` writes its part of ``value``."""
    if not is_dtensor(x):
        x.select(dim, index).copy_(value)
        return
    from torch.distributed.tensor import Replicate, Shard

    places = [Replicate() if p.is_shard(dim) else Shard(p.dim - (p.dim > dim)) if p.is_shard()
              else p for p in x.placements]  # fmt: skip
    part = local_shard(value, places)
    local = x.to_local()
    at = index - shard_offset(x.shape[dim], x.device_mesh, x.placements, dim)
    if 0 <= at < local.shape[dim]:
        local.select(dim, at).copy_(part)


def reduced(x):
    """``x`` with its pending sums taken: a DTensor's ``Partial`` mesh dims
    become ``Replicate``; anything else as it is."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    places = [Replicate() if p.is_partial() else p for p in x.placements]
    return x.redistribute(x.device_mesh, places)


def splittable(x, dim: int, outer: int):
    """``x`` ready for a view that splits dim ``dim`` into ``(outer, ...)``:
    a DTensor whose split of that dim ``outer`` does not divide is gathered
    along it first (DTensor cannot unflatten an uneven split); anything
    else as it is."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    on = [i for i, p in enumerate(x.placements) if p.is_shard(dim % x.ndim)]
    if outer % int(np.prod([mesh.size(i) for i in on])) == 0:
        return x
    return gathered(x, dim)


def shard_offset(size: int, mesh, placements, dim: int) -> int:
    """The global index of this rank's first element along dim ``dim`` of
    size ``size`` placed as ``placements`` (``torch.chunk``'s split, mesh
    dims in order)."""
    coord = mesh.get_coordinate()
    offset = 0
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            chunk = -(-size // mesh.size(i))
            offset += coord[i] * chunk
            size = max(min(chunk, size - coord[i] * chunk), 0)
    return offset


def sharded_linear(x, w):
    """``x @ w`` (x [..., D], a weight w [D, E]) on each rank's shards, for
    DTensors (a plain operand counts as replicated).  Along each mesh dim:
    where x splits its tokens (a leading dim), w is gathered (FSDP, and
    sequence parallelism over ``model``); where x splits D and w its rows,
    each rank's product is a partial sum (row-parallel); where w splits its
    columns, x is gathered and the output splits E (column-parallel).
    DTensor's own rule for the product flattens x's leading dims and, when
    two of them are split, gathers all of x."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = (w if is_dtensor(w) else x).device_mesh
    whole = [Replicate()] * mesh.ndim
    x, w = (reduced(t) if is_dtensor(t) else DTensor.from_local(t, mesh, whole, run_check=False)
            for t in (x, w))  # fmt: skip
    last = x.ndim - 1
    xp, wp, op, xg, wg = [], [], [], [], []
    for a, b in zip(x.placements, w.placements):
        if a.is_shard() and a.dim != last:
            xp.append(a), wp.append(Replicate()), op.append(a), xg.append(a), wg.append(Partial())
        elif a.is_shard(last) and b.is_shard(0):
            xp.append(a), wp.append(b), op.append(Partial()), xg.append(a), wg.append(b)
        elif b.is_shard(1):
            xp.append(Replicate()), wp.append(b), op.append(Shard(last))
            xg.append(Partial()), wg.append(b)
        else:
            for lst in (xp, wp, op, xg, wg):
                lst.append(Replicate())
    out = local_shard(x, xp, xg) @ local_shard(w, wp, wg)
    return from_shards(out, mesh, op, (*x.shape[:-1], w.shape[1]))


def from_shards(t, mesh, placements, shape):
    """The DTensor of global ``shape`` whose shard on this rank is ``t``."""
    from torch.distributed.tensor import DTensor

    stride, acc = [], 1
    for n in reversed(shape):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(t.contiguous(), mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))  # fmt: skip


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
