"""Logical->physical placement rules for the production meshes.

The port of ``repro/sharding/rules.py``.  Posture: **no head-divisibility
assumptions anywhere**.

* Parameters: ZeRO/FSDP-style — 2-D+ weights shard their input dim over
  `data` and output dim over `model` when divisible (both checked per leaf);
  embedding/lm-head shard the vocab dim over `model`; norms/biases/scalars
  replicate.  Optimizer state inherits the parameter specs.
* Batches: batch dim over (`pod`, `data`) when divisible (long_500k has
  batch 1 — replicated), sequence unsharded at input.
* Caches: latent sequence dim over `model`; SSM state heads and conv
  channels over `model`; batch over dp axes when divisible.

A spec is a plain tuple with one entry per dim, each ``None``, an axis name
or a tuple of names: what ``tuple(jax.sharding.PartitionSpec(...))`` holds.
Trees are the port's nested dicts and lists, so a tuple in a tree is a spec.
:func:`named` turns specs into DTensor placements over a ``DeviceMesh``.

A mesh is a ``DeviceMesh`` (its ``shape`` is a plain tuple, read by
``mesh_dim_names``) or any object whose ``shape`` maps axis names to sizes.

The rules match substrings of each leaf's path in JAX's string form
(``['segments']/[1]/['pos0']/['k']``: a dict key as ``[repr(key)]``, a list
index as ``[i]``), as the JAX module does.  So the checks that end in a key
name (``endswith("k")``, ``"v"``, ``"h"``) never match a dict key, and the
KV cache's sequence dim and the RG-LRU state stay off `model`: the JAX
module's placement, copied as it is.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np

from repro_torch.models.common import ModelConfig

__all__ = [
    "dp_axes",
    "param_specs",
    "batch_specs",
    "cache_specs",
    "named",
]


def _axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of ``mesh``, in the mesh's order."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    if mesh.mesh_dim_names is None:
        raise ValueError("the mesh's dims need names (init_device_mesh(..., mesh_dim_names=...))")
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    sizes = _axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in axes])) if axes else 1


def _spec(*entries) -> tuple:
    """``tuple(PartitionSpec(*entries))``: a one-name tuple entry becomes the
    name, an empty one ``None``."""
    return tuple(
        (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple) else e for e in entries
    )


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over the leaves of a tree of dicts and lists,
    keeping its structure; ``path`` is JAX's string form of the leaf's."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/[{k!r}]" if path else f"[{k!r}]")
                for k, v in tree.items()}  # fmt: skip
    if isinstance(tree, list):
        return [_map_with_path(fn, v, f"{path}/[{i}]" if path else f"[{i}]")
                for i, v in enumerate(tree)]  # fmt: skip
    return fn(path, tree)


def named(mesh, tree):
    """Spec tree -> tree of DTensor placement lists over ``mesh`` (a
    ``DeviceMesh``): for each mesh dim, ``Shard(d)`` where entry ``d`` of
    the spec names it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names

    def placements(spec):
        out = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            for ax in (entry,) if isinstance(entry, str) else entry or ():
                out[names.index(ax)] = Shard(d)
        return out

    def walk(t):
        if isinstance(t, tuple):
            return placements(t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        raise TypeError(f"not a spec tree: {t!r:.200}")

    return walk(tree)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _weight_spec(shape, mesh, path_str: str, cfg: ModelConfig, *, mode: str = "train") -> tuple:
    """Spec for one parameter leaf (shape may include a leading group dim).

    mode='train': ZeRO/FSDP posture — input dim over `data`, output over
    `model` (optimizer state forces the spread).
    mode='serve': weights replicate over `data` (no optimizer state; decode
    would otherwise all-gather every layer's weights every token).
    """
    sizes = _axis_sizes(mesh)
    model_n = sizes.get("model", 1)
    data_n = sizes.get("data", 1) if mode == "train" else 10**9  # never divides
    dims = list(shape)
    lead = []
    if "segments" in path_str or "_layers" in path_str:
        lead = [None]  # stacked group axis stays unsharded
        dims = dims[1:]
    if len(dims) <= 1:  # norms, biases, scalars
        return (*lead, *([None] * len(dims)))
    # embedding tables / positional tables / heads: vocab over 'model'
    if any(k in path_str for k in ("embed", "lm_head", "enc_pos", "dec_pos")):
        if "lm_head" in path_str:  # [D, V]
            spec = [None, "model" if dims[1] % model_n == 0 else None]
        else:  # [V, D]
            spec = ["model" if dims[0] % model_n == 0 else None, None]
        return (*lead, *spec)
    if "router" in path_str:
        return (*lead, *([None] * len(dims)))
    if "conv" in path_str:  # [W, C]: channel over model
        return (*lead, None, "model" if dims[1] % model_n == 0 else None)
    if len(dims) == 3:  # stacked experts [E, in, out]
        if cfg.moe_shard_experts and dims[0] % model_n == 0:
            return (*lead, "model", "data" if dims[1] % data_n == 0 else None, None)
        return (
            *lead,
            None,
            "data" if dims[1] % data_n == 0 else None,
            "model" if dims[2] % model_n == 0 else None,
        )
    # generic 2-D weight [in, out]: FSDP over data, TP over model
    return (
        *lead,
        "data" if dims[0] % data_n == 0 else None,
        "model" if dims[1] % model_n == 0 else None,
    )


def param_specs(cfg: ModelConfig, params_shape, mesh, *, mode: str = "train"):
    """Spec tree matching ``params_shape`` (tensors, e.g. on the meta device)."""
    return _map_with_path(
        lambda path, leaf: _weight_spec(leaf.shape, mesh, path, cfg, mode=mode), params_shape
    )


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


def _batch_axis(mesh, batch: int):
    axes = dp_axes(mesh)
    if axes and batch % _axis_size(mesh, axes) == 0:
        return axes
    # try intra-pod data only
    sizes = _axis_sizes(mesh)
    if "data" in sizes and batch % sizes["data"] == 0:
        return ("data",)
    return None


def batch_specs(cfg: ModelConfig, mesh, batch: int, *, kind: str) -> Dict[str, tuple]:
    """Specs for the input batch dict of ``kind`` in {train, prefill, decode}."""
    b = _batch_axis(mesh, batch)
    if kind in ("train", "prefill"):
        specs: Dict[str, tuple] = {"tokens": _spec(b, None), "labels": _spec(b, None)}
        if cfg.frontend == "vision":
            specs["prefix"] = _spec(b, None, None)
        if cfg.is_encoder_decoder:
            specs["frames"] = _spec(b, None, None)
        if kind == "prefill":
            specs.pop("labels", None)
        return specs
    if kind == "decode":
        return {"token": _spec(b, None), "cache_len": ()}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, caches_shape, mesh, batch: int):
    """Shard cache leaves: seq dim over 'model', batch over dp axes."""
    b = _batch_axis(mesh, batch)
    model_n = _axis_sizes(mesh).get("model", 1)

    def spec_for(path_str, leaf) -> tuple:
        # every cache leaf is [n_groups/L, B, ...] (stacked)
        shape = leaf.shape
        lead = [None]
        dims = list(shape[1:])
        spec = [b]  # batch dim
        rest = dims[1:]
        if "ckv" in path_str or path_str.endswith("k") or path_str.endswith("v"):
            # [B, L, ...]: shard L over model when divisible
            if rest and rest[0] % model_n == 0:
                spec.append("model")
                rest = rest[1:]
        elif "ssm" in path_str:
            # [B, nh, hd, ns]: shard heads over model when divisible
            if rest and rest[0] % model_n == 0:
                spec.append("model")
                rest = rest[1:]
        elif path_str.endswith("h"):
            # rglru [B, w]
            if rest and rest[0] % model_n == 0:
                spec.append("model")
                rest = rest[1:]
        elif "conv" in path_str:
            # [B, W-1, C]: shard channels
            if len(rest) == 2 and rest[1] % model_n == 0:
                spec.extend([None, "model"])
                rest = []
        spec.extend([None] * len(rest))
        return _spec(*lead, *spec)

    return _map_with_path(spec_for, caches_shape)
