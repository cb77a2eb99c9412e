"""Placement rules for the production meshes (PyTorch port of ``repro.sharding``)."""

from .rules import batch_specs, cache_specs, dp_axes, named, param_specs

__all__ = ["batch_specs", "cache_specs", "dp_axes", "named", "param_specs"]
