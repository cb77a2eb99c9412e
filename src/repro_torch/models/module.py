"""The registry's models as an ``nn.Module``.

:class:`DecoderLM` holds a parameter tree of :func:`model_init` (or of
:func:`repro_torch.convert.lm_params_from_arrays`) as the module's
parameters, so ``state_dict``, ``.to(...)`` and ``parameters()`` work as
for any PyTorch model, and calls the registry's functions on it.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from .common import ModelConfig
from .registry import model_caches, model_decode, model_forward, model_init, model_prefill

__all__ = ["DecoderLM"]


class _Node(nn.Module):
    """One dict of the tree: tensors as parameters, sub-trees as children."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, sub in tree.items():
            if isinstance(sub, torch.Tensor):
                self.register_parameter(name, nn.Parameter(sub, requires_grad=False))
            else:
                self.add_module(name, _wrap(sub))


def _wrap(tree):
    if isinstance(tree, dict):
        return _Node(tree)
    return nn.ModuleList([_wrap(sub) for sub in tree])


def _unwrap(mod):
    if isinstance(mod, nn.ModuleList):
        return [_unwrap(sub) for sub in mod]
    out = dict(mod.named_parameters(recurse=False))
    out.update((name, _unwrap(sub)) for name, sub in mod.named_children())
    return out


class DecoderLM(nn.Module):
    """A model of any kind the registry runs (a decoder LM with attention,
    MLA, SSD or RG-LRU blocks, dense or MoE, with or without a VLM prefix;
    or an encoder-decoder) over ``params``."""

    def __init__(self, params: dict, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.tree = _wrap(params)

    @classmethod
    def init(cls, key, cfg: ModelConfig, *, device="cuda") -> "DecoderLM":
        return cls(model_init(key, cfg, device=device), cfg)

    def params(self) -> dict:
        """The parameter tree, in the registry's layout."""
        return _unwrap(self.tree)

    def forward(self, batch: Dict[str, Any]):
        return model_forward(self.params(), batch, self.cfg)

    def prefill(self, batch: Dict[str, Any]):
        return model_prefill(self.params(), batch, self.cfg)

    def caches(self, batch: int, max_len: int, *, enc_len: int = 0):
        return model_caches(
            self.cfg, batch, max_len, enc_len=enc_len, device=self.tree.embed.device
        )

    def decode(self, token, caches, cache_len):
        return model_decode(self.params(), token, caches, cache_len, self.cfg)
