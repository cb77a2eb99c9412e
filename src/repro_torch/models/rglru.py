"""RG-LRU recurrent block (RecurrentGemma / Griffin).

The port of ``repro/models/rglru.py``.  Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = exp(c * r_t * log(sigmoid(Lambda)))   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block is: linear in -> causal conv (width 4) -> RG-LRU -> linear out,
gated by a parallel GeLU branch (Griffin's recurrent block; the tanh GeLU,
``jax.nn.gelu``'s default).  The linear recurrence h_t = a_t h_{t-1} + b_t
is a log-depth (Hillis-Steele) doubling scan in float32 with the JAX
module's ``combine``: ceil(log2 S) element-wise passes, where
``jax.lax.associative_scan`` sums in a tree of another order.  Decode
carries [B, W] state and writes it into the cache in place.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.context import pointwise

from .common import ModelConfig, dense_init, linear
from .ssm import _causal_conv

__all__ = ["rglru_init", "rglru_apply", "rglru_decode", "init_rglru_cache"]

_C = 8.0


def rglru_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    return {
        "w_x": dense_init(gen, (d, w), cfg.dtype),  # recurrent branch in
        "w_gate": dense_init(gen, (d, w), cfg.dtype),  # gelu gate branch
        "conv": dense_init(gen, (cfg.conv_width, w), cfg.dtype, scale=0.5),
        "w_a": dense_init(gen, (w, w), cfg.dtype),
        "b_a": torch.zeros((w,), dtype=torch.float32),
        "w_i": dense_init(gen, (w, w), cfg.dtype),
        "b_i": torch.zeros((w,), dtype=torch.float32),
        # Lambda init so that a ~ uniform(0.9, 0.999) at r = 0.5 (Griffin)
        "lam": torch.linspace(2.0, 6.0, w, dtype=torch.float32),
        "w_out": dense_init(gen, (w, d), cfg.dtype),
    }


def _gates(params, x):
    """x: [..., w] (post conv). Returns (a, b) of the recurrence, float32."""
    r = torch.sigmoid(linear(x, params["w_a"]).float() + params["b_a"])
    i = torch.sigmoid(linear(x, params["w_i"]).float() + params["b_i"])
    log_a = _C * r * pointwise(F.logsigmoid, params["lam"])  # [..., w], negative
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * x.float())
    return a, b


def _scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 (h_0 = 0), in ceil(log2 S)
    doubling passes of ``combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2)``."""
    S = a.shape[1]
    shift = 1
    while shift < S:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift] + b[:, shift:]], dim=1)
        if shift * 2 < S:  # the last pass's products are not read
            a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return b


def rglru_apply(params, x, cfg: ModelConfig, *, initial_state=None) -> Tuple[torch.Tensor, dict]:
    """x: [B, S, D].  Returns (out, cache)."""
    xr = linear(x, params["w_x"])
    gate = F.gelu(linear(x, params["w_gate"]), approximate="tanh")
    xc, conv_state = _causal_conv(xr, params["conv"])
    a, b = _gates(params, xc)  # [B,S,w] f32
    if initial_state is not None:
        # fold h0 into the first step: h_1 = a_1 h_0 + b_1
        b = torch.cat([(b[:, 0] + a[:, 0] * initial_state)[:, None], b[:, 1:]], dim=1)
    h = _scan(a, b)
    out = h.to(x.dtype) * gate
    out = linear(out, params["w_out"])
    return out, {"h": h[:, -1], "conv": conv_state}


def init_rglru_cache(cfg: ModelConfig, batch: int):
    """The state of one RG-LRU layer, on the default device."""
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=cfg.dtype),
    }


def rglru_decode(params, x, cache, cfg: ModelConfig):
    """One-token step. x: [B, 1, D].

    Writes the new state and conv tail into ``cache`` in place (the JAX
    module returns them as a new cache) and returns ``(out, cache)``."""
    xr = linear(x, params["w_x"])
    gate = F.gelu(linear(x, params["w_gate"]), approximate="tanh")
    xc, conv_state = _causal_conv(xr, params["conv"], state=cache["conv"])
    a, b = _gates(params, xc[:, 0])
    h = a * cache["h"] + b
    out = h[:, None].to(x.dtype) * gate
    out = linear(out, params["w_out"])
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return out, cache
