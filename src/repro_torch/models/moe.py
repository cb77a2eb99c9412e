"""Mixture-of-Experts: sort-based capacity dispatch + grouped products.

The port of ``repro/models/moe.py``'s single-device path.  No [T, E, C]
GShard dispatch tensor:

  1. router top-k -> (expert, weight) per (token, k) slot;
  2. a stable sort of the T*k assignments by expert id;
  3. scatter into a dense [E, C, D] buffer (capacity
     C = int(T*k/E * cf) + 1, overflow dropped — "token dropping");
  4. grouped expert products [E,C,D] x [E,D,F];
  5. gather back + combine with the router weights.

Shared experts (DeepSeek) are a plain dense MLP added to the MoE output.

The JAX module's expert-parallel dispatch (``_moe_ep``: ``shard_map`` with
an ``all_to_all`` each way) runs only under a published mesh rule; the
port has no ``sharding/`` yet, so :func:`moe_apply` always takes the
capacity path, as the JAX function does without that rule.

Three orders are the JAX module's, because the result depends on them:
top-k breaks ties towards the lower expert id (``lax.top_k``; a stable
descending sort here), the dispatch sort is stable (``jnp.argsort``), so
which assignments fit under the capacity is the same, and the combine adds
each token's rows in that sorted order, from zero — the order of the JAX
float32 scatter-add, and deterministic on the card (no atomics).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, dense_init

__all__ = ["moe_init", "moe_apply"]


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    split = cfg.moe_virtual_split
    ev, fv = e * split, f // split
    p = {
        "router": dense_init(gen, (d, e), torch.float32),
        "experts": {
            # gated (swiglu) expert FFNs, stacked on the (virtual) expert dim
            "w_in": dense_init(gen, (ev, d, 2 * fv), cfg.dtype),
            "w_out": dense_init(gen, (ev, fv, d), cfg.dtype),
        },
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {
            "w_in": dense_init(gen, (d, 2 * fs), cfg.dtype),
            "w_out": dense_init(gen, (fs, d), cfg.dtype),
        }
    return p


def moe_apply(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D]. Returns (out [B,S,D], aux_loss [])."""
    return _moe_dense(params, x, cfg)


def _top_k(probs, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (``torch.topk`` gives no such order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(params, xt, cfg: ModelConfig):
    """Shared routing: top-k over real experts, fanned out to the virtual
    splits.  Returns (idx_v [T, K*split], gate_v, aux)."""
    E, K, split = cfg.n_experts, cfg.top_k, cfg.moe_virtual_split
    T = xt.shape[0]
    # full float32 products: the port leaves PyTorch's default, TF32 off,
    # so near-ties pick the same experts on the card as on the CPU
    logits = xt.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate, idx = _top_k(probs, K)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    me = probs.mean(0)
    ce = torch.bincount(idx.reshape(-1), minlength=E).float() / (T * K)
    aux = E * torch.sum(me * ce)
    if split > 1:
        fan = torch.arange(split, device=idx.device)
        idx = (idx[..., None] * split + fan).reshape(T, K * split)
        gate = torch.repeat_interleave(gate, split, dim=-1)
    return idx, gate, aux


def _dispatch(idx, T: int, E: int, cap: int):
    """The stable sort by expert: (order, token of each sorted row, kept,
    slot in the flat [E*cap] buffer; E*cap where dropped)."""
    K = idx.shape[1]
    dev = idx.device
    flat_e = idx.reshape(-1)  # [T*K]
    order = torch.argsort(flat_e, stable=True)  # groups by expert
    se = flat_e[order]
    st = torch.div(order, K, rounding_mode="floor")  # = arange(T).repeat(K)[order]
    # rank within expert = position - segment start
    seg_start = torch.searchsorted(se, torch.arange(E, device=dev, dtype=se.dtype))
    rank = torch.arange(T * K, device=dev) - seg_start[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, E * cap)  # E*cap -> dropped
    return order, st, keep, slot


def _moe_dense(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x.shape
    split = cfg.moe_virtual_split
    E = cfg.n_experts * split
    K = cfg.top_k * split
    T = B * S
    xt = x.reshape(T, D)
    idx, gate, aux = _route(params, xt, cfg)

    # ---- sort-based dispatch -------------------------------------------------
    cap = int((T * K / max(E, 1)) * cfg.capacity_factor) + 1
    order, st, keep, slot = _dispatch(idx, T, E, cap)
    sg = gate.reshape(-1)[order]
    # one spare row takes the dropped assignments (``mode="drop"``) and is
    # cut off
    xe = torch.zeros((E * cap + 1, D), dtype=cfg.dtype, device=x.device)
    xe = xe.index_put((slot,), xt[st].to(cfg.dtype))
    xe = xe[: E * cap].reshape(E, cap, D)

    # ---- grouped expert FFN ----------------------------------------------------
    h = torch.bmm(xe, params["experts"]["w_in"])
    g, u = h.chunk(2, dim=-1)
    h = F.silu(g) * u
    ye = torch.bmm(h, params["experts"]["w_out"])

    # ---- combine ---------------------------------------------------------------
    ye_flat = ye.reshape(E * cap, D)
    gathered = ye_flat[torch.clamp_max(slot, E * cap - 1)]
    gathered = torch.where(keep[:, None], gathered, 0)
    rows = gathered.float() * sg[:, None]
    # each token's K rows, in the sorted order (a stable sort by token)
    rows = rows[torch.argsort(st, stable=True)].reshape(T, K, D)
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for k in range(K):
        out = out + rows[:, k]
    out = out.to(x.dtype).reshape(B, S, D)

    if "shared" in params:
        out = out + _shared_mlp(params["shared"], x)
    return out, aux


def _shared_mlp(p, x):
    hs = x @ p["w_in"]
    g, u = hs.chunk(2, dim=-1)
    return (F.silu(g) * u) @ p["w_out"]
