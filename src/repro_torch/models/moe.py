"""Mixture-of-Experts: sort-based capacity dispatch + grouped products.

The port of ``repro/models/moe.py``.  No [T, E, C] GShard dispatch tensor:

  1. router top-k -> (expert, weight) per (token, k) slot;
  2. a stable sort of the T*k assignments by expert id;
  3. scatter into a dense [E, C, D] buffer (capacity
     C = int(T*k/E * cf) + 1, overflow dropped — "token dropping");
  4. grouped expert products [E,C,D] x [E,D,F];
  5. gather back + combine with the router weights.

Shared experts (DeepSeek) are a plain dense MLP added to the MoE output.

Dispatch rule (:func:`moe_apply`, as the JAX function): when the ambient
rules (``repro_torch.sharding.context``) publish an expert-parallel axis
``moe_ep_axis`` and a ``mesh``, and that axis's size M divides the virtual
expert count E_v, the expert-parallel path runs (``_moe_ep``); otherwise
the single-device capacity path (``_moe_dense``).  ``_moe_ep`` is the JAX
``shard_map`` body run once per rank of a ``torch.distributed`` mesh: each
rank takes its block of the tokens (batch rows over the DP axes, sequence
positions over the EP axis, each where it divides), routes them, bins them
expert-major as [E_v, C, D] under the EP capacity ``max(int(A/E_v * cf) + 1,
4)`` per shard (A = its T*k assignments; not the dense rule above), makes
one ``all_to_all_single`` each way over the EP axis around the grouped
products of its E_v/M experts, combines, and all-gathers the output so
every rank returns the whole [B, S, D].  On a (1, 1) mesh, where the two
capacities agree (at least 4), the two paths are bitwise equal.

Three orders are the JAX module's, because the result depends on them:
top-k breaks ties towards the lower expert id (``lax.top_k``; a stable
descending sort here), the dispatch sort is stable (``jnp.argsort``), so
which assignments fit under the capacity is the same, and both paths
combine each token's rows in that sorted order, from zero — the order of
the JAX float32 scatter-add (``.at[st].add``), and deterministic on the
card (no atomics).
"""

from __future__ import annotations

import warnings
from typing import Tuple

import torch
import torch.distributed as dist
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
    """x: [B, S, D]. Returns (out [B,S,D], aux_loss []).

    Dispatch implementation is chosen from the ambient rules: when an
    expert-parallel axis and a mesh are published and the virtual expert
    count divides over that axis, the ``all_to_all`` path runs; otherwise
    the single-device capacity path below.
    """
    from repro_torch.sharding.context import get_rule
    from repro_torch.sharding.rules import _axis_sizes

    ep_axis = get_rule("moe_ep_axis")
    mesh = get_rule("mesh")
    if ep_axis is not None and mesh is not None:
        M = _axis_sizes(mesh)[ep_axis]
        ev = cfg.n_experts * cfg.moe_virtual_split
        if ev % M == 0:
            return _moe_ep(params, x, cfg, mesh, ep_axis, get_rule("moe_dp_axes"))
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
    xe = _bins(xt, st, slot, E * cap, cfg.dtype).reshape(E, cap, D)

    # ---- grouped expert FFN ----------------------------------------------------
    h = torch.bmm(xe, params["experts"]["w_in"])
    g, u = h.chunk(2, dim=-1)
    h = F.silu(g) * u
    ye = torch.bmm(h, params["experts"]["w_out"])

    # ---- combine ---------------------------------------------------------------
    out = _combine(ye, slot, keep, sg, st, T, K).to(x.dtype).reshape(B, S, D)

    if "shared" in params:
        out = out + _shared_mlp(params["shared"], x)
    return out, aux


def _bins(xt, st, slot, rows: int, dtype):
    """The sorted rows of ``xt`` at their ``slot``s of a [rows, D] buffer;
    one spare row takes the dropped assignments (``mode="drop"``) and is cut
    off."""
    xe = torch.zeros((rows + 1, xt.shape[1]), dtype=dtype, device=xt.device)
    return xe.index_put((slot,), xt[st].to(dtype))[:rows]


def _combine(ye, slot, keep, sg, st, T: int, K: int):
    """[T, D] float32: each token's K expert outputs (``ye``'s rows at
    ``slot``, zero where dropped) times their gates, added in the sorted
    order, from zero."""
    D = ye.shape[-1]
    ye_flat = ye.reshape(-1, D)
    gathered = ye_flat[torch.clamp_max(slot, ye_flat.shape[0] - 1)]
    gathered = torch.where(keep[:, None], gathered, 0)
    rows = gathered.float() * sg[:, None]
    # each token's K rows, in the sorted order (a stable sort by token)
    rows = rows[torch.argsort(st, stable=True)].reshape(T, K, D)
    out = torch.zeros((T, D), dtype=torch.float32, device=ye.device)
    for k in range(K):
        out = out + rows[:, k]
    return out


def _shared_mlp(p, x):
    hs = x @ p["w_in"]
    g, u = hs.chunk(2, dim=-1)
    return (F.silu(g) * u) @ p["w_out"]


# ---------------------------------------------------------------------------
# Expert-parallel dispatch (one all_to_all_single each way)
# ---------------------------------------------------------------------------
#
# Routed tokens are bucketed by destination expert and exchanged in one
# all_to_all per direction.  Bins are EXPERT-major, [E_v, cap, D]: the
# exchange over the leading axis hands each rank exactly its experts'
# tokens in a contiguous block, so the local compute is one grouped product.
#
# The JAX function is SPMD over a global x; here every rank calls
# ``moe_apply`` with the whole [B, S, D] (the layers around it are
# replicated) and gets the whole output back.  Gradients follow the same
# view: every rank computes the same loss from the gathered output, so the
# gather's backward keeps the rank's slice of the gradient, and a tensor
# held whole on every rank (x, the router, the expert rows over the DP
# axes) gets its gradient summed over the axes whose ranks hold different
# tokens — each rank ends with the gradient of the global function.
#
# Exchanged tensors live where the backend needs them (the rule of
# ``core/distributed.py``): on the card for NCCL, in host memory for gloo.


def _exchange_device(group, dev: torch.device) -> torch.device:
    backend = str(dist.get_backend(group))
    if "nccl" in backend and dev.type == "cuda":
        return dev
    if "gloo" in backend:
        return torch.device("cpu")
    raise ValueError(f"process group backend {backend!r} cannot exchange tensors on {dev} "
                     f"(NCCL needs a CUDA device; gloo exchanges in host memory)")  # fmt: skip


def _exchange(bins, group, xdev: torch.device):
    """One differentiable ``all_to_all_single`` over ``group``: block i of
    dim 0 goes to rank i; the rows received are source-rank-major."""
    from torch.distributed.nn import functional as dist_nn

    src = bins.to(xdev).contiguous()
    with warnings.catch_warnings():  # the autograd-aware collective is marked deprecated
        warnings.simplefilter("ignore", FutureWarning)
        got = dist_nn.all_to_all_single(torch.empty_like(src), src, group=group)
    return got.to(bins.device)


class _SumGrad(torch.autograd.Function):
    """The identity; the backward sums the gradient over ``groups`` (one
    ``all_reduce`` each) and scales it by ``scale``."""

    @staticmethod
    def forward(ctx, t, groups, xdev, scale):
        ctx.groups, ctx.xdev, ctx.scale = groups, xdev, scale
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        buf = g.to(ctx.xdev, copy=True)
        for group in ctx.groups:
            dist.all_reduce(buf, group=group)
        g = buf.to(g.device)
        return (g * ctx.scale if ctx.scale != 1 else g), None, None, None


class _Gather(torch.autograd.Function):
    """``all_gather`` of each rank's block along ``dim`` over ``group``;
    the backward keeps this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, t, dim, group, xdev):
        ctx.dim, ctx.size = dim, t.shape[dim]
        ctx.rank = dist.get_rank(group)
        src = t.to(xdev).contiguous()
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim).to(t.device)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None, None


class _MeanOverMesh(torch.autograd.Function):
    """JAX's ``pmean`` over every mesh axis in turn (an ``all_reduce`` SUM
    over the axis's group, over its size); the backward is the cotangent
    over ``n_split``, the number of ranks whose tokens differ."""

    @staticmethod
    def forward(ctx, t, groups, xdev, n_split):
        ctx.n_split = n_split
        buf = t.to(xdev, copy=True)
        for group, n in groups:
            dist.all_reduce(buf, group=group)
            buf = buf / n
        return buf.to(t.device)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n_split, None, None, None


def _expert_rows(w, r: int, epr: int, ev: int):
    """Rank ``r``'s ``epr`` rows of an expert stack of ``ev`` rows, held
    whole (a view is taken) or already cut to them."""
    if w.shape[0] == epr:
        return w
    if w.shape[0] == ev:
        return w.narrow(0, r * epr, epr)
    raise ValueError(f"an expert stack of {w.shape[0]} rows: expected {ev}, or this "
                     f"rank's {epr}")  # fmt: skip


def _moe_ep(params, x, cfg: ModelConfig, mesh, ep_axis: str, dp_axes):
    from repro_torch.sharding.rules import _axis_size, _axis_sizes

    B, S, D = x.shape
    split = cfg.moe_virtual_split
    E_v = cfg.n_experts * split
    K_v = cfg.top_k * split
    sizes = _axis_sizes(mesh)
    M = sizes[ep_axis]
    epr = E_v // M  # (virtual) experts per rank
    r = mesh.get_local_rank(ep_axis)

    # this rank's block of the tokens: P(b_ax, s_ax, None)
    dp = (dp_axes,) if isinstance(dp_axes, str) else tuple(dp_axes or ())
    b_ax = dp if (dp and B % _axis_size(mesh, dp) == 0) else ()
    s_ax = (ep_axis,) if S % M == 0 else ()
    bi = 0
    for ax in b_ax:
        bi = bi * sizes[ax] + mesh.get_local_rank(ax)
    Bl, Sl = B // _axis_size(mesh, b_ax), S // _axis_size(mesh, s_ax)
    si = r if s_ax else 0
    group = {ax: mesh.get_group(ax) for ax in sizes}
    xdev = _exchange_device(group[ep_axis], x.device)
    # the axes whose ranks hold different tokens (size 1: nothing to sum)
    split_groups = [group[ax] for ax in (*b_ax, *s_ax) if sizes[ax] > 1]
    dp_groups = [group[ax] for ax in b_ax if sizes[ax] > 1]

    def summed(t, groups, scale=1.0):
        return _SumGrad.apply(t, groups, xdev, scale) if groups or scale != 1 else t

    xl = summed(x, split_groups).narrow(0, bi * Bl, Bl).narrow(1, si * Sl, Sl)
    T = Bl * Sl
    xt = xl.reshape(T, D)
    router = summed(params["router"], split_groups)
    idx_v, gate_v, aux = _route({"router": router}, xt, cfg)

    A = T * K_v
    cap = max(int(A / E_v * cfg.capacity_factor) + 1, 4)
    order, st, keep, slot = _dispatch(idx_v, T, E_v, cap)
    bins = _bins(xt, st, slot, E_v * cap, x.dtype).reshape(E_v, cap, D)

    # ---- bucket exchange: one all_to_all each way
    recv = _exchange(bins, group[ep_axis], xdev)
    # recv rows are source-rank-major: [M, epr, cap, D]
    toks = recv.reshape(M, epr, cap, D).transpose(0, 1).reshape(epr, M * cap, D)
    # without the sequence split every rank of the EP axis sends the same
    # tokens: the experts see each one M times
    rep = 1.0 if s_ax else 1.0 / M
    w_in = summed(_expert_rows(params["experts"]["w_in"], r, epr, E_v), dp_groups, rep)
    w_out = summed(_expert_rows(params["experts"]["w_out"], r, epr, E_v), dp_groups, rep)
    dt = torch.promote_types(toks.dtype, w_in.dtype)
    h = torch.bmm(toks.to(dt), w_in.to(dt))
    g, u = h.chunk(2, dim=-1)
    h = F.silu(g) * u
    dt = torch.promote_types(h.dtype, w_out.dtype)
    ye = torch.bmm(h.to(dt), w_out.to(dt))
    back = ye.reshape(epr, M, cap, D).transpose(0, 1).reshape(E_v, cap, D)
    ret = _exchange(back, group[ep_axis], xdev)  # my tokens' outputs, expert-major

    sg = gate_v.reshape(-1)[order]
    out = _combine(ret, slot, keep, sg, st, T, K_v).to(x.dtype).reshape(Bl, Sl, D)
    mesh_groups = [(group[ax], n) for ax, n in sizes.items() if n > 1]
    if mesh_groups:
        aux = _MeanOverMesh.apply(aux, mesh_groups, xdev, _axis_size(mesh, (*b_ax, *s_ax)))
    # every rank returns the whole [B, S, D]
    if s_ax and M > 1:
        out = _Gather.apply(out, 1, group[ep_axis], xdev)
    for ax in reversed(b_ax):
        if sizes[ax] > 1:
            out = _Gather.apply(out, 0, group[ax], xdev)
    if "shared" in params:
        out = out + _shared_mlp(params["shared"], x)
    return out, aux
