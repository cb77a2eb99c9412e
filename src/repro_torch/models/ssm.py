"""Mamba-2 (SSD — state-space duality) block.

The port of ``repro/models/ssm.py``.  Chunked SSD algorithm (Dao & Gu
2024): the sequence is split into chunks of ``chunk`` positions; within a
chunk the output is a (masked) quadratic form of matrix products, and
across chunks a small float32 recurrent state [heads, head_dim, state] is
carried by a Python loop over the chunks (the JAX module's ``lax.scan``).
O(S * chunk) compute, O(1) decode state.

The products the JAX module takes with ``preferred_element_type=float32``
are float32 products of the working dtype's values here, as in
``attention.py``.  The causal mask goes on before ``exp``: the upper
triangle's exponents are positive and would overflow to inf, and
inf * 0 = NaN.

One departure from the JAX module's rounding: the within-chunk decay
``cum_i - cum_j`` is Mamba-2's stable segment sum, the float32 sum of
``dA`` over ``j < k <= i`` (``_segsum``), not the difference of two
cumulative sums.  Over a 256-position chunk |cum| reaches ~3e3, and the
difference of two float32 sums of that size carries an ulp of it: in the
JAX module's form the reduced config's forward over 300 positions sits
2.9e-4 off its own decode recurrence, and the card sat 2.3e-4 off the CPU.
At the lengths the tests hold against the JAX package the two forms agree
within 1e-4; tests/test_torch_recurrent.py states the gap over a full
chunk.

Decode is the SSM recurrence: h = exp(dt*A) h + dt * B x ; y = C h.  It
writes the new state and conv tail into the cache in place, as
``attention_decode`` writes K and V.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.sharding.context import from_shards, is_dtensor, local_shard

from .common import ModelConfig, dense_init, linear, rms_norm

__all__ = ["ssd_init", "ssd_apply", "ssd_decode", "init_ssd_cache"]


def ssd_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    nh = cfg.ssm_heads
    ns = cfg.ssm_state
    # in_proj order: [z (gate) | x | B | C | dt]
    zxbcdt = di + di + ns + ns + nh
    return {
        "w_in": dense_init(gen, (d, zxbcdt), cfg.dtype),
        "conv": dense_init(gen, (cfg.conv_width, di + 2 * ns), cfg.dtype, scale=0.5),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32)),  # per-head decay
        "dt_bias": torch.zeros((nh,), dtype=torch.float32),
        "d_skip": torch.ones((nh,), dtype=torch.float32),
        "norm": torch.zeros((di,), dtype=torch.float32),
        "w_out": dense_init(gen, (di, d), cfg.dtype),
    }


def _split_in(params, x, cfg: ModelConfig):
    di, ns = cfg.d_inner, cfg.ssm_state
    zxbcdt = linear(x, params["w_in"])
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di : di + di + 2 * ns]
    dt = zxbcdt[..., di + di + 2 * ns :]
    return z, xbc, dt


def _causal_conv(xbc, conv_w, *, state=None):
    """Depthwise causal conv, width W.  state: [B, W-1, C] tail for decode."""
    W = conv_w.shape[0]
    if state is None:
        pad = xbc.new_zeros((xbc.shape[0], W - 1, xbc.shape[2]))
    else:
        pad = state
    xp = torch.cat([pad, xbc], dim=1)
    S = xbc.shape[1]
    # the JAX module's Python ``sum``: the shifted products added in index
    # order, in the input dtype
    out = xp[:, 0:S] * conv_w[0]
    for i in range(1, W):
        out = out + xp[:, i : i + S] * conv_w[i]
    new_state = xp[:, -(W - 1) :] if W > 1 else pad
    return F.silu(out), new_state


def _segsum(dA_c):
    """seg[..., i, j] = sum of dA_c[..., k] over j < k <= i, and -inf for
    j > i (the mask before ``exp``).  dA_c [..., CH] -> [..., CH, CH]."""
    CH = dA_c.shape[-1]
    idx = torch.arange(CH, device=dA_c.device)
    # x[..., i, j] = dA_i where j < i, else 0; summed down i
    x = dA_c[..., :, None].expand(*dA_c.shape, CH)
    seg = torch.cumsum(x.masked_fill(idx[:, None] <= idx[None, :], 0.0), dim=-2)
    return seg.masked_fill(idx[:, None] < idx[None, :], -torch.inf)


def _chunk(h0, xs_c, B_c, C_c, dA_c, dt_c):
    """One chunk: (h_new, y).  xs_c [B,nh,CH,hd]; B_c, C_c [B,CH,ns];
    dA_c, dt_c [B,nh,CH] float32; h0 [B,nh,hd,ns] float32."""
    cum = torch.cumsum(dA_c, dim=-1)  # [B,nh,CH] cumulative log decay
    seg = _segsum(dA_c)  # [B,nh,CH,CH] cum_i - cum_j, summed without cancelling
    # intra-chunk: L[i,j] = exp(cum_i - cum_j) * dt_j  for j <= i
    L = torch.exp(seg)
    Bf, Cf = B_c.float(), C_c.float()
    G = Cf @ Bf.transpose(-1, -2)  # [B,CH,CH]
    M = G[:, None] * L * dt_c[..., None, :]  # [B,nh,CH,CH]
    y_intra = M.to(xs_c.dtype).float() @ xs_c.float()  # [B,nh,CH,hd]
    # inter-chunk: carried state decayed to each position i, read out by C
    y_inter = (Cf[:, None] @ h0.transpose(-1, -2)) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).to(xs_c.dtype)
    # state update: h' = exp(cum_last) h0 + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
    wj = L[..., -1, :] * dt_c  # [B,nh,CH]
    h_new = h0 * torch.exp(cum[..., -1])[..., None, None] + (
        (xs_c.float() * wj[..., None]).transpose(-1, -2) @ Bf[:, None]
    )
    return h_new, y


def ssd_apply(params, x, cfg: ModelConfig, *, chunk: int = 256,
              initial_state=None) -> Tuple[torch.Tensor, dict]:  # fmt: skip
    """Full-sequence SSD.  x: [B, S, D].  Returns (y, cache)."""
    B, S, D = x.shape
    di, ns, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt = _split_in(params, x, cfg)
    xbc, conv_state = _causal_conv(xbc, params["conv"])
    xs = xbc[..., :di].reshape(B, S, nh, hd)
    Bm = xbc[..., di : di + ns]  # [B,S,ns] (single group)
    Cm = xbc[..., di + ns :]

    a = -torch.exp(params["a_log"])  # [nh] negative decay rates
    dt = F.softplus(dt.float() + params["dt_bias"])  # [B,S,nh]
    dA = dt * a  # [B,S,nh] log-decay per step

    scan = _sharded_scan if is_dtensor(xs) else _scan
    y, h = scan(xs, Bm, Cm, dA, dt, chunk, initial_state)
    y = y + xs * params["d_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, di)
    y = rms_norm(y * F.silu(z), params["norm"], 1e-6)
    out = linear(y, params["w_out"])
    return out, {"ssm": h, "conv": conv_state}


def _scan(xs, Bm, Cm, dA, dt, chunk: int, h0):
    """The chunked scan: y [B, S, nh, hd] in xs's dtype and the final state
    h [B, nh, hd, ns] float32 (from ``h0``, zeros when ``None``)."""
    B, S, nh, hd = xs.shape
    ns = Bm.shape[-1]
    chunk = min(chunk, S)
    nc = -(-S // chunk)
    pad = nc * chunk - S
    xs_p, Bm_p, Cm_p, dA_p, dt_p = xs, Bm, Cm, dA, dt
    if pad:
        # zeros past the end: dA = 0 and dt = 0 there, so the pads neither
        # decay nor feed the state
        xs_p = F.pad(xs, (0, 0, 0, 0, 0, pad))
        Bm_p, Cm_p, dA_p, dt_p = (F.pad(t, (0, 0, 0, pad)) for t in (Bm, Cm, dA, dt))
    CH = chunk
    xs_c = xs_p.reshape(B, nc, CH, nh, hd).permute(1, 0, 3, 2, 4)  # [nc,B,nh,CH,hd]
    Bm_c = Bm_p.reshape(B, nc, CH, ns).transpose(0, 1)  # [nc,B,CH,ns]
    Cm_c = Cm_p.reshape(B, nc, CH, ns).transpose(0, 1)
    dA_c = dA_p.reshape(B, nc, CH, nh).permute(1, 0, 3, 2)  # [nc,B,nh,CH]
    dt_c = dt_p.reshape(B, nc, CH, nh).permute(1, 0, 3, 2)

    h = h0
    if h is None:
        h = torch.zeros((B, nh, hd, ns), dtype=torch.float32, device=xs.device)
    ys = []
    for c in range(nc):
        h, y = _chunk(h, xs_c[c], Bm_c[c], Cm_c[c], dA_c[c], dt_c[c])
        ys.append(y)
    return torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, nc * CH, nh, hd)[:, :S], h


def _sharded_scan(xs, Bm, Cm, dA, dt, chunk: int, h0):
    """:func:`_scan` of DTensors, on each rank's shard: the scan runs along
    the whole sequence, each rank over its split of the batch, else of the
    heads (B and C are whole; their gradients summed over the head split)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = xs.device_mesh
    nh = xs.shape[2]
    by_head, shared, grad = [], [], []
    for i, p in enumerate(xs.placements):
        if p.is_shard(0):
            by_head.append(Shard(0)), shared.append(Shard(0)), grad.append(Shard(0))
        elif nh % mesh.size(i) == 0:
            by_head.append(Shard(2)), shared.append(Replicate()), grad.append(Partial())
        else:
            by_head.append(Replicate()), shared.append(Replicate()), grad.append(Replicate())
    state = [Shard(1) if p == Shard(2) else p for p in by_head]
    if h0 is not None:
        whole = [Replicate()] * mesh.ndim
        h0 = local_shard(h0 if is_dtensor(h0) else from_shards(h0, mesh, whole, h0.shape), state)
    y, h = _scan(local_shard(xs, by_head), local_shard(Bm, shared, grad),
                 local_shard(Cm, shared, grad), local_shard(dA, by_head),
                 local_shard(dt, by_head), chunk, h0)  # fmt: skip
    B, S, _, hd = xs.shape
    return (from_shards(y, mesh, by_head, xs.shape),
            from_shards(h, mesh, state, (B, nh, hd, Bm.shape[-1])))  # fmt: skip


def init_ssd_cache(cfg: ModelConfig, batch: int):
    """The state of one SSD layer, on the default device."""
    return {
        "ssm": torch.zeros(
            (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state), dtype=torch.float32
        ),
        "conv": torch.zeros(
            (batch, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state), dtype=cfg.dtype
        ),
    }


def ssd_decode(params, x, cache, cfg: ModelConfig):
    """One-token recurrence. x: [B, 1, D].

    Writes the new state and conv tail into ``cache`` in place (the JAX
    module returns them as a new cache) and returns ``(out, cache)``."""
    B = x.shape[0]
    di, ns, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt = _split_in(params, x, cfg)
    xbc, conv_state = _causal_conv(xbc, params["conv"], state=cache["conv"])
    xs = xbc[..., :di].reshape(B, nh, hd).float()
    Bm = xbc[:, 0, di : di + ns].float()  # [B,ns]
    Cm = xbc[:, 0, di + ns :].float()
    a = -torch.exp(params["a_log"])
    dts = F.softplus(dt[:, 0].float() + params["dt_bias"])  # [B,nh]
    decay = torch.exp(dts * a)  # [B,nh]
    h = cache["ssm"] * decay[..., None, None] + (
        (dts[..., None] * xs)[..., None] * Bm[:, None, None, :]
    )
    y = (h @ Cm[:, None, :, None])[..., 0]  # [B,nh,hd]
    y = y + xs * params["d_skip"][None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], 1e-6)
    out = linear(y, params["w_out"])
    cache["ssm"].copy_(h)
    cache["conv"].copy_(conv_state)
    return out, cache
