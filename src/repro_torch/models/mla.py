"""Multi-head Latent Attention (DeepSeek-V2): compressed KV cache.

The port of ``repro/models/mla.py``.  K/V are generated from a
rank-``kv_lora_rank`` latent ``c_kv`` plus a single shared RoPE key
channel; the cache stores only ``[c_kv ; k_rope]`` (kv_lora_rank +
qk_rope_dim per token — 576 for the assigned config).

Decode uses the *absorbed* formulation: W_UK folds into the query and W_UV
into the output projection, so a step attends against the latent cache
directly, with no per-position K/V up-projection.  As in the JAX module,
the products it takes in float32 (``preferred_element_type``) are float32
products of the working dtype's values, and the new latent is written into
the cache in place, as ``attention_decode`` writes K and V.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding.context import (
    from_shards, is_dtensor, local_shard, shard_offset, splittable, write_at,
)

from .attention import chunked_attention
from .common import ModelConfig, apply_rope, dense_init, linear, rope

__all__ = ["mla_init", "mla_apply", "mla_decode", "init_mla_cache"]


def mla_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    r = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        # queries: full-rank projection to per-head (nope ++ rope) parts
        "wq": dense_init(gen, (d, h * (dn + dr)), cfg.dtype),
        # latent: d -> r (c_kv) and d -> dr (shared rope key)
        "w_dkv": dense_init(gen, (d, r), cfg.dtype),
        "w_krope": dense_init(gen, (d, dr), cfg.dtype),
        # up-projections from the latent
        "w_uk": dense_init(gen, (r, h * dn), cfg.dtype),
        "w_uv": dense_init(gen, (r, h * dv), cfg.dtype),
        "wo": dense_init(gen, (h * dv, d), cfg.dtype),
    }


def _project_q(params, x, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = splittable(linear(x, params["wq"]), -1, h).reshape(B, S, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    sin, cos = rope(positions, dr, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, sin, cos)


def mla_apply(params, x, cfg: ModelConfig, *, positions=None):
    """Train / prefill.  Returns (out, latent_cache [B,S,r+dr])."""
    B, S, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if positions is None:
        positions = torch.arange(S, device=x.device)[None]
    q_nope, q_rope = _project_q(params, x, cfg, positions)

    c_kv = linear(x, params["w_dkv"])  # latent
    k_rope = linear(x, params["w_krope"]).reshape(B, S, 1, dr)
    # the shared key's positions are 0..S-1 whatever ``positions`` says
    sin, cos = rope(torch.arange(S, device=x.device)[None], dr, cfg.rope_theta)
    k_rope = apply_rope(k_rope, sin, cos)

    k_nope = splittable(linear(c_kv, params["w_uk"]), -1, h).reshape(B, S, h, dn)
    v = splittable(linear(c_kv, params["w_uv"]), -1, h).reshape(B, S, h, dv)

    # assemble full per-head keys/queries: [nope ; rope(shared)]
    q_full = torch.cat([q_nope, q_rope], -1)
    k_full = torch.cat([k_nope, k_rope.expand(B, S, h, dr)], -1)
    # one attention primitive for q/k and v: pad v to the qk dim, slice back
    dqk = dn + dr
    v_p = F.pad(v, (0, dqk - dv)) if dv < dqk else v
    out = chunked_attention(q_full, k_full, v_p, causal=True)[..., :dv]
    out = linear(out.reshape(B, S, h * dv), params["wo"])
    cache = torch.cat([c_kv, k_rope[:, :, 0, :]], -1)  # [B,S,r+dr]
    return out, cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int):
    """The latent cache of one MLA layer, on the default device."""
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank + cfg.qk_rope_dim), dtype=cfg.dtype)
    }


def mla_decode(params, x, cache, cache_len, cfg: ModelConfig):
    """Absorbed decode: score/attend directly in the latent space.

    x: [B, 1, D]; cache_len: int (or 0-d tensor).  Writes the new token's
    latent into ``cache`` in place (at ``min(cache_len, L - 1)``) and
    returns ``(out, cache)``."""
    B = x.shape[0]
    h = cfg.n_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    ckv = cache["ckv"]
    L = ckv.shape[1]
    pos = int(cache_len)
    positions = torch.full((1, 1), pos, device=x.device)
    q_nope, q_rope = _project_q(params, x, cfg, positions)  # [B,1,h,*]

    # absorb W_UK into q: q_lat[h, r] = q_nope[h, dn] @ W_UK[r, h*dn]^T
    w_uk = splittable(params["w_uk"], -1, h).reshape(r, h, dn)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)  # [B,1,h,r]

    # append the new token's latent to the cache
    c_new = linear(x, params["w_dkv"])
    k_rope_new = linear(x, params["w_krope"]).reshape(B, 1, 1, dr)
    sin, cos = rope(positions, dr, cfg.rope_theta)
    k_rope_new = apply_rope(k_rope_new, sin, cos)
    slot = min(pos, L - 1)
    write_at(ckv, 1, slot, torch.cat([c_new, k_rope_new[:, :, 0, :]], -1)[:, 0])

    scale = 1.0 / math.sqrt(dn + dr)
    if is_dtensor(ckv):
        o_lat = _sharded_latent_attention(q_lat, q_rope, ckv, slot, r, scale).to(x.dtype)
    else:
        lat, kr = ckv[..., :r].float(), ckv[..., r:].float()  # [B,L,r], [B,L,dr]
        s = (
            torch.einsum("bqhr,bkr->bhqk", q_lat.float(), lat)
            + torch.einsum("bqhe,bke->bhqk", q_rope.float(), kr)
        ) * scale
        valid = torch.arange(L, device=x.device) <= slot
        s = torch.where(valid, s, -1e30)
        p = torch.softmax(s, dim=-1)
        # attend in latent space
        o_lat = torch.einsum("bhqk,bkr->bqhr", p.to(ckv.dtype).float(), lat).to(x.dtype)
    # absorb W_UV on the way out
    w_uv = splittable(params["w_uv"], -1, h).reshape(r, h, dv)
    o = torch.einsum("bqhr,rhv->bqhv", o_lat, w_uv).reshape(B, 1, h * dv)
    return linear(o, params["wo"]), cache


def _sharded_latent_attention(q_lat, q_rope, ckv, slot: int, r: int, scale: float):
    """``mla_decode``'s attention over a DTensor cache, on each rank's shard
    (flash-decoding): the cache keeps its split of the batch and of the
    positions, the queries take the batch split, and the softmax's max and
    sum and the attended latent are reduced over the ranks that split the
    positions.  Returns the float32 DTensor ``o_lat`` [B, 1, h, r]."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard

    mesh = ckv.device_mesh
    qp = [Shard(0) if p.is_shard(0) else Replicate() for p in ckv.placements]
    over = [(mesh, i) for i, p in enumerate(ckv.placements) if p.is_shard(1)]

    def reduce(t, op):
        for group in over:
            t = funcol.all_reduce(t, op, group)
        return t

    c = ckv.to_local()
    lat, kr = c[..., :r].float(), c[..., r:].float()  # [b,l,r], [b,l,dr]
    s = (
        torch.einsum("bqhr,bkr->bhqk", local_shard(q_lat, qp).float(), lat)
        + torch.einsum("bqhe,bke->bhqk", local_shard(q_rope, qp).float(), kr)
    ) * scale
    first = shard_offset(ckv.shape[1], mesh, ckv.placements, 1)
    valid = first + torch.arange(c.shape[1], device=c.device) <= slot
    s = torch.where(valid, s, -1e30)
    e = torch.exp(s - reduce(s.amax(-1, keepdim=True), "max"))
    p = e / reduce(e.sum(-1, keepdim=True), "sum")
    o = reduce(torch.einsum("bhqk,bkr->bqhr", p.to(c.dtype).float(), lat), "sum")
    return from_shards(o, mesh, qp, (*q_lat.shape[:3], r))
