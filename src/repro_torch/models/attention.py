"""Attention: GQA-grouped chunked (flash) attention, banded local attention,
and single-token decode against a KV cache.

The port of ``repro/models/attention.py``.  The math is the JAX module's:
K/V are never expanded to the query head count (every product carries an
explicit (kv_head, group) split), scores and the running softmax are in
float32, masked scores are -1e30, each KV chunk rescales the running sum by
``exp(m - m_new)`` and the output is ``acc / max(l, 1e-30)``.  Products of
the working dtype are taken in float32 (the JAX module's
``preferred_element_type=jnp.float32``).  ``lax.scan`` over chunks becomes
a Python loop over the same chunks.

``window`` makes the KV loop *banded*: only the ceil((Cq+W)/Ck)+1 chunks
that can be visible to a q chunk are touched — local attention is O(S*W).

The JAX module's custom VJP is :class:`_Flash`, a
``torch.autograd.Function`` over the same chunking: the forward also
returns each row's log-sum-exp and saves ``(q, k, v, out, lse)``; the
backward recomputes every tile's scores from them (differentiating the
chunk loop itself would keep every tile's softmax statistics alive).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding.context import (
    from_shards, is_dtensor, local_shard, shard_offset, splittable,
)

from .common import ModelConfig, apply_rope, dense_init, linear, rope, weak_scalar

__all__ = [
    "attn_init",
    "attention_apply",
    "attention_decode",
    "chunked_attention",
    "init_kv_cache",
]


def attn_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h * hd), cfg.dtype),
        "wk": dense_init(gen, (d, kvh * hd), cfg.dtype),
        "wv": dense_init(gen, (d, kvh * hd), cfg.dtype),
        "wo": dense_init(gen, (h * hd, d), cfg.dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=cfg.dtype)
        p["bk"] = torch.zeros((kvh * hd,), dtype=cfg.dtype)
        p["bv"] = torch.zeros((kvh * hd,), dtype=cfg.dtype)
    return p


def _band_params(banded, nk, q_chunk, kv_chunk, window):
    if not banded:
        return nk
    return min(-(-(q_chunk + window) // kv_chunk) + 1, nk)


def _tile_mask(qi, kj_eff, in_range, causal, window, q_offset, q_chunk, kv_chunk, Sk, device):
    qpos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=device)
    kpos = kj_eff * kv_chunk + torch.arange(kv_chunk, device=device)
    mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
        mask &= in_range
    mask &= kpos[None, :] < Sk
    return mask


def chunked_attention(
    q, k, v, *, causal: bool = True, window: Optional[int] = None,
    q_offset: int = 0, q_chunk: int = 512, kv_chunk: int = 1024,
):  # fmt: skip
    """q: [B, Sq, H, D]; k, v: [B, Sk, KVH, D] with H % KVH == 0."""
    if is_dtensor(q):
        return _sharded_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                  q_chunk=q_chunk, kv_chunk=kv_chunk)  # fmt: skip
    q, k, v, grid = _pad(q, k, v, causal, window, q_offset, q_chunk, kv_chunk)
    return _Flash.apply(q, k, v, grid)[:, : grid.Sq]


def _sharded_attention(q, k, v, **kw):
    """:func:`chunked_attention` of DTensors, on each rank's shard.  Along
    each mesh dim q keeps its split of the batch, else takes a split of
    its sequence (where it divides; a slice, no exchange), else of its
    heads (where the KV heads split alike); k and v take q's batch and head
    splits and hold the whole sequence, their gradients summed over the
    ranks that split q's sequence.  The shard's first row is its
    ``q_offset``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    B, Sq, H = q.shape[:3]
    qp, kp, kgrad = [], [], []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if type(p) is Shard and p.dim == 0:
            d = 0
        elif Sq % n == 0 and Sq > 1:
            d = 1
        elif H % n == 0 and k.shape[2] % n == 0:
            d = 2
        else:
            d = None
        qp.append(Replicate() if d is None else Shard(d))
        kp.append(Shard(d) if d in (0, 2) else Replicate())
        kgrad.append(Partial() if d == 1 else kp[-1])
    out = chunked_attention(
        local_shard(q, qp), local_shard(k, kp, kgrad), local_shard(v, kp, kgrad),
        **dict(kw, q_offset=kw["q_offset"] + shard_offset(Sq, mesh, qp, 1)),
    )  # fmt: skip
    return from_shards(out, mesh, qp, q.shape)


def _pad(q, k, v, causal, window, q_offset, q_chunk, kv_chunk):
    """q, k and v padded to whole chunks, and the call's :class:`_Grid`."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    qp = -(-Sq // q_chunk) * q_chunk - Sq
    kp = -(-Sk // kv_chunk) * kv_chunk - Sk
    if qp:
        q = F.pad(q, (0, 0, 0, 0, 0, qp))
    if kp:
        k = F.pad(k, (0, 0, 0, 0, 0, kp))
        v = F.pad(v, (0, 0, 0, 0, 0, kp))
    return q, k, v, _Grid(causal, window, q_offset, q_chunk, kv_chunk, Sq, Sk, H // KVH)


class _Grid(NamedTuple):
    """The static configuration of one flash call (the JAX factory's closure)."""

    causal: bool
    window: Optional[int]
    q_offset: int
    q_chunk: int
    kv_chunk: int
    Sq: int
    Sk: int
    G: int

    def split(self, q, k, v):
        """qc: [nq, B, KVH, G, Cq, D]; kc, vc: [nk, B, KVH, Ck, D]."""
        B, Sqp, H, D = q.shape
        KVH = k.shape[2]
        nq, nk = Sqp // self.q_chunk, k.shape[1] // self.kv_chunk
        qc = q.reshape(B, nq, self.q_chunk, KVH, self.G, D).permute(1, 0, 3, 4, 2, 5)
        kc = k.reshape(B, nk, self.kv_chunk, KVH, D).permute(1, 0, 3, 2, 4)
        vc = v.reshape(B, nk, self.kv_chunk, KVH, D).permute(1, 0, 3, 2, 4)
        return qc, kc, vc, nq, nk

    def rows(self, x, B, nq):
        """A per-row tensor [B, nq*Cq, KVH, G, ...] as [nq, B, KVH, G, Cq, ...]."""
        x = x.reshape(B, nq, self.q_chunk, *x.shape[2:])
        return x.permute(1, 0, 3, 4, 2, *range(5, x.dim()))

    def unrows(self, x):
        """The inverse of :meth:`rows`: [nq, B, KVH, G, Cq, ...] -> [B, nq*Cq, KVH, G, ...]."""
        nq, B, KVH, G, Cq = x.shape[:5]
        x = x.permute(1, 0, 4, 2, 3, *range(5, x.dim()))
        return x.reshape(B, nq * Cq, KVH, G, *x.shape[5:])

    def tiles(self, qi, nk):
        """The KV tiles of q chunk ``qi``: ``(kj_eff, in_range)`` per step of
        the JAX module's inner scan (banded: the window's chunks, the index
        clipped to ``nk - 1``)."""
        banded = self.window is not None
        nk_band = _band_params(banded, nk, self.q_chunk, self.kv_chunk, self.window)
        first = 0
        if banded:
            first = max((self.q_offset + qi * self.q_chunk - self.window) // self.kv_chunk, 0)
        for kj in range(nk_band):
            yield min(max(first + kj, 0), nk - 1), first + kj < nk

    def mask(self, qi, kj_eff, in_range, device):
        return _tile_mask(qi, kj_eff, in_range, self.causal, self.window, self.q_offset,
                          self.q_chunk, self.kv_chunk, self.Sk, device)  # fmt: skip


def _flash_forward(q, k, v, grid: _Grid, with_lse: bool = True):
    """The JAX module's ``_flash`` forward (``fwd_impl``) on padded q, k, v:
    returns ``out`` [B, Sqp, H, D] and the rows' log-sum-exp ``lse``
    [B, Sqp, KVH, G] (``inf`` where a row sees no key), or ``None`` in its
    place without ``with_lse`` (the JAX primal, where XLA drops it)."""
    B, Sqp, H, D = q.shape
    qc, kc, vc, nq, nk = grid.split(q, k, v)
    KVH, G, Cq = k.shape[2], grid.G, grid.q_chunk
    scale = weak_scalar(1.0 / math.sqrt(D), q)
    outs, lses = [], []
    for qi in range(nq):
        qblk = (qc[qi] * scale).float()  # [B,KVH,G,Cq,D]
        m = torch.full((B, KVH, G, Cq), -math.inf, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((*m.shape, D), dtype=torch.float32, device=q.device)
        for kj_eff, in_range in grid.tiles(qi, nk):
            s = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kc[kj_eff].float())
            mask = grid.mask(qi, kj_eff, in_range, q.device)
            s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            r = torch.exp(m - m_new)
            pe = torch.exp(s - m_new[..., None]) * mask
            l = l * r + pe.sum(-1)
            pv = torch.einsum("bhgqk,bhkd->bhgqd", pe.to(vc.dtype).float(), vc[kj_eff].float())
            acc = acc * r[..., None] + pv
            m = m_new
        outs.append((acc / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype))
        if with_lse:
            lses.append(torch.where(l > 0, m + torch.log(torch.clamp_min(l, 1e-30)), math.inf))
    out = grid.unrows(torch.stack(outs)).reshape(B, Sqp, H, D)
    return out, grid.unrows(torch.stack(lses)) if with_lse else None


def _flash_backward(q, k, v, out, lse, dout, grid: _Grid):
    """The JAX module's ``attn_bwd``: (dq, dk, dv) in the inputs' dtypes.

    Each tile's scores are recomputed from ``q * scale`` rounded to the
    working dtype, as the forward computes them; ``p = exp(s - lse)``,
    ``ds = p * (dp - D) * scale`` with ``D`` the rows' ``sum(dout * out)``
    in float32; ``dk`` sums over the query group, and ``dk`` and ``dv`` use
    the unscaled q and the float32 ``p``.  A banded tile whose chunk lies
    past the end adds nothing (its mask is empty).
    """
    B, Sqp, H, D = q.shape
    qc, kc, vc, nq, nk = grid.split(q, k, v)
    KVH = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    q_scale = weak_scalar(scale, q)
    doc = grid.rows(dout.reshape(B, Sqp, KVH, grid.G, D), B, nq)
    lsec = grid.rows(lse, B, nq)
    Drow = (dout.float() * out.float()).sum(-1)
    Dc = grid.rows(Drow.reshape(B, Sqp, KVH, grid.G), B, nq)
    dk_acc = torch.zeros((nk, B, KVH, grid.kv_chunk, D), dtype=torch.float32, device=q.device)
    dv_acc = torch.zeros_like(dk_acc)
    dqs = []
    for qi in range(nq):
        qblk = qc[qi].float()
        qs = (qc[qi] * q_scale).float()
        do = doc[qi].float()
        lse_i, D_i = lsec[qi][..., None], Dc[qi][..., None]
        dq_i = torch.zeros(qblk.shape, dtype=torch.float32, device=q.device)
        for kj_eff, in_range in grid.tiles(qi, nk):
            if not in_range:
                continue
            kblk, vblk = kc[kj_eff].float(), vc[kj_eff].float()
            s = torch.einsum("bhgqd,bhkd->bhgqk", qs, kblk)
            mask = grid.mask(qi, kj_eff, in_range, q.device)
            s = torch.where(mask, s, -1e30)
            p = torch.exp(s - lse_i) * mask
            dp = torch.einsum("bhgqd,bhkd->bhgqk", do, vblk)
            ds = p * (dp - D_i) * scale
            dq_i = dq_i + torch.einsum("bhgqk,bhkd->bhgqd", ds, kblk)
            # sum over the query group
            dk_acc[kj_eff] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qblk)
            dv_acc[kj_eff] += torch.einsum("bhgqk,bhgqd->bhkd", p, do)
        dqs.append(dq_i)
    dq = grid.unrows(torch.stack(dqs)).reshape(B, Sqp, H, D)
    dk = dk_acc.permute(1, 0, 3, 2, 4).reshape(B, nk * grid.kv_chunk, KVH, D)
    dv = dv_acc.permute(1, 0, 3, 2, 4).reshape(B, nk * grid.kv_chunk, KVH, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """GQA flash attention on padded q, k, v with the JAX module's custom
    VJP: the backward recomputes each tile from ``(q, k, v, out, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, grid: _Grid):
        # serving (no input needs a gradient) skips the log-sum-exp
        with_lse = any(ctx.needs_input_grad[:3])
        out, lse = _flash_forward(q, k, v, grid, with_lse)
        if with_lse:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.grid = grid
        return out

    @staticmethod
    def backward(ctx, dout):
        return (*_flash_backward(*ctx.saved_tensors, dout, ctx.grid), None)


def attention_apply(
    params, x, cfg: ModelConfig, *, window: Optional[int] = None,
    positions=None, causal: bool = True, kv_override=None,
):  # fmt: skip
    """Full-sequence attention (train / prefill).  Returns (out, (k, v))."""
    B, S, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    q = splittable(q, -1, h).reshape(B, S, h, hd)
    if kv_override is None:
        k = linear(x, params["wk"])
        v = linear(x, params["wv"])
        if "bk" in params:
            k = k + params["bk"]
            v = v + params["bv"]
        k = splittable(k, -1, kvh).reshape(B, -1, kvh, hd)
        v = splittable(v, -1, kvh).reshape(B, -1, kvh, hd)
    else:
        k, v = kv_override  # cross attention: precomputed from encoder
    if positions is None:
        positions = torch.arange(S, device=x.device)[None]
    if kv_override is None and not cfg.learned_pos:
        sin, cos = rope(positions, hd, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        kpos = torch.arange(k.shape[1], device=x.device)[None]
        ksin, kcos = rope(kpos, hd, cfg.rope_theta)
        k = apply_rope(k, ksin, kcos)
    out = chunked_attention(q, k, v, causal=causal, window=window)
    out = out.reshape(B, S, h * hd)
    return linear(out, params["wo"]), (k, v)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *, window=None):
    """Cache for one attention layer, on the default device.  Local layers
    keep only the window."""
    length = min(window, max_len) if window else max_len
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype),
        "v": torch.zeros(shape, dtype=cfg.dtype),
    }


def attention_decode(
    params, x, cache, cache_len, cfg: ModelConfig, *, window: Optional[int] = None,
):  # fmt: skip
    """One-token decode. x: [B, 1, D]; cache k/v: [B, L, KVH, HD];
    cache_len: int (or 0-d tensor) — number of valid cache positions.
    GQA-grouped: the cache is read once, not query-head-many times.

    Writes the new key and value into ``cache`` in place (the JAX module
    returns updated copies) and returns ``(out, cache)``.
    """
    B = x.shape[0]
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kvh
    L = cache["k"].shape[1]
    q = linear(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    q = splittable(q, -1, kvh).reshape(B, 1, kvh, g, hd)
    k = linear(x, params["wk"])
    v = linear(x, params["wv"])
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    k = splittable(k, -1, kvh).reshape(B, 1, kvh, hd)
    v = splittable(v, -1, kvh).reshape(B, 1, kvh, hd)
    pos = int(cache_len)
    if not cfg.learned_pos:
        sin, cos = rope(torch.full((1, 1), pos, device=x.device), hd, cfg.rope_theta)
        q = apply_rope(q.reshape(B, 1, h, hd), sin, cos).reshape(B, 1, kvh, g, hd)
        k = apply_rope(k, sin, cos)
    slot = (pos % L) if window else min(pos, L - 1)
    ck, cv = cache["k"], cache["v"]
    if is_dtensor(ck):
        out = _sharded_decode(q, k, v, ck, cv, slot, pos, window)
    else:
        out = _decode(q, k, v, ck, cv, slot, pos, window)
    out = out.reshape(B, 1, h * hd)
    return linear(out, params["wo"]), cache


def _decode(q, k, v, ck, cv, slot: int, pos: int, window):
    """The new k, v written at ``slot`` of the cache ck, cv, and q's
    attention over it: [B, 1, KVH, G, HD] in q's dtype."""
    L, hd = ck.shape[1], ck.shape[3]
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]
    s = torch.einsum(
        "bqhgd,bkhd->bhgqk", (q * weak_scalar(1.0 / math.sqrt(hd), q)).float(), ck.float()
    )
    idx = torch.arange(L, device=q.device)
    valid = idx <= slot if window is None else ((idx <= slot) | (pos >= L))
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(cv.dtype).float(), cv.float()).to(q.dtype)


def _sharded_decode(q, k, v, ck, cv, slot: int, pos: int, window):
    """:func:`_decode` of DTensors, on each rank's shard: q, k and v take
    the cache's split of the batch and the KV heads, and each rank writes
    and reads its shard of the cache (the cache's positions are whole)."""
    places = list(ck.placements)
    if any(p.is_shard(1) or p.is_shard(3) or p.is_partial() for p in places):
        raise NotImplementedError(f"a KV cache placed as {places}: decode takes the batch "
                                  f"and the KV heads split, the positions whole")  # fmt: skip
    out = _decode(local_shard(q, places), local_shard(k, places), local_shard(v, places),
                  ck.to_local(), cv.to_local(), slot, pos, window)  # fmt: skip
    return from_shards(out, ck.device_mesh, places, q.shape)
