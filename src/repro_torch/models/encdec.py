"""Encoder-decoder backbone (whisper-tiny).

The port of ``repro/models/encdec.py``.  The conv/mel frontend is a stub:
the caller supplies precomputed frame embeddings [B, S_enc, D].  The
backbone is the standard whisper transformer: bidirectional encoder
(learned positions, GeLU MLP), causal decoder with cross-attention,
LayerNorm with a bias, and logits against the tied embedding.

The layers are stacked on a leading axis, as the JAX module's
``jax.vmap`` and ``lax.scan`` stack them, and walked with a Python loop.
The JAX scans run without remat, and so do these loops.  Each layer's
output is pinned with ``sharding.context.constrain``, as in the JAX module.

Decode attends to the encoder K/V computed once at prefill, which the
caches hold, plus a growing self-attention cache written in place by
``attention_decode``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.sharding.context import constrain, last_row, splittable

from .attention import attention_apply, attention_decode, attn_init
from .common import (
    ModelConfig, dense_init, embed_lookup, layer_norm, linear, mlp_apply, mlp_init, weak_scalar,
)
from .transformer import _stack, _stacked_groups, _unbind

__all__ = [
    "encdec_init",
    "encode",
    "encdec_forward",
    "encdec_prefill",
    "encdec_decode_step",
    "init_decoder_caches",
]


def _ln_init(cfg):
    return {
        "scale": torch.ones((cfg.d_model,), dtype=torch.float32),
        "bias": torch.zeros((cfg.d_model,), dtype=torch.float32),
    }


def encdec_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Parameters on the default device, every draw from ``gen``."""
    vp = cfg.vocab_padded

    def enc_layer():
        return {
            "ln1": _ln_init(cfg),
            "attn": attn_init(gen, cfg),
            "ln2": _ln_init(cfg),
            "mlp": mlp_init(gen, cfg),
        }

    def dec_layer():
        return {
            "ln1": _ln_init(cfg),
            "self_attn": attn_init(gen, cfg),
            "ln_x": _ln_init(cfg),
            "cross_attn": attn_init(gen, cfg),
            "ln2": _ln_init(cfg),
            "mlp": mlp_init(gen, cfg),
        }

    return {
        "enc_pos": dense_init(gen, (cfg.max_pos, cfg.d_model), cfg.dtype, 0.02),
        "dec_pos": dense_init(gen, (cfg.max_pos, cfg.d_model), cfg.dtype, 0.02),
        "embed": dense_init(gen, (vp, cfg.d_model), cfg.dtype, 0.02),
        "enc_layers": _stacked_groups(enc_layer, cfg.n_encoder_layers),
        "dec_layers": _stacked_groups(dec_layer, cfg.n_layers),
        "enc_ln": _ln_init(cfg),
        "dec_ln": _ln_init(cfg),
    }


def _ln(x, p, eps):
    return layer_norm(x, p["scale"], p["bias"], eps)


def encode(params, frames, cfg: ModelConfig):
    """frames: [B, S_enc, D] (frontend stub output) -> encoder states."""
    S = frames.shape[1]
    pos = params["enc_pos"][torch.arange(S, device=frames.device) % cfg.max_pos]
    x = frames.to(cfg.dtype) + pos[None]
    for p in _unbind(params["enc_layers"], cfg.n_encoder_layers):
        a, _ = attention_apply(p["attn"], _ln(x, p["ln1"], cfg.norm_eps), cfg, causal=False)
        x = x + a
        x = constrain(x + mlp_apply(p["mlp"], _ln(x, p["ln2"], cfg.norm_eps), "gelu"), "residual")
    return _ln(x, params["enc_ln"], cfg.norm_eps)


def _decoder(params, x, enc_states, cfg: ModelConfig, *, collect_cache: bool):
    """Teacher-forced decoder. x: [B, S_dec, D] token embeddings (+pos)."""
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    B, Se = enc_states.shape[0], enc_states.shape[1]
    caches = []
    for p in _unbind(params["dec_layers"], cfg.n_layers):
        a, kv_self = attention_apply(
            p["self_attn"], _ln(x, p["ln1"], cfg.norm_eps), cfg, causal=True
        )
        x = x + a
        # cross attention: keys/values from encoder states (no rope)
        hq = _ln(x, p["ln_x"], cfg.norm_eps)
        k = linear(enc_states, p["cross_attn"]["wk"])
        v = linear(enc_states, p["cross_attn"]["wv"])
        k = splittable(k, -1, kvh).reshape(B, Se, kvh, hd)
        v = splittable(v, -1, kvh).reshape(B, Se, kvh, hd)
        a, kv_cross = attention_apply(p["cross_attn"], hq, cfg, causal=False, kv_override=(k, v))
        x = x + a
        x = constrain(x + mlp_apply(p["mlp"], _ln(x, p["ln2"], cfg.norm_eps), "gelu"), "residual")
        if collect_cache:
            caches.append({"self": {"k": kv_self[0], "v": kv_self[1]},
                           "cross": {"k": kv_cross[0], "v": kv_cross[1]}})  # fmt: skip
    return _ln(x, params["dec_ln"], cfg.norm_eps), _stack(caches) if collect_cache else None


def encdec_forward(params, frames, dec_tokens, cfg: ModelConfig, *, collect_cache: bool = False):
    """Returns (logits [B, S_dec, vocab_padded], aux=0)."""
    enc = encode(params, frames, cfg)
    S = dec_tokens.shape[1]
    pos = params["dec_pos"][torch.arange(S, device=dec_tokens.device) % cfg.max_pos]
    x = embed_lookup(params["embed"], dec_tokens) + pos[None]
    x, caches = _decoder(params, x, enc, cfg, collect_cache=collect_cache)
    logits = linear(x, params["embed"].T)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    if collect_cache:
        return logits, caches, aux
    return logits, aux


def encdec_prefill(params, frames, dec_tokens, cfg: ModelConfig):
    logits, caches, _ = encdec_forward(params, frames, dec_tokens, cfg, collect_cache=True)
    return last_row(logits, 1), caches


def init_decoder_caches(cfg: ModelConfig, batch: int, max_len: int, enc_len: int):
    """Zero decoder caches on the default device: a growing self cache and
    the fixed cross K/V, stacked over the decoder layers."""
    kvh, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers

    def kv(length):
        shape = (L, batch, length, kvh, hd)
        return {"k": torch.zeros(shape, dtype=cfg.dtype), "v": torch.zeros(shape, dtype=cfg.dtype)}

    return {"self": kv(max_len), "cross": kv(enc_len)}


def encdec_decode_step(params, token, caches, cache_len, cfg: ModelConfig):
    """One decoder token; cross K/V comes from the caches (precomputed).

    The self caches are updated in place and the cross caches left as
    they are: the returned tree is ``caches`` itself."""
    B = token.shape[0]
    kvh, hd, nh = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    pos = params["dec_pos"][min(int(cache_len), cfg.max_pos - 1)]
    x = embed_lookup(params["embed"], token) + pos[None, None]
    for p, c in zip(_unbind(params["dec_layers"], cfg.n_layers), _unbind(caches, cfg.n_layers)):
        hn = _ln(x, p["ln1"], cfg.norm_eps)
        a, _ = attention_decode(p["self_attn"], hn, c["self"], cache_len, cfg)
        x = x + a
        # cross attention against fixed encoder K/V
        hq = _ln(x, p["ln_x"], cfg.norm_eps)
        q = splittable(linear(hq, p["cross_attn"]["wq"]), -1, nh).reshape(B, 1, nh, hd)
        ck, cv = c["cross"]["k"], c["cross"]["v"]
        rep = nh // kvh
        ckx = ck.repeat_interleave(rep, dim=2) if rep > 1 else ck
        cvx = cv.repeat_interleave(rep, dim=2) if rep > 1 else cv
        s = torch.einsum(
            "bqhd,bkhd->bhqk", (q * weak_scalar(1.0 / math.sqrt(hd), q)).float(), ckx.float()
        )
        pattn = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", pattn.to(cvx.dtype).float(), cvx.float())
        o = o.to(cvx.dtype).reshape(B, 1, nh * hd)
        x = x + linear(o, p["cross_attn"]["wo"])
        x = x + mlp_apply(p["mlp"], _ln(x, p["ln2"], cfg.norm_eps), "gelu")
    x = _ln(x, params["dec_ln"], cfg.norm_eps)
    logits = linear(x, params["embed"].T)[:, 0]
    return logits, caches
