"""Decoder-only LM assembly over layer segments.

The port of ``repro/models/transformer.py``.  A config's ``segments`` is a
tuple of ``(pattern, n_groups)``; each pattern entry is
``"<block>[+<mlp>]"`` with block in {attn, local, mla, ssd, rglru} and mlp
in {mlp, moe}.

The parameter and cache trees have the JAX package's layout: a segment's
tensors are stacked on a leading group axis (as ``jax.vmap`` and
``lax.scan`` stack them), and the layers are walked with a Python loop over
that axis.  Activations are pinned with ``sharding.context.constrain`` at
the JAX module's three points (the embedding output, each group's carry,
the logits): the identity on a plain tensor, a ``redistribute`` on a
DTensor.

The same assembly serves:
  * ``forward``      — teacher-forced logits (VLM prefix included); under
                       autograd (training) each group runs under
                       ``cfg.remat_policy`` (:func:`apply_remat`)
  * ``prefill``      — forward + per-layer caches + last-position logits
  * ``decode_step``  — one token against the caches, updated in place
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.context import constrain, last_row, unbound

from .attention import attention_apply, attention_decode, attn_init, init_kv_cache
from .common import (
    ModelConfig,
    dense_init,
    embed_lookup,
    linear,
    mlp_apply,
    mlp_init,
    rms_norm,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from .mla import init_mla_cache, mla_apply, mla_decode, mla_init
from .moe import moe_apply, moe_init
from .rglru import init_rglru_cache, rglru_apply, rglru_decode, rglru_init
from .ssm import init_ssd_cache, ssd_apply, ssd_decode, ssd_init

__all__ = [
    "init_params",
    "forward",
    "prefill",
    "decode_step",
    "init_caches",
    "parse_kind",
]

def parse_kind(kind: str) -> Tuple[str, Optional[str]]:
    if "+" in kind:
        b, m = kind.split("+")
        return b, m
    return kind, None


def _check_kind(kind: str) -> Tuple[str, Optional[str]]:
    """``parse_kind``, raising ``ValueError`` on an unknown kind."""
    block, mlp = parse_kind(kind)
    if block not in ("attn", "local", "mla", "ssd", "rglru"):
        raise ValueError(f"unknown block kind {block!r}")
    if mlp not in (None, "mlp", "moe"):
        raise ValueError(f"unknown mlp kind {mlp!r}")
    return block, mlp


def _unbind(tree, n: int):
    """The ``n`` groups of a stacked segment tree (views, not copies)."""
    parts = [unbound(t) for t in tree_leaves(tree)]
    return [tree_unflatten(tree, [p[g] for p in parts]) for g in range(n)]


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _block_init(gen: torch.Generator, kind: str, cfg: ModelConfig) -> dict:
    block, mlp = _check_kind(kind)
    p: Dict[str, Any] = {"norm1": torch.zeros((cfg.d_model,), dtype=torch.float32)}
    if block == "ssd":
        p["ssd"] = ssd_init(gen, cfg)
    elif block == "rglru":
        p["rglru"] = rglru_init(gen, cfg)
    else:
        p["attn"] = mla_init(gen, cfg) if block == "mla" else attn_init(gen, cfg)
    if mlp is not None:
        p["norm2"] = torch.zeros((cfg.d_model,), dtype=torch.float32)
        p[mlp] = mlp_init(gen, cfg) if mlp == "mlp" else moe_init(gen, cfg)
    return p


def _stacked_groups(make, n_groups: int):
    """``_stack([make() for _ in range(n_groups)])``, the groups made in
    that order, each copied into the stacked tensors as soon as it is made:
    one group is alive beside the segment, not all of them."""
    out = None
    for g in range(n_groups):
        group = make()
        if out is None:
            out = tree_map(lambda x: x.new_empty((n_groups, *x.shape)), group)
        tree_map(lambda o, x: o[g].copy_(x), out, group)
        group = None  # freed before the next group's draws
    return out


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Parameters on the default device, every draw from ``gen``."""
    vp = cfg.vocab_padded
    params: Dict[str, Any] = {
        "embed": dense_init(gen, (vp, cfg.d_model), cfg.dtype, scale=0.02),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, vp), cfg.dtype)
    params["segments"] = [
        _stacked_groups(
            lambda pattern=pattern: {
                f"pos{j}": _block_init(gen, kind, cfg) for j, kind in enumerate(pattern)
            },
            n_groups,
        )
        for pattern, n_groups in cfg.segments
    ]
    return params


# ---------------------------------------------------------------------------
# forward (prefill body)
# ---------------------------------------------------------------------------


def _apply_block(p, x, kind: str, cfg: ModelConfig, *, collect_cache: bool):
    """One layer. Returns (x, cache_or_None, aux)."""
    block, mlp = _check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    cache = None
    if block in ("ssd", "rglru"):
        out, st = (ssd_apply if block == "ssd" else rglru_apply)(p[block], h, cfg)
        if collect_cache:
            cache = st
    elif block == "mla":
        out, lat = mla_apply(p["attn"], h, cfg)
        if collect_cache:
            cache = {"ckv": lat}
    else:
        window = cfg.window if block == "local" else None
        out, (k, v) = attention_apply(p["attn"], h, cfg, window=window)
        if collect_cache:
            if window and k.shape[1] > window:
                # ring-buffer layout: decode stores position p at slot p % W,
                # so the retained window must be rolled to match
                S = k.shape[1]
                k = torch.roll(k[:, -window:], S % window, dims=1)
                v = torch.roll(v[:, -window:], S % window, dims=1)
            cache = {"k": k, "v": v}
    x = x + out
    if mlp == "mlp":
        x = x + mlp_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg.mlp_type)
    elif mlp == "moe":
        out, aux = moe_apply(p["moe"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg)
        x = x + out
    return x, cache, aux


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep the outputs of matrix products
    without batch dimensions (every linear layer), recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def apply_remat(fn, policy: str):
    """Wrap a group body with the configured rematerialisation policy:
    ``"none"`` keeps every activation, ``"nothing"`` recomputes the whole
    body in the backward (``jax.checkpoint``), ``"dots"`` keeps the linear
    layers' outputs (``dots_with_no_batch_dims_saveable``)."""
    if policy == "none":
        return fn
    if policy == "nothing":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots),
        )  # fmt: skip
    raise ValueError(f"unknown remat policy {policy!r}")


def _run_segments(params, x, cfg: ModelConfig, *, collect_cache: bool):
    """Each segment's groups in order. Returns (x, caches per segment, total aux).

    Each group runs under ``cfg.remat_policy`` where autograd records it
    (training); a forward that records nothing (serving) runs it as is."""
    caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for s, (pattern, n_groups) in enumerate(cfg.segments):

        def group_body(x, aux, gp, _pattern=pattern):
            cache_out = {}
            for j, kind in enumerate(_pattern):
                x, c, a = _apply_block(gp[f"pos{j}"], x, kind, cfg, collect_cache=collect_cache)
                aux = aux + a
                cache_out[f"pos{j}"] = c
            # pin the carry's sharding: the saved-for-backward residuals
            # dominate training memory
            return constrain(x, "residual"), aux, cache_out

        remat_body = apply_remat(group_body, cfg.remat_policy)
        seg = params["segments"][s]
        # one view per group from a single unbind: the backward stacks the
        # groups' gradients once instead of adding a full-size zero tensor
        # per group
        groups = _unbind(seg, n_groups)
        recording = torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad for t in tree_leaves(seg))
        )
        body = remat_body if recording else group_body
        seg_caches = []
        for gp in groups:
            x, aux_total, cache_out = body(x, aux_total, gp)
            seg_caches.append(cache_out)
        caches.append(_stack(seg_caches) if collect_cache else None)
    return x, caches, aux_total


def _logits(params, x, cfg: ModelConfig):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    return linear(x, head)


def _hidden(params, tokens, cfg: ModelConfig, *, prefix_embeds=None, collect_cache: bool = False):
    """``forward`` up to the final norm: (hidden [B, S(+P), D], caches, aux)."""
    x = embed_lookup(params["embed"], tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    x = constrain(x, "residual")
    return _run_segments(params, x, cfg, collect_cache=collect_cache)


def _token_logits(params, tokens, prefix_embeds, cfg: ModelConfig):
    """``forward``'s logits over the token positions only (the [vlm]
    prefix's rows leave before the head) and aux.  The same values as
    slicing ``forward``'s logits; on a sequence-split DTensor the slice
    moves [B, S+P, D] hidden rows, not [B, S+P, vocab] logits."""
    x, _, aux = _hidden(params, tokens, cfg, prefix_embeds=prefix_embeds)
    x = constrain(x[:, prefix_embeds.shape[1] :], "residual")
    return constrain(_logits(params, x, cfg), "logits"), aux


def forward(params, tokens, cfg: ModelConfig, *, prefix_embeds=None, collect_cache: bool = False):
    """tokens: [B, S] -> logits [B, S(+P), vocab_padded].

    ``prefix_embeds`` ([B, P, D], the [vlm] frontend stub output) is
    prepended to the token embeddings; logits cover the full sequence, the
    caller slices the token region (``_token_logits`` slices before the
    head).
    """
    x, caches, aux = _hidden(params, tokens, cfg, prefix_embeds=prefix_embeds,
                             collect_cache=collect_cache)  # fmt: skip
    logits = constrain(_logits(params, x, cfg), "logits")
    if collect_cache:
        return logits, caches, aux
    return logits, aux


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_len: int):
    """Zero caches mirroring the segment structure, on the default device."""
    caches = []
    for pattern, n_groups in cfg.segments:
        one_group = {}
        for j, kind in enumerate(pattern):
            block, _ = _check_kind(kind)
            if block == "ssd":
                one_group[f"pos{j}"] = init_ssd_cache(cfg, batch)
            elif block == "rglru":
                one_group[f"pos{j}"] = init_rglru_cache(cfg, batch)
            elif block == "mla":
                one_group[f"pos{j}"] = init_mla_cache(cfg, batch, max_len)
            else:
                window = cfg.window if block == "local" else None
                one_group[f"pos{j}"] = init_kv_cache(cfg, batch, max_len, window=window)
        caches.append(tree_map(lambda x: x.new_zeros((n_groups, *x.shape)), one_group))
    return caches


def prefill(params, tokens, cfg: ModelConfig, *, prefix_embeds=None):
    """Returns (last-position logits [B, V], caches)."""
    logits, caches, _aux = forward(
        params, tokens, cfg, prefix_embeds=prefix_embeds, collect_cache=True
    )
    return last_row(logits, 1), caches


def decode_step(params, token, caches, cache_len, cfg: ModelConfig):
    """token: [B, 1] int; cache_len: int — valid positions in cache.

    Returns (logits [B, vocab_padded], caches).  The caches are updated in
    place: the returned tree is ``caches`` itself, holding what the JAX
    package's ``decode_step`` returns as new caches.
    """
    x = embed_lookup(params["embed"], token)  # [B,1,D]
    for s, (pattern, n_groups) in enumerate(cfg.segments):
        for gp, gc in zip(_unbind(params["segments"][s], n_groups), _unbind(caches[s], n_groups)):
            for j, kind in enumerate(pattern):
                block, mlp = _check_kind(kind)
                p = gp[f"pos{j}"]
                hn = rms_norm(x, p["norm1"], cfg.norm_eps)
                c = gc[f"pos{j}"]
                if block == "ssd":
                    out, _ = ssd_decode(p["ssd"], hn, c, cfg)
                elif block == "rglru":
                    out, _ = rglru_decode(p["rglru"], hn, c, cfg)
                elif block == "mla":
                    out, _ = mla_decode(p["attn"], hn, c, cache_len, cfg)
                else:
                    window = cfg.window if block == "local" else None
                    out, _ = attention_decode(p["attn"], hn, c, cache_len, cfg, window=window)
                x = x + out
                if mlp == "mlp":
                    x = x + mlp_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg.mlp_type)
                elif mlp == "moe":
                    # the aux loss is dropped at decode, as in the JAX step
                    out, _ = moe_apply(p["moe"], rms_norm(x, p["norm2"], cfg.norm_eps), cfg)
                    x = x + out
    return _logits(params, x, cfg)[:, 0], caches
