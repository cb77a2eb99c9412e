"""Model substrate: config schema, norms, embeddings, RoPE, MLPs, init.

The port of ``repro/models/common.py``.  One :class:`ModelConfig` describes
every assigned architecture; the layer stack is expressed as *segments* —
``(pattern, n_groups)`` pairs where ``pattern`` is a tuple of block kinds
(e.g. ``('rglru','rglru','local')``) repeated ``n_groups`` times with
parameters stacked on a leading group axis, as the JAX package stacks them.
Homogeneous models are the special case ``((kind,), n_layers)``.

The numerics follow the JAX module step for step (norms in float32, RoPE
frequencies as ``exp(-log(theta) * i / dim)``, the tanh GELU), so that the
same weights give the same activations.  Initial weights come from an
explicit ``torch.Generator`` and differ from ``jax.random``'s;
:func:`repro_torch.convert.lm_params_from_arrays` carries the JAX package's
weights across instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "ModelConfig",
    "rms_norm",
    "layer_norm",
    "rope",
    "apply_rope",
    "dense_init",
    "mlp_apply",
    "mlp_init",
    "padded_vocab",
]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    segments: Tuple[Tuple[Tuple[str, ...], int], ...]  # ((pattern), n_groups)
    # attention
    window: Optional[int] = None  # sliding window for 'local' blocks / SWA
    qkv_bias: bool = False
    rope_theta: float = 1e4
    # mlp
    mlp_type: str = "swiglu"  # 'swiglu' | 'geglu' | 'gelu'
    # MoE (0 experts = dense)
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    moe_shard_experts: bool = False  # EP when n_experts % model axis == 0
    #: store each expert's gated FFN as `split` column-sliced *virtual
    #: experts* (exact for gated MLPs)
    moe_virtual_split: int = 1
    capacity_factor: float = 1.25
    # MLA
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    # RG-LRU
    lru_width: int = 0
    # enc-dec
    n_encoder_layers: int = 0
    learned_pos: bool = False
    max_pos: int = 0  # learned-position table size (enc-dec)
    # frontend stubs
    frontend: Optional[str] = None  # 'vision' | 'audio' | None
    num_prefix: int = 0  # patch embeddings prepended ([vlm])
    # numerics
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    #: activation rematerialisation for training: 'none' | 'nothing' | 'dots'
    remat_policy: str = "nothing"
    #: gradient-accumulation microbatches for training
    train_microbatches: int = 1
    # serve-ability flags
    subquadratic: bool = False  # may run long_500k
    skip_decode: bool = False  # encoder-only archs

    # ----- derived -----------------------------------------------------------
    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        out = []
        for pattern, n in self.segments:
            out.extend(list(pattern) * n)
        return tuple(out)

    @property
    def vocab_padded(self) -> int:
        return padded_vocab(self.vocab_size)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def d_inner(self) -> int:  # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Total parameter count (exact, from the init shapes on the meta
        device: nothing is allocated)."""
        from .registry import init_params_shape  # local: avoid cycle

        return sum(x.numel() for x in tree_leaves(init_params_shape(self)))

    def active_param_count(self) -> int:
        """Active-per-token params (MoE counts top_k + shared experts)."""
        if self.n_experts == 0:
            return self.param_count()
        from .registry import init_params_shape

        shapes = init_params_shape(self)
        total = sum(x.numel() for x in tree_leaves(shapes))
        moe_total = sum(
            x.numel()
            for path, x in tree_leaves_with_path(shapes)
            if "experts" in path and "shared" not in path
        )
        return total - moe_total + moe_total * self.top_k // max(self.n_experts, 1)


def padded_vocab(v: int, multiple: int = 256) -> int:
    """Vocab padded for clean sharding over the 16-way model axis."""
    return int(math.ceil(v / multiple) * multiple)


# ---------------------------------------------------------------------------
# parameter trees (nested dicts and lists of tensors, as the JAX pytrees)
# ---------------------------------------------------------------------------


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of ``rest`` (same structure:
    raises ``ValueError`` where keys or lengths differ)."""
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError(f"tree keys differ: {sorted(tree)} against {r!r:.200}")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        for r in rest:
            if not isinstance(r, (list, tuple)) or len(r) != len(tree):
                raise ValueError(f"tree lengths differ: {len(tree)} against {r!r:.200}")
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves_with_path(tree, path: str = ""):
    """``(path, leaf)`` pairs, the path's keys and indices joined by ``/``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(path, tree)]
    return [pl for k, sub in items for pl in tree_leaves_with_path(sub, f"{path}/{k}")]


def tree_leaves(tree):
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure over ``leaves``, in ``tree_leaves``'s order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


def linear(x, w):
    """``x @ w`` for activations x [..., D] and a weight w [D, E].  Of
    DTensors it is ``sharding.context.sharded_linear``, a product on each
    rank's shards."""
    if type(x) is torch.Tensor and type(w) is torch.Tensor:
        return x @ w
    from repro_torch.sharding.context import is_dtensor, sharded_linear

    return sharded_linear(x, w) if is_dtensor(x) or is_dtensor(w) else x @ w


def embed_lookup(table, ids):
    """``table[ids]``.  Of a DTensor table it is ``F.embedding``, which
    DTensor splits over the table's rows (its rule for the index gathers
    the ids and so the whole batch), with the rows' partial sums taken."""
    from repro_torch.sharding.context import is_dtensor, reduced

    return reduced(F.embedding(ids, table)) if is_dtensor(table) else table[ids]


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def rope(positions, dim: int, theta: float):
    """Rotary tables: returns (sin, cos) of shape [..., dim/2]."""
    dev = positions.device
    # torch.full, not torch.tensor: a fill on the device, no copy from the host
    log_theta = torch.log(torch.full((), theta, dtype=torch.float32, device=dev))
    freqs = torch.exp(-log_theta * torch.arange(0, dim, 2, dtype=torch.float32, device=dev) / dim)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: [..., S, H, D]; sin/cos: [..., S, D/2] (broadcast over heads)."""
    x1, x2 = x.chunk(2, dim=-1)
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def weak_scalar(value: float, like):
    """``value`` as a 0-d tensor of ``like``'s dtype: a Python scalar times a
    JAX array takes the array's dtype before the product, where PyTorch
    would keep it in float32."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# init + dense MLPs
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None):
    """Normal draws from ``gen`` times ``scale`` (default 1/sqrt(fan_in)), on
    the default device (``registry.model_init`` sets it)."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    # scaled in place: one float32 temporary, not two (10 GB each for
    # deepseek's stacked experts)
    return torch.randn(shape, generator=gen, dtype=torch.float32).mul_(s).to(dtype)


def mlp_init(gen: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    gated = cfg.mlp_type in ("swiglu", "geglu")
    return {
        "w_in": dense_init(gen, (d, 2 * f if gated else f), cfg.dtype),
        "w_out": dense_init(gen, (f, d), cfg.dtype),
    }


def mlp_apply(params, x, mlp_type: str):
    h = linear(x, params["w_in"])
    if mlp_type in ("swiglu", "geglu"):
        g, u = h.chunk(2, dim=-1)
        # jax.nn.gelu is the tanh approximation by default
        act = F.silu(g) if mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * u
    else:
        h = F.gelu(h, approximate="tanh")
    return linear(h, params["w_out"])
