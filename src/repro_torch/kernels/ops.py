"""Public single-hop wrappers for the walk-step kernel (view-pair layout).

The port of ``repro/kernels/ops.py``.  ``node2vec_step`` is the single-hop
form of the fused advance: with ``use_kernel=True`` it runs
:func:`repro_torch.kernels.pair_advance.fused_advance_pair` capped at one
hop (``max_hops=1``, termination disabled) — the hand-written CUDA kernel
for CUDA tensors, its plain version for CPU tensors; with
``use_kernel=False`` it draws the same counter-keyed uniforms through
:mod:`repro_torch.kernels.rng` and feeds the independent dense oracle
:func:`repro_torch.kernels.node2vec_ref.node2vec_step_ref`.  The two paths
agree bit for bit — that equality is what validates the kernel's internal
RNG and sampling logic.

The key is the raw ``(k0, k1)`` pair, as everywhere in the port.  The JAX
wrappers' ``interpret`` and ``walk_tile`` select the Pallas lowering and
have no counterpart here.
"""

from __future__ import annotations

import torch

from . import pair_advance as _pair_advance
from . import rng
from .node2vec_ref import node2vec_step_ref

__all__ = ["node2vec_step", "alias_step"]

#: walk length that never finishes a walk within one hop
_NEVER = 2**31 - 1


def node2vec_step(
    vids,
    nverts,
    vid_base,
    indptr,
    ptr_base,
    indices,
    ind_base,
    alias_j,
    alias_q,
    wid,
    prev,
    cur,
    hop,
    active,
    key,
    *,
    p: float = 1.0,
    q: float = 1.0,
    order: int = 2,
    k_max: int = 4,
    n_iters: int = 24,
    v_iters: int = 12,
    has_alias: bool = False,
    use_kernel: bool = True,
):
    """One walk hop for a batch over a resident pair.  Returns
    ``(z, moved)``, both [N] int32."""
    if use_kernel:
        _, cur_f, hop_f, _, _, _ = _pair_advance.fused_advance_pair(
            vids,
            nverts,
            vid_base,
            indptr,
            ptr_base,
            indices,
            ind_base,
            alias_j,
            alias_q,
            wid,
            prev,
            cur,
            hop,
            active,
            key,
            _NEVER,  # never length-finished
            1.0,  # never decay-stopped
            p,
            q,
            order=order,
            k_max=k_max,
            n_iters=n_iters,
            v_iters=v_iters,
            record=False,
            has_alias=has_alias,
            max_len=1,
            max_hops=1,
        )
        return cur_f, hop_f - hop
    # reference path: materialise the counter-keyed draws explicitly —
    # (base_key, walk_id, hop, round), exactly the kernel's fold chain
    kw0, kw1 = rng.fold_in(*rng.fold_in(key[0], key[1], wid), hop)
    unif = torch.stack(
        [torch.stack(rng.uniform3(*rng.fold_in(kw0, kw1, kk)), dim=-1) for kk in range(k_max)],
        dim=1,
    )
    return node2vec_step_ref(
        vids,
        nverts,
        vid_base,
        indptr,
        ptr_base,
        indices,
        ind_base,
        alias_j,
        alias_q,
        prev,
        cur,
        hop,
        active,
        unif,
        p=p,
        q=q,
        order=order,
        k_max=k_max,
        has_alias=has_alias,
    )


def alias_step(
    vids,
    nverts,
    vid_base,
    indptr,
    ptr_base,
    indices,
    ind_base,
    alias_j,
    alias_q,
    wid,
    cur,
    active,
    key,
    *,
    v_iters: int = 12,
    has_alias: bool = True,
    use_kernel: bool = True,
):
    """First-order (DeepWalk) hop: alias/uniform neighbour draw."""
    zero = torch.zeros_like(cur)
    return node2vec_step(
        vids,
        nverts,
        vid_base,
        indptr,
        ptr_base,
        indices,
        ind_base,
        alias_j,
        alias_q,
        wid,
        zero,
        cur,
        zero,
        active,
        key,
        p=1.0,
        q=1.0,
        order=1,
        k_max=1,
        n_iters=1,
        v_iters=v_iters,
        has_alias=has_alias,
        use_kernel=use_kernel,
    )
