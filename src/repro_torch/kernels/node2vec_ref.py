"""Independent plain-PyTorch oracle for one fused-kernel hop (view-pair layout).

The port of ``repro/kernels/node2vec_ref.py``.  It deliberately shares *no*
search code with the kernel or with :mod:`repro_torch.engines.step`: row
lookup and neighbourhood membership are dense comparison sweeps over the
flat packed arrays (exact lower bounds, no binary search), so a bug in the
fixed-iteration searches cannot cancel out of the comparison.  Uniforms are
an explicit input — the caller supplies the counter-keyed draws (see
:mod:`repro_torch.kernels.rng`), keeping this a pure function.

Its memory is O(lanes x pair entries) per sweep, so it runs only at small
shapes.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["node2vec_step_ref"]


def _at(flat, idx):
    """``flat[idx]`` with the index clamped to the array, as jnp gathers."""
    return flat[idx.clamp(0, flat.shape[0] - 1)]


def node2vec_step_ref(
    vids,  # [SV] i32 — both slots' sorted global vertex ids, concatenated
    nverts,  # [2] i32
    vid_base,  # [2] i32
    indptr,  # [SP] i32
    ptr_base,  # [2] i32
    indices,  # [SE] i32
    ind_base,  # [2] i32
    alias_j,  # [SE] i32 ([1] dummy if not has_alias)
    alias_q,  # [SE] f32
    prev,  # [N] i32
    cur,  # [N] i32
    hop,  # [N] i32
    active,  # [N] bool
    unif,  # [N, k_max, 3] f32 — counter-keyed uniforms, caller-supplied
    *,
    p: float = 1.0,
    q: float = 1.0,
    order: int = 2,
    k_max: int = 4,
    has_alias: bool = False,
):
    """One walk hop; same decision sequence as the fused kernel's loop body.
    Returns ``(z, moved)``, both [N] int32."""
    dev = cur.device
    i64 = torch.int64
    f32 = torch.float32
    # the acceptance biases in float32, as the reference's jnp arithmetic
    one = np.float32(1.0)
    inv_p, inv_q = one / np.float32(p), one / np.float32(q)
    max_bias = max(one, max(inv_p, inv_q))
    acc_ret, acc_nbr, acc_away = (
        torch.tensor(float(b / max_bias), dtype=f32, device=dev) for b in (inv_p, one, inv_q)
    )
    ones = torch.ones((), dtype=f32, device=dev)
    active = active.to(torch.bool)
    vids = vids.to(i64)
    indptr = indptr.to(i64)
    indices = indices.to(i64)
    alias_j = alias_j.to(i64)
    prev = prev.to(i64)
    cur = cur.to(i64)
    nverts, vid_base, ptr_base, ind_base = (
        t.to(i64) for t in (nverts, vid_base, ptr_base, ind_base)
    )
    v_ar = torch.arange(vids.shape[0], device=dev)
    e_ar = torch.arange(indices.shape[0], device=dev)

    def locate(v):
        """Dense exact lower bound per slot: row = #{vids in segment < v}."""
        vcol = v[:, None]
        seg0 = (v_ar >= vid_base[0]) & (v_ar < vid_base[0] + nverts[0])
        seg1 = (v_ar >= vid_base[1]) & (v_ar < vid_base[1] + nverts[1])
        row0 = (seg0 & (vids[None, :] < vcol)).sum(dim=1)
        row1 = (seg1 & (vids[None, :] < vcol)).sum(dim=1)
        found0 = (seg0 & (vids[None, :] == vcol)).any(dim=1)
        found1 = (seg1 & (vids[None, :] == vcol)).any(dim=1)
        slot = torch.where(found0, 0, 1)
        row = torch.where(found0, row0, row1)
        return slot, row, found0 | found1

    slot, row, resident = locate(cur)
    row_start = _at(indptr, ptr_base[slot] + row)
    deg = _at(indptr, ptr_base[slot] + row + 1) - row_start
    movable = active & resident & (deg > 0)
    deg_c = deg.clamp(min=1)

    if order == 2:
        uslot, urow, _ = locate(prev)
        u_start = _at(indptr, ptr_base[uslot] + urow)
        ulo = ind_base[uslot] + u_start
        uhi = ulo + (_at(indptr, ptr_base[uslot] + urow + 1) - u_start)
        in_row = (e_ar >= ulo[:, None]) & (e_ar < uhi[:, None])

    z = cur
    accepted = ~movable
    for kk in range(k_max):
        u1, u2, u3 = unif[:, kk, 0], unif[:, kk, 1], unif[:, kk, 2]
        kloc = torch.minimum((u1 * deg_c.to(f32)).to(i64), deg_c - 1)
        idx = ind_base[slot] + row_start + kloc
        if has_alias:
            kloc = torch.where(u2 >= _at(alias_q, idx), _at(alias_j, idx), kloc)
            idx = ind_base[slot] + row_start + kloc
        zk = _at(indices, idx)
        if order == 2:
            memb = (in_row & (indices[None, :] == zk[:, None])).any(dim=1)
            bias = torch.where(zk == prev, acc_ret, torch.where(memb, acc_nbr, acc_away))
            acc_p = torch.where(hop == 0, ones, bias)
        else:
            acc_p = torch.ones_like(u3)
        last = kk == k_max - 1
        take = (~accepted) & movable & ((u3 < acc_p) | last)
        z = torch.where(take, zk, z)
        accepted = accepted | take

    return z.to(torch.int32), movable.to(torch.int32)
