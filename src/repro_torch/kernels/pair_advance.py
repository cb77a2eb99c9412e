"""The fused multi-hop pair advance: a hand-written CUDA kernel for Hopper.

This is Alg. 2's ``UpdateWalk`` loop — the compute hot-spot of the bi-block
engine — as one kernel launch: the vids-remap binary search, the
alias/uniform proposal, second-order rejection with binary-search
membership, the termination/decay draw and the trace write.  It replaces
the Pallas TPU kernel ``pair_advance_kernel`` of
``repro/kernels/pair_advance.py``; the source and its design note are in
``csrc/pair_advance.cu``.

:func:`fused_advance_pair` takes the plain PyTorch version
(:func:`repro_torch.engines.step.pair_advance_ref`) for tensors on the CPU,
and launches the kernel for tensors on a CUDA device (or raises).  Both
return ``(prev, cur, hop, alive, steps, trace)`` and are bit-identical.
Given a ``corpus`` (an engine's ``[W, max_len + 1]`` walks), both write
each recorded step into its walk's row there instead of a trace.
``fused_advance_pair.launches`` counts kernel launches, and
:func:`contiguous_slots` says which slots the last launch remapped in O(1).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.engines.step import accept_thresholds, pair_advance_ref

from . import build

__all__ = ["contiguous_slots", "fused_advance_pair", "pair_advance_ref"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
#: argument types of ``pair_advance_launch`` in csrc/pair_advance.cu
_ARGTYPES = (
    [_P, _I, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _I]  # the pair
    + [_P] * 5  # lanes in
    + [_P] * 7  # lanes out, trace, steps, slot_flags
    + [_I, _U, _U, _I, _F, _F, _F, _F]  # n, key, length, decay, thresholds
    + [_I] * 9  # order, k_max, n_iters, v_iters, record, has_alias, corpus rows, max_len, hops
    + [_P]  # stream
)


def _kernel():
    lib = build.load("pair_advance")
    fn = lib.pair_advance_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _prepare(args, lanes, key, length, decay, p, q, *, order, k_max, n_iters, v_iters, record,
             has_alias, max_len, max_hops=None, corpus=None):  # fmt: skip
    """Check CUDA inputs, allocate the outputs, and return them with a
    plan for :func:`_launch`: the device, the kernel's ctypes argument list
    and the slot flags (the plan keeps the outputs it points at alive)."""
    vids, nverts, vid_base, indptr, ptr_base, indices, ind_base, alias_j, alias_q = args
    wid, prev, cur, hop, alive = lanes
    dev = prev.device
    i32 = torch.int32
    for name, t in zip(
        ("vids", "nverts", "vid_base", "indptr", "ptr_base", "indices", "ind_base", "alias_j"),
        args[:8],
    ):
        _check(name, t, i32, dev)
    _check("alias_q", alias_q, torch.float32, dev)
    for name, t in zip(("wid", "prev", "cur", "hop"), lanes[:4]):
        _check(name, t, i32, dev)
    _check("alive", alive, torch.bool, dev)
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    if k_max < 1:
        raise ValueError(f"k_max must be >= 1, got {k_max}")
    hops = max_len + 1 if max_hops is None else int(max_hops)
    n = prev.shape[0]
    if any(t.shape != (n,) for t in lanes):
        raise ValueError("wid/prev/cur/hop/alive must all be [N]")
    if any(t.numel() != 2 for t in (nverts, vid_base, ptr_base, ind_base)):
        raise ValueError("nverts/vid_base/ptr_base/ind_base must hold one entry per slot")
    if min(vids.numel(), indptr.numel(), indices.numel(), alias_q.numel()) == 0:
        raise ValueError("the packed pair arrays must not be empty")
    if has_alias and not (alias_j.shape == alias_q.shape == indices.shape):
        raise ValueError("alias tables must align with indices")
    if corpus is not None:
        _check("corpus", corpus, i32, dev)
        if corpus.dim() != 2 or corpus.shape[0] == 0 or corpus.shape[1] != max_len + 1:
            raise ValueError(f"corpus must be [W, max_len + 1] = [W, {max_len + 1}]")
    into_corpus = record and corpus is not None

    with torch.cuda.device(dev):
        prev_out = torch.empty_like(prev)
        cur_out = torch.empty_like(cur)
        hop_out = torch.empty_like(hop)
        alive_out = torch.empty_like(alive)
        # recording into the corpus, the trace is the [1, 1] placeholder
        # of a call that records nothing
        shape = (n, max_len + 1) if record and not into_corpus else (1, 1)
        trace = torch.full(shape, -1, dtype=i32, device=dev)
        counts = torch.zeros(3, dtype=i32, device=dev)  # the step count and two slot flags
        steps, flags = counts[0], counts[1:]
        stream = torch.cuda.current_stream(dev).cuda_stream
    acc_ret, acc_nbr, acc_away = (float(a) for a in accept_thresholds(p, q))
    k0, k1 = (int(k) & 0xFFFFFFFF for k in key)
    cargs = (
        vids.data_ptr(), vids.numel(), nverts.data_ptr(), vid_base.data_ptr(),
        indptr.data_ptr(), indptr.numel(), ptr_base.data_ptr(), indices.data_ptr(),
        indices.numel(), ind_base.data_ptr(), alias_j.data_ptr(), alias_q.data_ptr(),
        alias_q.numel(),
        *(t.data_ptr() for t in lanes),
        *(t.data_ptr() for t in (prev_out, cur_out, hop_out, alive_out)),
        (corpus if into_corpus else trace).data_ptr(), steps.data_ptr(), flags.data_ptr(),
        n, k0, k1, int(length), float(decay), acc_ret, acc_nbr, acc_away,
        order, k_max, n_iters, v_iters, int(bool(record)), int(bool(has_alias)),
        corpus.shape[0] if into_corpus else 0, max_len, hops, stream,
    )  # fmt: skip
    outs = (prev_out, cur_out, hop_out, alive_out, steps, trace)
    return outs, (dev, cargs, flags, outs, corpus)


def _launch(plan) -> None:
    """Launch the kernel once on an argument list made by :func:`_prepare`.
    Relaunching it rewrites the lanes and trace (or corpus) and adds to
    ``steps`` (the slot check it runs first finds the same flags on the
    same pair)."""
    dev, cargs = plan[:2]
    with torch.cuda.device(dev):
        rc = _kernel()(*cargs)
    if rc != 0:
        raise RuntimeError(f"pair_advance kernel launch failed: CUDA error {rc}")


def fused_advance_pair(
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
    alive,
    key,
    length,
    decay,
    p,
    q,
    *,
    order: int,
    k_max: int,
    n_iters: int,
    v_iters: int,
    record: bool,
    has_alias: bool,
    max_len: int,
    max_hops: int | None = None,
    corpus=None,
):
    """Advance every walk until it leaves the resident view pair or
    terminates, for at most ``max_hops`` hops (``None``: ``max_len + 1``,
    the full sweep; 1 gives the single-hop form of
    :mod:`repro_torch.kernels.ops`); the argument list and return contract
    of :func:`~repro_torch.engines.step.pair_advance_ref`, ``corpus``
    included (an int32 ``[W, max_len + 1]`` tensor, contiguous, on the
    lanes' device)."""
    kw = dict(
        order=order,
        k_max=k_max,
        n_iters=n_iters,
        v_iters=v_iters,
        record=record,
        has_alias=has_alias,
        max_len=max_len,
        max_hops=max_hops,
        corpus=corpus,
    )
    args = (vids, nverts, vid_base, indptr, ptr_base, indices, ind_base, alias_j, alias_q)
    lanes = (wid, prev, cur, hop, alive)
    dev = prev.device
    if dev.type == "cpu":
        return pair_advance_ref(*args, *lanes, key, length, decay, p, q, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_advance_pair runs on cuda or cpu tensors, got {dev}")
    outs, plan = _prepare(args, lanes, key, length, decay, p, q, **kw)
    _launch(plan)
    fused_advance_pair.launches += 1
    global _last_flags
    _last_flags = plan[2]
    return outs


#: kernel launches since the last reset (CPU calls do not count)
fused_advance_pair.launches = 0
_last_flags = None


def contiguous_slots() -> list[bool]:
    """Per slot of the pair that :func:`fused_advance_pair` last launched the
    kernel on: True where the kernel's slot check found one contiguous run
    of ids and remapped in O(1), False where it kept the search.  A slot 1
    with slot 0's segment takes slot 0's answer.  Waits for the launch."""
    if _last_flags is None:
        raise RuntimeError("fused_advance_pair has not launched the kernel yet")
    return [f == 0 for f in _last_flags.tolist()]
