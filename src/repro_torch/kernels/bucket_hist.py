"""The bucket histogram: a hand-written CUDA kernel for Hopper.

Counts the valid walks per bucket id — the count pass of the bucket-based
walk management (§4.3.2), a counting sort keyed by the walk's bucket id.
It replaces the Pallas TPU kernel ``_kernel`` of
``repro/kernels/bucket_hist.py``; the source and its design note are in
``csrc/bucket_hist.cu``.

:func:`bucket_hist_kernel` takes the plain PyTorch version
(:func:`bucket_hist_ref`) for tensors on the CPU, and launches the kernel
for tensors on a CUDA device (or raises).  Both return ``[num_buckets]``
int32 counts and are bit-identical.  Ids outside ``[0, num_buckets)``,
negative ones included, are not counted, as the TPU kernel's one-hot
comparison counts none of them.  ``bucket_hist_kernel.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["HIST_TILE", "SHARED_BINS_MAX", "bucket_hist_kernel", "bucket_hist_ref"]

#: lanes per tile: the walk count must be a multiple of it (the TPU grid step)
HIST_TILE = 1024
#: most bins one block keeps in shared memory: Hopper's 227 KB opt-in limit
#: over 4-byte bins; more bins take the global-atomic path
SHARED_BINS_MAX = 232448 // 4
#: one-hot elements the plain version materialises at once
_ONEHOT_ELEMS = 1 << 24

_P = ctypes.c_void_p
_I = ctypes.c_int
#: argument types of ``bucket_hist_launch`` in csrc/bucket_hist.cu
_ARGTYPES = [_P, _P, _I, _I, _P, _I, _P]


def _kernel():
    lib = build.load("bucket_hist")
    fn = lib.bucket_hist_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _validate(ids, valid, num_buckets: int, tile: int) -> None:
    if ids.dtype != torch.int32:
        raise TypeError(f"ids has dtype {ids.dtype}, expected torch.int32")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid has dtype {valid.dtype}, expected torch.bool")
    if ids.dim() != 1 or valid.shape != ids.shape:
        raise ValueError("ids and valid must both be [N]")
    if valid.device != ids.device:
        raise ValueError(f"valid is on {valid.device}, expected {ids.device}")
    if not (ids.is_contiguous() and valid.is_contiguous()):
        raise ValueError("ids and valid must be contiguous")
    if num_buckets < 0:
        raise ValueError(f"num_buckets must be >= 0, got {num_buckets}")
    if ids.shape[0] % tile:
        raise ValueError(f"walk count {ids.shape[0]} must be a multiple of {tile}")


def bucket_hist_ref(ids, valid, *, num_buckets: int, tile: int = HIST_TILE):
    """Plain PyTorch version: per tile, a ``[tile, NB]`` one-hot sum, as the
    TPU kernel reduces it, added over the tiles.  The one-hot is built in
    chunks of tiles and bins, so its memory stays bounded at large NB."""
    _validate(ids, valid, num_buckets, tile)
    dev = ids.device
    out = torch.zeros(num_buckets, dtype=torch.int64, device=dev)
    if ids.numel() == 0 or num_buckets == 0:
        return out.to(torch.int32)
    # an invalid lane takes id -1, which no bin matches
    keyed = torch.where(valid, ids, -1).view(-1, tile)
    width = min(num_buckets, max(1, _ONEHOT_ELEMS // tile))
    tiles_per_step = max(1, _ONEHOT_ELEMS // (tile * width))
    for b0 in range(0, num_buckets, width):
        bins = torch.arange(b0, min(b0 + width, num_buckets), dtype=torch.int32, device=dev)
        for t0 in range(0, keyed.shape[0], tiles_per_step):
            onehot = keyed[t0 : t0 + tiles_per_step, :, None] == bins  # [tiles, tile, bins]
            out[b0 : b0 + bins.numel()] += onehot.sum(dim=1).sum(dim=0)
    return out.to(torch.int32)


def _launch(ids, valid, out, *, shared: bool) -> None:
    """Launch the kernel once, adding the counts into ``out`` ([NB] int32
    on the same device; the caller zeroes it)."""
    dev = ids.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel()(
            ids.data_ptr(), valid.data_ptr(), ids.numel(), out.numel(), out.data_ptr(),
            int(bool(shared)), stream,
        )  # fmt: skip
    if rc != 0:
        raise RuntimeError(f"bucket_hist kernel launch failed: CUDA error {rc}")


def bucket_hist_kernel(ids, valid, *, num_buckets: int, tile: int = HIST_TILE):
    """Count valid walks per bucket.  ``ids``: [N] int32; ``valid``: [N]
    bool; ``N`` a multiple of ``tile``.  Returns [num_buckets] int32."""
    _validate(ids, valid, num_buckets, tile)
    dev = ids.device
    if dev.type == "cpu":
        return bucket_hist_ref(ids, valid, num_buckets=num_buckets, tile=tile)
    if dev.type != "cuda":
        raise ValueError(f"bucket_hist_kernel runs on cuda or cpu tensors, got {dev}")
    out = torch.zeros(num_buckets, dtype=torch.int32, device=dev)
    if ids.numel() == 0 or num_buckets == 0:
        return out
    _launch(ids, valid, out, shared=num_buckets <= SHARED_BINS_MAX)
    bucket_hist_kernel.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
bucket_hist_kernel.launches = 0
