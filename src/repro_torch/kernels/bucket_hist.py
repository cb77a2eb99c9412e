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

The kernel has three paths (block, range, global); :func:`plan`, a pure
function of the walk count, the bucket count and the card's properties
(:class:`Card`, read once per device by :func:`device_info`), picks one
with its bin ranges and grid.  A call resolves its plan once per shape and
device and reuses it after.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

__all__ = [
    "HIST_TILE", "Card", "Plan", "blocks_per_sm", "bucket_hist_kernel", "bucket_hist_ref",
    "device_info", "plan", "shared_capacity",
]

#: lanes per tile: the walk count must be a multiple of it (the TPU grid step)
HIST_TILE = 1024
#: one-hot elements the plain version materialises at once
_ONEHOT_ELEMS = 1 << 24

#: threads per block of the block and range paths
BLOCK_THREADS = 1024
#: the block path runs two blocks per SM where two fit and each copy still
#: counts at least this many lanes per bin, else one
TWO_PER_SM_LANES_PER_BIN = 14
#: (least lanes per bin, n // nb, for that many bin ranges); fewer lanes
#: per bin than the last entry take the global path
RANGES_BY_LANES_PER_BIN = ((1024, 1), (56, 2), (13, 4))
GLOBAL_THREADS = 256
GLOBAL_BLOCKS_PER_SM = 4

#: path name -> code of ``bucket_hist_launch`` in csrc/bucket_hist.cu
_PATHS = {"block": 0, "range": 0, "global": 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
#: argument types of ``bucket_hist_launch`` in csrc/bucket_hist.cu
_ARGTYPES = [_I, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P]


class Card(NamedTuple):
    """What the plan reads of a card: its SM count, the opt-in shared
    memory of one block, the shared memory and threads one SM holds, and
    the shared memory the runtime reserves per block (bytes)."""

    sms: int
    smem_block: int
    smem_sm: int
    smem_reserved: int
    threads_sm: int


class Plan(NamedTuple):
    """One launch: the path, the bin ranges a copy of the bins is split
    into (1 off the range path), blocks and threads per block.  A block of
    the block and range paths holds ``ceil(nb / ranges)`` bins in shared
    memory; the global path holds none."""

    path: str
    ranges: int
    grid: int
    threads: int


def shared_capacity(smem_block: int) -> int:
    """Most bins the shared-memory paths hold (the last entry's ranges of
    one block's shared memory each); more take the global path."""
    return RANGES_BY_LANES_PER_BIN[-1][1] * (smem_block // 4)


def blocks_per_sm(card: Card, threads: int, smem: int) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes of dynamic shared
    memory that one SM holds at once: by its threads and by its shared
    memory, the runtime's reserve per block included (0 past one block's
    limit).  Registers do not bind: the kernels take at most 26 a thread
    (``ptxas -v``), so two blocks of 1,024 fit an SM's 65,536."""
    if smem > card.smem_block:
        return 0
    return min(card.threads_sm // threads, card.smem_sm // (smem + card.smem_reserved))


def plan(n: int, nb: int, card: Card) -> Plan:
    """The launch for ``n`` walks (a positive multiple of 4) over ``nb``
    buckets on ``card``: its limits are where two sweeps
    (``chip_smoke.py --hist-sweep``, 1,048,576 walks) agree.  Every block
    of the plan is resident at once."""
    if n <= 0 or n % 4 or nb <= 0:
        raise ValueError(f"plan needs n > 0, a multiple of 4, and nb > 0; got n={n}, nb={nb}")
    n4 = n // 4
    by_lanes = next((r for lanes, r in RANGES_BY_LANES_PER_BIN if n // nb >= lanes), None)
    if by_lanes is None or nb > shared_capacity(card.smem_block):
        grid = min(card.sms * GLOBAL_BLOCKS_PER_SM, -(-n4 // GLOBAL_THREADS))
        return Plan("global", 1, grid, GLOBAL_THREADS)
    # the fewest ranges that hold the bins, or more where the lanes ask
    bins_max = card.smem_block // 4
    ranges = next(r for _, r in RANGES_BY_LANES_PER_BIN if r * bins_max >= nb)
    ranges = min(max(ranges, by_lanes), nb)
    per_sm = 1
    if ranges == 1 and n >= TWO_PER_SM_LANES_PER_BIN * nb * 2 * card.sms:
        per_sm = min(2, blocks_per_sm(card, BLOCK_THREADS, nb * 4))
    copies = max(1, min(per_sm * card.sms // ranges, -(-n4 // BLOCK_THREADS)))
    return Plan("block" if ranges == 1 else "range", ranges, copies * ranges, BLOCK_THREADS)


@functools.cache
def _lib():
    lib = build.load("bucket_hist")
    lib.bucket_hist_launch.argtypes = _ARGTYPES
    lib.bucket_hist_launch.restype = _I
    lib.bucket_hist_setup.argtypes = [ctypes.POINTER(_I)]
    lib.bucket_hist_setup.restype = _I
    return lib


#: device index -> its Card
_devices: dict = {}


def device_info(dev=None) -> Card:
    """The :class:`Card` of a CUDA device (an index, a device, or the
    current one), read once per device; the first call also sets the
    kernels' shared-memory limit there."""
    idx = dev if isinstance(dev, int) else torch.device(dev or "cuda").index
    if idx is None:
        idx = torch.cuda.current_device()
    card = _devices.get(idx)
    if card is None:
        props = (_I * len(Card._fields))()
        with torch.cuda.device(idx):
            rc = _lib().bucket_hist_setup(props)
        if rc != 0:
            raise RuntimeError(f"bucket_hist set-up failed on cuda:{idx}: CUDA error {rc}")
        card = _devices[idx] = Card(*props)
    return card


@functools.lru_cache(maxsize=1024)
def _plan_args(idx: int, n: int, nb: int) -> tuple:
    """The plan's arguments of ``bucket_hist_launch`` for one shape on
    device ``idx``, resolved once."""
    return _c_args(plan(n, nb, device_info(idx)))


def _c_args(p: Plan) -> tuple:
    return _PATHS[p.path], p.ranges, p.grid, p.threads


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


def _check_aligned(ids, valid) -> tuple:
    """The addresses of ``ids`` and ``valid``, which the kernel reads four
    lanes at a time: 16 bytes of ids, 4 of flags."""
    ids_p, valid_p = ids.data_ptr(), valid.data_ptr()
    if ids_p % 16 or valid_p % 4:
        raise ValueError(
            "ids must start on a 16-byte boundary and valid on a 4-byte one "
            f"(at {ids_p:#x} and {valid_p:#x}); pass a .clone()"
        )
    return ids_p, valid_p


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


def _run(ids_p: int, valid_p: int, n: int, out, args: tuple, zero: bool, dev) -> None:
    """One call of ``bucket_hist_launch`` on ``dev``'s current stream."""
    rc = _lib().bucket_hist_launch(
        dev.index, ids_p, valid_p, n, out.numel(), out.data_ptr(), *args, int(zero),
        torch.cuda.current_stream(dev).cuda_stream,
    )  # fmt: skip
    if rc != 0:
        raise RuntimeError(f"bucket_hist kernel launch failed: CUDA error {rc}")


def _launch(ids, valid, out, *, forced: Plan | None = None, zero: bool = False) -> Plan:
    """Launch the kernel once, adding the counts into ``out`` ([NB] int32
    on the same device; zeroed first on the stream when ``zero``).  The
    launch follows ``forced``, or else :func:`plan`.  Returns the plan it
    launched."""
    dev = ids.device
    p = forced or plan(ids.numel(), out.numel(), device_info(dev.index))
    _run(*_check_aligned(ids, valid), ids.numel(), out, _c_args(p), zero, dev)
    return p


def bucket_hist_kernel(ids, valid, *, num_buckets: int, tile: int = HIST_TILE):
    """Count valid walks per bucket.  ``ids``: [N] int32; ``valid``: [N]
    bool; ``N`` a multiple of ``tile``.  Returns [num_buckets] int32."""
    _validate(ids, valid, num_buckets, tile)
    dev = ids.device
    if dev.type == "cpu":
        return bucket_hist_ref(ids, valid, num_buckets=num_buckets, tile=tile)
    if dev.type != "cuda":
        raise ValueError(f"bucket_hist_kernel runs on cuda or cpu tensors, got {dev}")
    n = ids.numel()
    if n == 0 or num_buckets == 0:
        return torch.zeros(num_buckets, dtype=torch.int32, device=dev)
    ids_p, valid_p = _check_aligned(ids, valid)
    out = torch.empty(num_buckets, dtype=torch.int32, device=dev)
    _run(ids_p, valid_p, n, out, _plan_args(dev.index, n, num_buckets), True, dev)
    bucket_hist_kernel.launches += 1
    return out


#: kernel launches since the last reset (CPU calls do not count)
bucket_hist_kernel.launches = 0
