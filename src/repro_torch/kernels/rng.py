"""Threefry-2x32 as torch ops — the plain twin of the CUDA kernel's RNG.

Every walk-step draw is keyed by ``(base_key, walk_id, hop, round)``
through ``fold_in`` and ``uniform``; this module reproduces the JAX
package's hand-rolled threefry (``repro/kernels/rng.py``) bit for bit, so
the port's walks equal the reference's.  The CUDA kernel
(``csrc/pair_advance.cu``) carries its own copy in native ``uint32``.

PyTorch has no uint32 arithmetic on every device, so words live in
``int64`` tensors holding values in ``[0, 2**32)``, and every add is
masked with ``& 0xFFFFFFFF``.  Keys are a raw ``(k0, k1)`` pair; scalars
(Python ints) broadcast against tensors.

Bit layout (non-partitionable threefry, as the reference pins it):

* ``fold_in(key, d)`` is ``threefry2x32(key, [0, uint32(d)])``.
* ``uniform(key, (3,))`` evaluates the cipher on counters ``(0, 2)`` and
  ``(1, 0)``; the draws are ``[T(0,2).out0, T(1,0).out0, T(0,2).out1]``.
  ``uniform(key, ())`` is ``T(0,0).out0``.
* bits -> float32 in [0,1): ``bitcast((bits >> 9) | 0x3F800000) - 1.0``.
"""

from __future__ import annotations

import torch

__all__ = ["threefry2x32", "fold_in", "bits_to_unit", "uniform1", "uniform3", "key_halves"]

MASK = 0xFFFFFFFF
#: threefry ks-parity constant (SHA-1 of "threefish", truncated)
_PARITY = 0x1BD11BDA
#: rotation distances — groups alternate between the two quadruples
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: key-injection schedule after each 4-round group: (into-x0, into-x1, tweak)
_INJECT = ((1, 2, 1), (2, 0, 2), (0, 1, 3), (1, 2, 4), (2, 0, 5))


def _word(x):
    """A uint32 word as an int64 tensor (or a masked Python int)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return int(x) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds), elementwise.

    Inputs are Python ints or integer tensors that broadcast together; the
    outputs ``(y0, y1)`` are fresh int64 tensors of words in ``[0, 2**32)``.
    """
    k0, k1, x0, x1 = (_word(v) for v in (k0, k1, x0, x1))
    tensors = [v for v in (k0, k1, x0, x1) if isinstance(v, torch.Tensor)]
    shape = torch.broadcast_shapes(*(t.shape for t in tensors)) if tensors else ()
    device = tensors[0].device if tensors else None
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)

    def start(x, k):
        y = torch.as_tensor((x + k) & MASK, dtype=torch.int64, device=device)
        return torch.broadcast_to(y, shape).clone()

    y0, y1 = start(x0, ks[0]), start(x1, ks[1])
    for g, (ia, ib, tweak) in enumerate(_INJECT):
        for r in _ROTATIONS[g % 2]:
            y0.add_(y1).bitwise_and_(MASK)
            low = y1 >> (32 - r)
            y1.bitwise_left_shift_(r).bitwise_and_(MASK).bitwise_or_(low).bitwise_xor_(y0)
        y0.add_(ks[ia]).bitwise_and_(MASK)
        y1.add_(ks[ib]).add_(tweak).bitwise_and_(MASK)
    return y0, y1


def fold_in(k0, k1, data):
    """``jax.random.fold_in`` on a raw key pair: returns the folded pair."""
    return threefry2x32(k0, k1, 0, data)


def bits_to_unit(bits):
    """uint32 random bits -> float32 in [0, 1), jax.random.uniform's map."""
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mantissa.view(torch.float32) - 1.0


def uniform1(k0, k1):
    """``uniform(key, ())`` for every key in the pair."""
    b0, _ = threefry2x32(k0, k1, 0, 0)
    return bits_to_unit(b0)


def uniform3(k0, k1):
    """``uniform(key, (3,))`` per key: returns ``(u0, u1, u2)`` — two
    cipher calls in the padded counter order."""
    a0, a1 = threefry2x32(k0, k1, 0, 2)
    b0, _ = threefry2x32(k0, k1, 1, 0)
    return bits_to_unit(a0), bits_to_unit(b0), bits_to_unit(a1)


def key_halves(seed: int) -> tuple[int, int]:
    """Raw halves of ``jax.random.PRNGKey(seed)`` for a non-negative seed:
    ``(0, seed & 0xFFFFFFFF)`` — the engines' base key."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return 0, seed & MASK
