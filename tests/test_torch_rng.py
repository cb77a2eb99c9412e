"""The port's threefry (``repro_torch.kernels.rng``) draws the JAX
package's bits exactly (``repro.kernels.rng``): the cipher, ``fold_in``,
``uniform1``/``uniform3`` and the base key's halves, on seeded vectors and
one fixed vector.  Tolerance: bitwise — walks are keyed by these bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI legs without it skip

from repro.kernels import rng as jrng  # noqa: E402
from repro_torch.kernels import rng as trng  # noqa: E402


def _words(seed, n=257):
    r = np.random.default_rng(seed)
    return [r.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32) for _ in range(4)]


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _bits(x):
    """A float32 or uint32 result as int64 bit patterns."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if a.dtype == np.float32:
        return a.view(np.uint32).astype(np.int64)
    return a.astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry_and_fold_in_bitwise(seed):
    k0, k1, x0, x1 = _words(seed)
    ref = jrng.threefry2x32(k0, k1, x0, x1)
    got = trng.threefry2x32(_t(k0), _t(k1), _t(x0), _t(x1))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # fold_in broadcasts a scalar key against a vector of data
    ref = jrng.fold_in(np.uint32(k0[0]), np.uint32(k1[0]), x0)
    got = trng.fold_in(int(k0[0]), int(k1[0]), _t(x0))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("seed", [3, 4])
def test_uniform_draws_bitwise(seed):
    k0, k1, _, _ = _words(seed)
    for a, b in zip(jrng.uniform3(k0, k1), trng.uniform3(_t(k0), _t(k1))):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(
        _bits(jrng.uniform1(k0, k1)), _bits(trng.uniform1(_t(k0), _t(k1)))
    )


def test_fixed_vector():
    """One vector fixed in the source: the draws of walk 7, hop 3, round 2
    under seed 42, as ``repro.kernels.rng`` gives them."""
    base = trng.key_halves(42)
    kw = trng.fold_in(*trng.fold_in(*trng.fold_in(*base, 7), 3), 2)
    u = [float(x) for x in trng.uniform3(*kw)]
    jb = jrng.key_halves(jax.random.PRNGKey(42))
    jkw = jrng.fold_in(*jrng.fold_in(*jrng.fold_in(*jb, 7), 3), 2)
    assert u == [float(x) for x in jrng.uniform3(*jkw)]
    assert [int(x) for x in kw] == [int(x) for x in jkw]


@pytest.mark.parametrize("seed", [0, 3, 12345, 2**31 - 1, 2**32 + 3])
def test_key_halves_match_prngkey(seed):
    ref = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    assert list(trng.key_halves(seed)) == [int(x) for x in ref]


def test_key_halves_rejects_negative_seed():
    with pytest.raises(ValueError, match="non-negative"):
        trng.key_halves(-1)


def test_walk_stream_chain_matches_reference():
    """The engines' per-walk chain: fold walk ids, then hops, then rounds."""
    r = np.random.default_rng(9)
    wid = r.integers(0, 1 << 20, 300).astype(np.int32)
    hop = r.integers(0, 80, 300).astype(np.int32)
    jk = jrng.fold_in(*jrng.key_halves(jax.random.PRNGKey(5)), jnp.asarray(wid))
    jk = jrng.fold_in(*jrng.fold_in(*jk, jnp.asarray(hop)), 4)
    tk = trng.fold_in(*trng.key_halves(5), torch.from_numpy(wid))
    tk = trng.fold_in(*trng.fold_in(*tk, torch.from_numpy(hop)), 4)
    for a, b in zip(jk, tk):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(_bits(jrng.uniform1(*jk)), _bits(trng.uniform1(*tk)))
