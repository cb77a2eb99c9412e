"""The port's ``core/sampling`` gives the JAX module's bits.

Seeded numpy inputs (the cases of ``tests/test_sampling.py`` and wider
ones) go through ``repro.core.sampling`` and ``repro_torch.core.sampling``:
the alias-table constructors (numpy in both), ``alias_draw``,
``searchsorted_rows`` / ``membership`` (empty rows, probes below, inside
and past each row, too few halvings, bounds past the array) and
``node2vec_accept_prob``.
Tolerance: bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI legs without it skip

import jax.numpy as jnp  # noqa: E402

import repro.core.sampling as js  # noqa: E402
import repro_torch.core.sampling as ts  # noqa: E402


def _t(a):
    return torch.as_tensor(np.asarray(a), device="cpu")


def _same(jax_out, torch_out):
    want = np.asarray(jax_out)
    got = torch_out.numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_alias_tables_match_jax(seed):
    r = np.random.default_rng(seed)
    w = r.random(int(r.integers(1, 64))) + 0.01
    for a, b in zip(js.build_alias(w), ts.build_alias(w)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    deg = r.integers(0, 6, 20)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    weights = r.random(int(indptr[-1])) + 0.1
    for wts in (None, weights):
        for a, b in zip(js.build_alias_rows(indptr, 20, 128, wts),
                        ts.build_alias_rows(indptr, 20, 128, wts)):  # fmt: skip
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_alias_draw_matches_jax(seed):
    r = np.random.default_rng(seed)
    deg = r.integers(0, 9, 64).astype(np.int32)  # zero-degree rows included
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    J, q = ts.build_alias_rows(indptr, 64, int(indptr[-1]) + 8, r.random(int(indptr[-1])) + 0.1)
    n = 4096
    rows = r.integers(0, 64, n)
    row_start = indptr[rows].astype(np.int32)
    row_deg = deg[rows]
    u1, u2 = r.random((2, n), dtype=np.float32)
    u1[:8] = np.float32(1.0) - np.float32(2**-24)  # the top of [0, 1)
    want = js.alias_draw(*(jnp.asarray(a) for a in (J, q, row_start, row_deg, u1, u2)))
    got = ts.alias_draw(*(_t(a) for a in (J, q, row_start, row_deg, u1, u2)))
    _same(want, got)
    # the numpy twin agrees where every row has a neighbour
    live = row_deg > 0
    np.testing.assert_array_equal(
        ts.alias_draw_np(J, q, row_start[live], row_deg[live], u1[live], u2[live]),
        got.numpy()[live],
    )


def test_alias_draw_statistics():
    w = np.array([1.0, 2.0, 3.0, 6.0])
    J, q = ts.build_alias(w)
    n = 200_000
    u1, u2 = np.random.default_rng(0).random((2, n), dtype=np.float32)
    draws = ts.alias_draw(_t(J), _t(q), torch.zeros(n, dtype=torch.int32),
                          torch.full((n,), 4, dtype=torch.int32), _t(u1), _t(u2))  # fmt: skip
    freq = np.bincount(draws.numpy(), minlength=4) / n
    np.testing.assert_allclose(freq, w / w.sum(), atol=0.01)


@pytest.mark.parametrize("n_iters", [1, 3, 8])
@pytest.mark.parametrize("seed", range(3))
def test_membership_matches_jax(seed, n_iters):
    r = np.random.default_rng(seed)
    rows = [np.unique(r.integers(0, 200, int(r.integers(0, 40)))) for _ in range(24)]
    indices = np.concatenate(rows + [np.full(5, -1)]).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum([len(x) for x in rows])])
    n = 3000
    which = r.integers(0, 24, n)
    lo = starts[which].astype(np.int32)
    hi = starts[which + 1].astype(np.int32)
    hi[:20] = indices.shape[0] + 7  # bounds past the array: gathers clamp
    z = r.integers(-5, 205, n).astype(np.int32)
    # half the probes are members of their row
    hit = (r.random(n) < 0.5) & (hi > lo)
    pick = lo + (r.random(n) * np.maximum(hi - lo, 1)).astype(np.int32)
    z = np.where(hit, indices[np.minimum(pick, indices.shape[0] - 1)], z)
    for fn in ("membership", "searchsorted_rows"):
        want = getattr(js, fn)(*(jnp.asarray(a) for a in (indices, lo, hi, z)), n_iters=n_iters)
        got = getattr(ts, fn)(*(_t(a) for a in (indices, lo, hi, z)), n_iters=n_iters)
        _same(want, got)
    if n_iters == 8:  # enough halvings for every row: the exact answer
        truth = [int(v) in rows[w].tolist() for v, w in zip(z[20:], which[20:])]
        assert got.numpy()[20:].tolist() == truth


def test_membership_single_row_cases():
    """The cases of ``tests/test_sampling.py``: one padded row, one probe."""
    r = np.random.default_rng(11)
    for _ in range(60):
        row = np.unique(r.integers(0, 1000, int(r.integers(0, 50)))).astype(np.int32)
        pad = np.full(64, -1, np.int32)
        pad[: len(row)] = row
        probe = int(r.integers(0, 1000)) if r.random() < 0.5 or not len(row) else int(row[0])
        args = (pad, np.zeros(1, np.int32), np.full(1, len(row), np.int32),
                np.full(1, probe, np.int32))  # fmt: skip
        got = ts.membership(*(_t(a) for a in args), n_iters=8)
        _same(js.membership(*(jnp.asarray(a) for a in args), n_iters=8), got)
        assert bool(got[0]) == (probe in row.tolist())


@pytest.mark.parametrize("pq", [(2.0, 0.5), (1.0, 1.0), (4.0, 0.25), (0.3, 3.0), (0.7, 1.3)])
def test_node2vec_accept_prob_matches_jax(pq):
    p, q = pq
    r = np.random.default_rng(1)
    z = r.integers(0, 6, 512).astype(np.int32)
    u = r.integers(0, 6, 512).astype(np.int32)
    nb = r.random(512) < 0.5
    want = js.node2vec_accept_prob(jnp.asarray(z), jnp.asarray(u), jnp.asarray(nb), p, q)
    got = ts.node2vec_accept_prob(_t(z), _t(u), _t(nb), p, q)
    _same(want, got)
    M = max(1.0, 1 / p, 1 / q)
    np.testing.assert_allclose(got.numpy()[z == u], 1 / p / M, rtol=1e-6)


def test_the_plain_advance_probes_through_core_sampling():
    from repro_torch.engines import step

    assert step.searchsorted_rows is ts.searchsorted_rows
    assert "searchsorted_rows" in step.__all__
    assert sorted(ts.__all__) == sorted(js.__all__)
