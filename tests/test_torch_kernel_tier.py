"""The port's kernel tier equals the JAX package's, bit for bit.

* ``bucket_hist_ref`` and the wrapper's CPU path against
  ``repro.kernels.bucket_hist_kernel(interpret=True)`` (the Pallas kernel
  in interpret mode) and ``repro.kernels.bucket_hist_ref``, with ids out of
  range on both sides; plus the wrapper's ``ValueError`` / ``TypeError``,
  and the CUDA kernel's host plan at each of its limits.
* ``node2vec_step`` / ``alias_step`` (both ``use_kernel`` paths) and
  ``node2vec_step_ref`` against their JAX twins on the pairs of
  ``tests/test_kernels.py``, weighted alias tables included.
* ``pair_advance_ref(max_hops=k)`` against JAX
  ``fused_advance_pair(max_hops=k, interpret=True)``.

Inputs are made from a seed with numpy and handed to both packages.
Tolerance: bitwise.  The CUDA kernels themselves are held against these
plain versions on the card by ``tests/test_torch_kernels_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI legs without it skip

from repro import kernels as jk  # noqa: E402
from repro.core import CSRGraph, erdos_renyi, partition_into_n_blocks  # noqa: E402
from repro.core.graph import BlockView  # noqa: E402
from repro.engines.base import ResidentPair  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.engines.step import pair_advance_ref  # noqa: E402
from repro_torch.kernels.bucket_hist import bucket_hist_kernel, bucket_hist_ref  # noqa: E402

torch.set_num_threads(1)


# ---- bucket histogram -------------------------------------------------------


def _hist_inputs(n, nb, seed):
    r = np.random.default_rng(seed)
    ids = r.integers(0, nb, n).astype(np.int32)
    out = r.random(n) < 0.1  # ids out of range, on both sides
    ids[out] = r.choice([-3, -1, nb, nb + 7], out.sum())
    valid = r.random(n) < 0.7
    return ids, valid


@pytest.mark.parametrize(
    "n,nb,seed", [(1024, 2, 0), (1024, 5, 1), (2048, 3, 2), (2048, 9, 3), (2048, 7, 4)]
)
def test_bucket_hist_matches_jax(n, nb, seed):
    ids, valid = _hist_inputs(n, nb, seed)
    want_k = jk.bucket_hist_kernel(jnp.asarray(ids), jnp.asarray(valid), num_buckets=nb)
    want_r = jk.bucket_hist_ref(jnp.asarray(ids), jnp.asarray(valid), num_buckets=nb)
    np.testing.assert_array_equal(np.asarray(want_k), np.asarray(want_r))
    tids, tvalid = torch.as_tensor(ids), torch.as_tensor(valid)
    before = bucket_hist_kernel.launches
    for got in (
        bucket_hist_ref(tids, tvalid, num_buckets=nb),
        bucket_hist_kernel(tids, tvalid, num_buckets=nb),  # CPU: the plain version
        tk.bucket_hist_ref(tids, tvalid, num_buckets=nb, tile=256),
    ):
        assert got.dtype == torch.int32 and got.shape == (nb,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_k))
    assert bucket_hist_kernel.launches == before
    in_range = (ids >= 0) & (ids < nb)
    assert int(want_k.sum()) == int((valid & in_range).sum())


def test_bucket_hist_plain_version_chunks_large_bucket_counts(monkeypatch):
    """Bins and tiles chunked (a small one-hot budget) give the same counts."""
    from repro_torch.kernels import bucket_hist as mod

    ids, valid = _hist_inputs(4096, 700, 9)
    want = np.bincount(ids[valid & (ids >= 0) & (ids < 700)], minlength=700)
    monkeypatch.setattr(mod, "_ONEHOT_ELEMS", 3000)
    got = bucket_hist_ref(torch.as_tensor(ids), torch.as_tensor(valid), num_buckets=700)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bucket_hist_errors_and_empty():
    ids = torch.zeros(1000, dtype=torch.int32)
    valid = torch.ones(1000, dtype=torch.bool)
    for fn in (bucket_hist_kernel, bucket_hist_ref):
        with pytest.raises(ValueError, match="multiple of 1024"):
            fn(ids, valid, num_buckets=4)
        with pytest.raises(TypeError, match="valid"):
            fn(ids[:0], valid[:0].to(torch.int32), num_buckets=4)
        with pytest.raises(TypeError, match="ids"):
            fn(ids[:0].long(), valid[:0], num_buckets=4)
        empty = fn(ids[:0], valid[:0], num_buckets=4)
        assert empty.dtype == torch.int32 and empty.tolist() == [0, 0, 0, 0]
    meta = torch.zeros(1024, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bucket_hist_kernel(meta, meta.bool(), num_buckets=4)


def _card(sms, smem_block, smem_sm, threads_sm):
    from repro_torch.kernels.bucket_hist import Card

    return Card(sms, smem_block, smem_sm, 1024, threads_sm)


#: (card, walks, bins) -> (path, ranges, grid) of the bucket histogram's
#: host plan on either side of each of its limits.  Cards (SMs, opt-in
#: shared memory per block, shared memory per SM, threads per SM; 1,024
#: bytes reserved per block on each): an H100 SXM, an H100 PCIe, an A100
#: (164 KB per SM) and an A10 (100 KB and 1,536 threads per SM).
_H100 = (132, 232448, 233472, 2048)
_PCIE = (114, 232448, 233472, 2048)
_A100 = (108, 166912, 167936, 2048)
_A10 = (72, 101376, 102400, 1536)
_PLANS = [
    # two blocks per SM while a copy counts >= 14 lanes per bin
    (_H100, 1 << 20, 1, ("block", 1, 256)),
    (_H100, 1 << 20, 283, ("block", 1, 256)),
    (_H100, 1 << 20, 284, ("block", 1, 132)),
    (_PCIE, 1 << 20, 328, ("block", 1, 228)),
    (_PCIE, 1 << 20, 329, ("block", 1, 114)),
    # ... and while two fit an SM: its shared memory, 1 KB reserve each
    (_H100, 1 << 27, 28928, ("block", 1, 264)),
    (_H100, 1 << 27, 28929, ("block", 1, 132)),
    (_A100, 1 << 27, 20736, ("block", 1, 216)),
    (_A100, 1 << 27, 20737, ("block", 1, 108)),
    # ... and its threads: two blocks of 1,024 never fit 1,536
    (_A10, 1 << 20, 16, ("block", 1, 72)),
    # ranges by lanes per bin: >= 1,024 one, >= 56 two, >= 13 four, else
    # global
    (_H100, 1 << 20, 1024, ("block", 1, 132)),
    (_H100, 1 << 20, 1025, ("range", 2, 132)),
    (_PCIE, 1 << 20, 1025, ("range", 2, 114)),
    (_H100, 1 << 20, 2049, ("range", 2, 132)),
    (_H100, 1 << 20, 18724, ("range", 2, 132)),
    (_H100, 1 << 20, 18725, ("range", 4, 132)),
    (_H100, 1 << 20, 29127, ("range", 4, 132)),
    (_H100, 1 << 20, 29128, ("range", 4, 132)),
    (_H100, 1 << 20, 80659, ("range", 4, 132)),
    (_H100, 1 << 20, 80660, ("global", 1, 528)),
    (_A100, 1 << 20, 80659, ("range", 4, 108)),
    (_A100, 1 << 20, 80660, ("global", 1, 432)),
    # ranges by shared memory: the fewest of one, two or four that hold
    # the bins
    (_H100, 1 << 27, 58112, ("block", 1, 132)),
    (_H100, 1 << 27, 58113, ("range", 2, 132)),
    (_H100, 1 << 27, 116224, ("range", 2, 132)),
    (_H100, 1 << 27, 116225, ("range", 4, 132)),
    (_H100, 1 << 27, 174336, ("range", 4, 132)),
    (_H100, 1 << 27, 174337, ("range", 4, 132)),
    (_H100, 1 << 27, 232448, ("range", 4, 132)),
    (_H100, 1 << 27, 232449, ("global", 1, 528)),
    (_A100, 1 << 27, 41728, ("block", 1, 108)),  # lanes allow two; one fits
    (_A100, 1 << 27, 41729, ("range", 2, 108)),
    (_A100, 1 << 27, 83456, ("range", 2, 108)),
    (_A100, 1 << 27, 83457, ("range", 4, 108)),
    (_A100, 1 << 27, 166912, ("range", 4, 108)),
    (_A100, 1 << 27, 166913, ("global", 1, 432)),
    (_A10, 1 << 26, 25344, ("block", 1, 72)),
    (_A10, 1 << 26, 25345, ("range", 2, 72)),
    (_A10, 1 << 26, 101377, ("global", 1, 288)),
    # few walks: the grid shrinks to the lanes there are
    (_H100, 4096, 16, ("range", 2, 2)),
    (_H100, 1 << 17, 300, ("range", 2, 64)),
    (_H100, 1024, 1, ("block", 1, 1)),
    (_H100, 1024, 128, ("global", 1, 1)),
]


@pytest.mark.parametrize("card,n,nb,want", _PLANS)
def test_bucket_hist_plan_at_its_limits(card, n, nb, want):
    from repro_torch.kernels.bucket_hist import blocks_per_sm, plan, shared_capacity

    card = _card(*card)
    p = plan(n, nb, card)
    assert (p.path, p.ranges, p.grid) == want
    smem = 0 if p.path == "global" else -(-nb // p.ranges) * 4
    assert p.grid % p.ranges == 0 and smem <= card.smem_block
    assert -(-p.grid // card.sms) <= blocks_per_sm(card, p.threads, smem)  # one wave
    if p.path != "global":
        assert p.grid // p.ranges * p.threads <= max(n // 4, p.threads)  # every copy has lanes
    if nb > shared_capacity(card.smem_block):
        assert p.path == "global"


@pytest.mark.parametrize("card,threads,smem,want", [
    (_H100, 1024, 115712, 2), (_H100, 1024, 115716, 1), (_H100, 1024, 232448, 1),
    (_H100, 1024, 232452, 0), (_H100, 256, 0, 8), (_A10, 1024, 4, 1), (_A10, 512, 4, 3),
])  # fmt: skip
def test_bucket_hist_blocks_per_sm(card, threads, smem, want):
    from repro_torch.kernels.bucket_hist import blocks_per_sm

    assert blocks_per_sm(_card(*card), threads, smem) == want


def test_bucket_hist_plan_rejects_bad_shapes():
    from repro_torch.kernels.bucket_hist import plan

    for n, nb in ((0, 4), (1026, 4), (1024, 0)):
        with pytest.raises(ValueError, match="plan needs"):
            plan(n, nb, _card(*_H100))


def test_bucket_hist_refuses_unaligned_cuda_inputs():
    """The check the wrapper makes before a launch, on a host tensor's
    addresses: 16 bytes for ids, 4 for the flags."""
    from repro_torch.kernels.bucket_hist import _check_aligned

    ids = torch.zeros(2048, dtype=torch.int32)
    valid = torch.zeros(2048, dtype=torch.bool)
    _check_aligned(ids[4:1028], valid[4:1028])
    for a, b in ((ids[1:1025], valid[:1024]), (ids[:1024], valid[1:1025])):
        with pytest.raises(ValueError, match="16-byte boundary"):
            _check_aligned(a, b)


# ---- single-hop kernel tier -------------------------------------------------


def _pair_args(n_verts=500, n_edges=3500, nb=4, b0=0, b1=2, weighted=False, seed=1):
    """``tests/test_kernels.py``'s pairs, packed by the JAX package; returns
    the JAX blocked graph, the pair as numpy arrays and ``v_iters``."""
    g = erdos_renyi(n_verts, n_edges, seed=seed)
    if weighted:
        r = np.random.default_rng(seed)
        g = CSRGraph(g.indptr, g.indices, (r.random(g.num_edges) + 0.1).astype(np.float32))
    bg = partition_into_n_blocks(g, nb)
    if weighted:
        bg.ensure_alias()
    rp = ResidentPair(bg, has_alias=weighted)
    rp.set_slot(0, BlockView.from_resident(bg.materialize_block(b0)))
    rp.set_slot(1, BlockView.from_resident(bg.materialize_block(b1)))
    pair, v_iters = rp.device_args()
    return bg, [np.array(a) for a in pair], v_iters


def _hop_lanes(bg, n, seed, hop_hi=6):
    r = np.random.default_rng(seed)
    s = bg.block_starts
    cur = r.integers(s[0], s[1], n).astype(np.int32)
    prev = r.integers(s[2], s[3], n).astype(np.int32)
    hop = r.integers(0, hop_hi, n).astype(np.int32)
    active = r.random(n) < 0.9
    wid = r.integers(0, 1 << 20, n).astype(np.int32)
    return wid, prev, cur, hop, active


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _jax_key(seed):
    return jax.random.PRNGKey(seed)


def _counter_unif(seed, wid, hop, k_max):
    """The engine's draw schedule, materialised by the JAX package."""
    rng = jk.rng
    kw0, kw1 = rng.fold_in(*rng.fold_in(*rng.key_halves(_jax_key(seed)), wid), hop)
    return jnp.stack(
        [jnp.stack(rng.uniform3(*rng.fold_in(kw0, kw1, kk)), axis=-1) for kk in range(k_max)],
        axis=1,
    )


@pytest.mark.parametrize(
    "p,q,weighted,k_max",
    [(1.0, 1.0, False, 4), (4.0, 0.25, False, 4), (0.25, 4.0, False, 4), (0.5, 2.0, True, 2)],
)
def test_node2vec_step_matches_jax(p, q, weighted, k_max):
    bg, pair, v_iters = _pair_args(weighted=weighted)
    wid, prev, cur, hop, active = _hop_lanes(bg, 256, 0)
    kw = dict(p=p, q=q, k_max=k_max, n_iters=16, v_iters=v_iters, has_alias=weighted)
    jl = [jnp.asarray(x) for x in (wid, prev, cur, hop, active)]
    zw, mw = jk.node2vec_step(*pair, *jl, _jax_key(7), use_kernel=False, **kw)
    zw, mw = np.asarray(zw), np.asarray(mw)
    tl = _t((wid, prev, cur, hop, active))
    for use_kernel in (True, False):
        z, m = tk.node2vec_step(*_t(pair), *tl, (0, 7), use_kernel=use_kernel, **kw)
        assert z.dtype == m.dtype == torch.int32
        np.testing.assert_array_equal(z.numpy(), zw)
        np.testing.assert_array_equal(m.numpy(), mw)
    # the dense oracle itself, fed the JAX package's uniforms
    unif = np.array(_counter_unif(7, jl[0], jl[3], k_max))
    zr, mr = jk.node2vec_step_ref(
        *pair, prev, cur, hop, active, unif, p=p, q=q, k_max=k_max, has_alias=weighted
    )
    zt, mt = tk.node2vec_step_ref(
        *_t(pair), *_t((prev, cur, hop, active, unif)), p=p, q=q, k_max=k_max, has_alias=weighted
    )
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zr))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mr))
    np.testing.assert_array_equal(zt.numpy(), zw)


def test_node2vec_step_matches_pallas_single_hop():
    """The port's single hop against the Pallas kernel's (``max_hops=1``)."""
    bg, pair, v_iters = _pair_args()
    wid, prev, cur, hop, active = _hop_lanes(bg, 300, 3)
    kw = dict(p=4.0, q=0.25, k_max=4, n_iters=16, v_iters=v_iters)
    jl = [jnp.asarray(x) for x in (wid, prev, cur, hop, active)]
    zw, mw = jk.node2vec_step(
        *pair, *jl, _jax_key(2), use_kernel=True, interpret=True, walk_tile=256, **kw
    )
    z, m = tk.node2vec_step(*_t(pair), *_t((wid, prev, cur, hop, active)), (0, 2), **kw)
    np.testing.assert_array_equal(z.numpy(), np.asarray(zw))
    np.testing.assert_array_equal(m.numpy(), np.asarray(mw))


@pytest.mark.parametrize("weighted", [False, True])
def test_alias_step_matches_jax(weighted):
    bg, pair, v_iters = _pair_args(weighted=weighted)
    wid, _, cur, _, active = _hop_lanes(bg, 256, 5)
    jl = [jnp.asarray(x) for x in (wid, cur, active)]
    zw, mw = jk.alias_step(
        *pair, *jl, _jax_key(2), v_iters=v_iters, has_alias=weighted, use_kernel=False
    )
    for use_kernel in (True, False):
        z, m = tk.alias_step(
            *_t(pair), *_t((wid, cur, active)), (0, 2), v_iters=v_iters, has_alias=weighted,
            use_kernel=use_kernel,
        )  # fmt: skip
        np.testing.assert_array_equal(z.numpy(), np.asarray(zw))
        np.testing.assert_array_equal(m.numpy(), np.asarray(mw))
    g = bg.graph
    for i in range(0, 256, 17):  # sampled vertices are real neighbours
        if mw[i]:
            assert int(zw[i]) in g.neighbors(int(cur[i]))


@pytest.mark.parametrize("max_hops", [1, 2, None])
def test_pair_advance_max_hops_matches_pallas(max_hops):
    bg, pair, v_iters = _pair_args(b0=0, b1=1)
    r = np.random.default_rng(5)
    n = 256
    s = bg.block_starts
    cur = r.integers(s[0], s[2], n).astype(np.int32)
    prev = r.integers(s[0], s[2], n).astype(np.int32)
    hop = r.integers(0, 4, n).astype(np.int32)
    alive = r.random(n) < 0.95
    wid = r.integers(0, 1 << 20, n).astype(np.int32)
    kw = dict(order=2, k_max=4, n_iters=16, v_iters=v_iters, record=True, has_alias=False,
              max_len=10, max_hops=max_hops)  # fmt: skip
    sc = (10, 0.9, 4.0, 0.25)
    want = jk.fused_advance_pair(
        *pair, *(jnp.asarray(x) for x in (wid, prev, cur, hop, alive)), _jax_key(11),
        jnp.int32(sc[0]), *(jnp.float32(x) for x in sc[1:]), **kw, interpret=True,
        walk_tile=256,
    )  # fmt: skip
    tl = _t((wid, prev, cur, hop, alive))
    got = pair_advance_ref(*_t(pair), *tl, (0, 11), *sc, **kw)
    got_w = tk.fused_advance_pair(*_t(pair), *tl, (0, 11), *sc, **kw)  # CPU: plain version
    for a, b, c in zip(want, got, got_w):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(c.numpy(), np.asarray(a))
    moved = got[2].numpy() - hop
    assert moved.max() <= (11 if max_hops is None else max_hops)
    if max_hops is not None:
        assert moved.max() == max_hops  # some lane used every hop it had


def test_kernel_tier_exports_match_jax():
    names = {"fused_advance_pair", "node2vec_step", "alias_step", "node2vec_step_ref",
             "bucket_hist_kernel", "bucket_hist_ref", "rng"}  # fmt: skip
    assert names <= set(jk.__all__)
    assert names <= set(tk.__all__)
    for name in names:
        assert getattr(tk, name) is not None
