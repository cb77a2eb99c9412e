"""The port's pair advance equals the JAX package's, bit for bit.

One graph, built and blocked by ``repro`` and carried into the port with
``repro_torch.convert``, is packed by both packages' ``ResidentPair``; the
same seeded lanes then go through

* ``repro.engines.step.advance_pair`` (the jitted JAX advance),
* ``repro.kernels.pair_advance.fused_advance_pair(interpret=True)``
  (the Pallas kernel in interpret mode),
* ``repro_torch.engines.step.pair_advance_ref`` (the plain PyTorch version),
* ``repro_torch.kernels.pair_advance.fused_advance_pair`` on CPU tensors
  (the wrapper's CPU path, which is the plain version),

and all six outputs must agree exactly.  Cases cover order 1/2, alias
tables on/off (a weighted graph), trace recording on/off, a deduped pair
and an activated view that an order-2 ``prev`` misses (the clamped
fallback).  Order-2 cases run ``k_max = 4`` rounds, so the last-round
accept is common; one case runs the engines' 16 (without the Pallas
interpreter, whose compile grows with the unrolled rounds).  The kernel
itself is held against the plain version on the card by
``tests/test_torch_kernels_gpu.py``.

The layouts on which the CUDA kernel takes or refuses its fast paths are
held here too, JAX advance against plain version: the oracle's (the whole
graph as one contiguous slot, slot 1 aliasing it), a gathered slot 1 as
SOGW builds it, lanes whose prev is in neither slot, and a slot whose ids
keep a full block's end points but have a gap or a swap.

Recording into an engine's corpus (``corpus=``, the walks by walk id)
equals the trace scattered on the host, over successive calls.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI legs without it skip

from repro.core import BlockedGraph as JBlockedGraph  # noqa: E402
from repro.core import CSRGraph as JCSRGraph  # noqa: E402
from repro.core import erdos_renyi  # noqa: E402
from repro.core.graph import BlockView as JBlockView  # noqa: E402
from repro.engines.base import ResidentPair as JResidentPair  # noqa: E402
from repro.engines.step import advance_pair as jax_advance  # noqa: E402
from repro.kernels.pair_advance import fused_advance_pair as pallas_advance  # noqa: E402
from repro_torch.convert import blocked_graph_from_arrays  # noqa: E402
from repro_torch.core.graph import BlockView as TBlockView  # noqa: E402
from repro_torch.engines.base import ResidentPair as TResidentPair  # noqa: E402
from repro_torch.engines.step import pair_advance_ref, pow2_pad, remap_search_iters  # noqa: E402
from repro_torch.kernels import pair_advance as tkernel  # noqa: E402
from repro_torch.kernels.rng import key_halves  # noqa: E402

torch.set_num_threads(1)

SEED = 7
LENGTH = 6
P, Q = 3.0, 0.5
#: vertices cut off from the graph in the dead-end cases (blocks 0 and 1)
DEAD = np.array([3, 17, 29, 45, 61, 70])


def _isolate(g, dead):
    """``g`` without the edges that touch ``dead``: those vertices keep
    their rows, at degree 0."""
    n = g.num_vertices
    src = np.repeat(np.arange(n), np.diff(g.indptr))
    keep = ~(np.isin(src, dead) | np.isin(g.indices, dead))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(src[keep], minlength=n))])
    return JCSRGraph(indptr.astype(g.indptr.dtype), g.indices[keep])


def _graphs(weighted: bool, dead: bool = False):
    g = erdos_renyi(120, 720, seed=SEED)
    if dead:
        g = _isolate(g, DEAD)
    w = None
    if weighted:
        w = np.random.default_rng(SEED).uniform(0.1, 2.0, g.indices.shape).astype(np.float32)
        g = JCSRGraph(g.indptr, g.indices, w)
    starts = np.array([0, 40, 80, 120])
    jbg = JBlockedGraph(g, starts, build_alias=weighted)
    tbg = blocked_graph_from_arrays(g.indptr, g.indices, w, starts)
    if weighted:
        tbg.ensure_alias()
    return jbg, tbg


def _views(bg, view_cls, case):
    full = lambda b: view_cls.from_resident(bg.materialize_block(b))
    if case == "dedup":
        v = full(0)
        return v, v
    if case == "activated":
        # every 3rd vertex of block 1: lanes whose prev is in block 1 mostly
        # miss the pair, and block-2 prevs miss it entirely
        return full(0), bg.partial_view(1, np.arange(40, 80, 3))
    return full(0), full(1)


def _lanes(bg_j, n=200, dead=False):
    r = np.random.default_rng(SEED + n)
    g = bg_j.graph
    cur = r.integers(0, 40, n)  # block 0: resident in slot 0
    if dead:  # lanes that stand on a dead end, in either slot
        cur[: DEAD.size] = DEAD
    prev = np.empty(n, np.int64)
    for i, v in enumerate(cur):
        nbrs = g.indices[g.indptr[v] : g.indptr[v + 1]]
        # a neighbour (second-order context), or any vertex (a miss)
        prev[i] = r.choice(nbrs) if (nbrs.size and r.random() < 0.7) else r.integers(0, 120)
    if dead:  # and lanes whose prev is one (an empty membership range)
        prev[DEAD.size : 2 * DEAD.size] = DEAD
    hop = r.integers(0, LENGTH, n)
    if dead:
        hop[: 2 * DEAD.size] = np.arange(2 * DEAD.size) % 2 + 1
    prev[hop == 0] = cur[hop == 0]
    alive = r.random(n) < 0.9
    if dead:
        alive[: 2 * DEAD.size] = True
    N = pow2_pad(n)
    pad = lambda x, fill=0: np.concatenate([x, np.full(N - n, fill, x.dtype)])
    return (
        pad(np.arange(n, dtype=np.int32) * 3 + 1),
        pad(prev.astype(np.int32)),
        pad(cur.astype(np.int32)),
        pad(hop.astype(np.int32)),
        pad(alive, False),
    )


def _run_all(order, weighted, record, case, decay, k_max=4, pallas=True, dead=False):
    jbg, tbg = _graphs(weighted, dead)
    jpair = JResidentPair(jbg, weighted)
    tpair = TResidentPair(tbg, weighted, device="cpu")
    for pair, bg, view_cls in ((jpair, jbg, JBlockView), (tpair, tbg, TBlockView)):
        v0, v1 = _views(bg, view_cls, case)
        pair.set_slot(0, v0)
        pair.set_slot(1, v1)
    jargs, jv = jpair.device_args()
    targs, tv = tpair.device_args()
    assert jv == tv
    for a, b in zip(jargs, targs):  # the two packings agree
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    lanes = _lanes(jbg, dead=dead)
    k_max = k_max if order == 2 else 1
    n_iters = int(np.ceil(np.log2(max(jbg.max_block_edges, 2)))) + 2
    statics = dict(
        order=order,
        k_max=k_max,
        n_iters=n_iters,
        v_iters=jv,
        record=record,
        has_alias=weighted,
        max_len=LENGTH,
    )
    import jax

    jkey = jax.random.PRNGKey(SEED)
    jscal = (jnp.int32(LENGTH), jnp.float32(decay), jnp.float32(P), jnp.float32(Q))
    jl = [jnp.asarray(x) for x in lanes]
    outs = {"jax": jax_advance(*jargs, *jl, jkey, *jscal, **statics)}
    if pallas:
        outs["pallas"] = pallas_advance(*jargs, *jl, jkey, *jscal, interpret=True, **statics)
    tl = [torch.from_numpy(x) for x in lanes]
    tscal = (key_halves(SEED), LENGTH, decay, P, Q)
    outs["ref"] = pair_advance_ref(*targs, *tl, *tscal, **statics)
    before = tkernel.fused_advance_pair.launches
    outs["wrapper"] = tkernel.fused_advance_pair(*targs, *tl, *tscal, **statics)
    assert tkernel.fused_advance_pair.launches == before  # CPU: no kernel launch
    return outs, lanes


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(outs):
    names = ("prev", "cur", "hop", "alive", "steps", "trace")
    ref = [_np(x) for x in outs["jax"]]
    for impl, out in outs.items():
        for name, a, b in zip(names, ref, out):
            b = _np(b)
            assert a.shape == b.shape, (impl, name, a.shape, b.shape)
            np.testing.assert_array_equal(
                a.astype(np.int64), b.astype(np.int64), err_msg=f"{impl}:{name}"
            )


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("order", [1, 2])
def test_advance_matches_jax_and_pallas(order, weighted, record):
    # the Pallas interpreter joins where the trace is recorded (its slowest
    # compiles are order 2's); the JAX advance holds every case
    outs, lanes = _run_all(order, weighted, record, "pair", decay=0.85, pallas=record)
    assert ("pallas" in outs) == record
    _assert_same(outs)
    hop_in = lanes[3]
    assert int(_np(outs["ref"][4])) == int((_np(outs["ref"][2]) - hop_in).sum())
    assert int(_np(outs["ref"][4])) > 0  # the walks did move


def test_advance_engine_rounds_matches_jax():
    """The engines' k_max = 16 rejection rounds, alias tables and trace."""
    outs, _ = _run_all(2, True, True, "pair", decay=1.0, k_max=16, pallas=False)
    _assert_same(outs)


@pytest.mark.parametrize("case", ["dedup", "activated"])
@pytest.mark.parametrize("order", [1, 2])
def test_advance_dedup_and_activated(order, case):
    # the Pallas interpreter joins all but the order-2 deduped pair
    pallas = order == 1 or case == "activated"
    outs, _ = _run_all(order, False, True, case, decay=1.0, pallas=pallas)
    assert ("pallas" in outs) == pallas
    _assert_same(outs)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("order", [1, 2])
def test_advance_dead_ends(order, weighted):
    """Lanes on a zero-degree vertex die where they stand: hop not advanced,
    nothing written to the trace."""
    pallas = order == 1 and not weighted  # the Pallas interpreter joins one case
    outs, lanes = _run_all(order, weighted, True, "pair", decay=1.0, pallas=pallas, dead=True)
    _assert_same(outs)
    prev_o, cur_o, hop_o, alive_o, _, trace = (_np(x) for x in outs["ref"])
    k = DEAD.size
    assert not alive_o[:k].any()
    np.testing.assert_array_equal(hop_o[:k], lanes[3][:k])
    np.testing.assert_array_equal(cur_o[:k], DEAD)
    assert (trace[:k] == -1).all()
    # the lanes with a dead-end prev did move on
    assert (hop_o[k : 2 * k] > lanes[3][k : 2 * k]).all()


def test_activated_view_exercises_prev_miss():
    """The activated case really has order-2 lanes whose prev misses the
    pair (the clamped not-found fallback of locate)."""
    jbg, _ = _graphs(False)
    view = jbg.partial_view(1, np.arange(40, 80, 3))
    _, prev, _, hop, alive = _lanes(jbg)
    in_pair = (prev < 40) | np.isin(prev, view.vids)
    assert (alive & (hop > 0) & ~in_pair).sum() > 10


# ---- the layouts of the kernel's guards --------------------------------------


def _broken_block1(bg, view_cls, layout):
    """Block 1 (vertices 40..79) as a view with its end points and length
    but not its contiguous run: 60 dropped and 61 repeated, or 60 and 61
    swapped."""
    g = bg.graph
    vids = np.arange(40, 80)
    if layout == "gap":
        vids[20] = 61
    else:
        vids[20], vids[21] = 61, 60
    segs = [g.indices[g.indptr[v] : g.indptr[v + 1]] for v in vids]
    return view_cls.from_rows(1, vids, segs)


def _layout_args(layout, jbg, tbg, lanes):
    """Both packages' packed arrays for one layout, and ``v_iters``."""
    if layout == "oracle":
        g = jbg.graph
        V = g.num_vertices
        base0 = np.zeros(2, np.int32)
        arrays = (np.arange(V, dtype=np.int32), np.array([V, V], np.int32), base0,
                  g.indptr.astype(np.int32), base0, g.indices.astype(np.int32), base0,
                  np.zeros(1, np.int32), np.ones(1, np.float32))  # fmt: skip
        arrays_t = [torch.from_numpy(a) for a in arrays]
        return [jnp.asarray(a) for a in arrays], arrays_t, remap_search_iters(V)
    jpair = JResidentPair(jbg, False)
    tpair = TResidentPair(tbg, False, device="cpu")
    prev, hop = lanes[1], lanes[3]
    for pair, bg, view_cls in ((jpair, jbg, JBlockView), (tpair, tbg, TBlockView)):
        pair.set_slot(0, view_cls.from_resident(bg.materialize_block(0)))
        if layout == "gathered":  # SOGW: the rows of the prevs outside block 0
            v1 = bg.gather_view(np.unique(prev[(prev >= 40) & (hop > 0)]))
        elif layout in ("gap", "swap"):
            v1 = _broken_block1(bg, view_cls, layout)
        else:
            v1 = view_cls.from_resident(bg.materialize_block(1))
        pair.set_slot(1, v1)
    jargs, jv = jpair.device_args()
    targs, tv = tpair.device_args()
    assert jv == tv
    return jargs, targs, tv


@pytest.mark.parametrize("layout", ["oracle", "gathered", "prevmiss", "gap", "swap"])
@pytest.mark.parametrize("order", [1, 2])
def test_advance_kernel_guard_layouts_match_jax(order, layout):
    import jax

    jbg, tbg = _graphs(False)
    lanes = [x.copy() for x in _lanes(jbg)]
    if layout == "prevmiss":  # every prev in block 2, outside the pair; no lane at hop 0
        lanes[1][:200] = np.random.default_rng(SEED).integers(80, 120, 200)
        lanes[3][:200] = np.maximum(lanes[3][:200], 1)
    if layout in ("gap", "swap"):  # lanes on the altered ids, as cur and as prev
        lanes[2][:4] = lanes[1][4:8] = [59, 60, 61, 62]
        lanes[3][:8] = 1
        lanes[4][:8] = True
    jargs, targs, v_iters = _layout_args(layout, jbg, tbg, lanes)
    edges = jbg.num_edges if layout == "oracle" else jbg.max_block_edges
    statics = dict(
        order=order, k_max=4 if order == 2 else 1,
        n_iters=int(np.ceil(np.log2(max(edges, 2)))) + 2, v_iters=v_iters, record=True,
        has_alias=False, max_len=LENGTH,
    )  # fmt: skip
    jscal = (jnp.int32(LENGTH), jnp.float32(0.85), jnp.float32(P), jnp.float32(Q))
    jl = [jnp.asarray(x) for x in lanes]
    outs = {"jax": jax_advance(*jargs, *jl, jax.random.PRNGKey(SEED), *jscal, **statics)}
    tl = [torch.from_numpy(x) for x in lanes]
    tscal = (key_halves(SEED), LENGTH, 0.85, P, Q)
    outs["ref"] = pair_advance_ref(*targs, *tl, *tscal, **statics)
    _assert_same(outs)
    assert int(_np(outs["ref"][4])) > 0


# ---- recording into the engine's corpus --------------------------------------

#: rows of the corpus in the corpus-mode cases; row 0 belongs to no lane
CORPUS_ROWS = 701


def _scatter(corpus, wid, trace):
    """The engine's host path: each recorded step of a trace into its walk's row."""
    for h in range(trace.shape[1]):
        m = trace[:, h] >= 0
        corpus[wid[m], h] = trace[m, h]


@pytest.mark.parametrize("max_len", [LENGTH, LENGTH - 2], ids=["full", "clamped"])
@pytest.mark.parametrize("case", ["pair", "dedup"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("order", [1, 2])
def test_corpus_mode_matches_trace_scattered_on_host(order, weighted, case, max_len):
    """Recording into a corpus writes what the trace, scattered on the host
    by walk id, writes: over two successive calls on one corpus, with
    permuted walk ids, and padded dead lanes (walk id 0) that leave row 0
    as it was.  ``max_len < length`` sends hops past it to its column.
    The wrapper's CPU path passes the corpus on to the plain version."""
    jbg, tbg = _graphs(weighted)
    pair = TResidentPair(tbg, weighted, device="cpu")
    v0, v1 = _views(tbg, TBlockView, case)
    pair.set_slot(0, v0)
    pair.set_slot(1, v1)
    args, v_iters = pair.device_args()
    wid, prev, cur, hop, alive = (torch.from_numpy(x) for x in _lanes(jbg))
    n = 200
    ids = np.random.default_rng(SEED).permutation(np.arange(1, CORPUS_ROWS))[:n]
    wid[:n] = torch.from_numpy(ids.astype(np.int32))
    assert (wid[n:] == 0).all() and not alive[n:].any() and (~alive[:n]).any()
    statics = dict(
        order=order, k_max=4 if order == 2 else 1,
        n_iters=int(np.ceil(np.log2(max(tbg.max_block_edges, 2)))) + 2, v_iters=v_iters,
        record=True, has_alias=weighted, max_len=max_len,
    )  # fmt: skip
    scal = (key_halves(SEED), LENGTH, 1.0, P, Q)
    start = np.full((CORPUS_ROWS, max_len + 1), -1, np.int32)
    start[:, 0] = np.arange(CORPUS_ROWS) % 120
    want = start.copy()
    corpus = torch.from_numpy(start.copy())
    wrapped = torch.from_numpy(start.copy())
    lanes = (wid, prev, cur, hop, alive)
    for call, hops in enumerate((2, None)):  # a partial advance, then the rest
        traced = pair_advance_ref(*args, *lanes, *scal, max_hops=hops, **statics)
        into = pair_advance_ref(*args, *lanes, *scal, max_hops=hops, corpus=corpus, **statics)
        tkernel.fused_advance_pair(*args, *lanes, *scal, max_hops=hops, corpus=wrapped, **statics)
        _scatter(want, wid.numpy(), traced[5].numpy())
        for a, b in zip(traced[:5], into[:5]):
            assert torch.equal(a, b), call
        assert into[5].shape == (1, 1) and int(into[5]) == -1
        np.testing.assert_array_equal(corpus.numpy(), want, err_msg=f"call {call}")
        assert torch.equal(wrapped, corpus), call
        lanes = (wid, *traced[:4])
    hop_out = traced[2].numpy()
    assert (hop_out[:n] > hop.numpy()[:n]).sum() > 20  # the walks did move
    np.testing.assert_array_equal(corpus[0].numpy(), start[0])  # the dead lanes wrote nothing
    dead = ~alive.numpy()[:n]
    np.testing.assert_array_equal(corpus.numpy()[ids[dead]], start[ids[dead]])
    if max_len < LENGTH:  # some walk stepped past max_len, into its last column
        assert (hop_out[:n] > max_len).any()

