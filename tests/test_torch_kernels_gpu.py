"""The hand-written CUDA kernel equals its plain PyTorch version on the card.

Imports only torch and the port (the machine with the card has no jax), and
skips on a host without a CUDA device.  Run it there with

    python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerance: bitwise, on all six outputs of the pair advance (full sweep
and ``max_hops``) and on the corpus it records into, on the bucket
histogram's counts (every path, at bucket counts on both sides of each
path's limit), on
``node2vec_step`` / ``alias_step`` against the dense oracle, on whole
runs of every engine, and on a query server's answers and charges, kernel
against plain version.

The pair-advance cases hit both sides of each of the kernel's guards: slots
that hold one contiguous run of ids (full blocks, the oracle's whole graph)
and slots that do not (activated, gathered, and runs with equal end points
but a gap or a swap, or too few search iterations); order-2 prevs found in
the pair and prevs in neither slot.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import BlockedGraph, BlockView, CSRGraph, erdos_renyi  # noqa: E402
from repro_torch.engines import BiBlockEngine  # noqa: E402
from repro_torch.engines.base import ResidentPair  # noqa: E402
from repro_torch.engines.step import (  # noqa: E402
    pair_advance_ref,
    pow2_pad,
    remap_search_iters,
)
from repro_torch.kernels import pair_advance as kernel  # noqa: E402
from repro_torch.kernels.rng import key_halves  # noqa: E402

LENGTH = 6
#: vertices cut off from the graph in the dead-end case (blocks 0 and 1)
DEAD = np.array([5, 300, 777, 1200, 1900])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _isolate(g, dead):
    """``g`` without the edges that touch ``dead`` (rows kept, at degree 0)."""
    n = g.num_vertices
    src = np.repeat(np.arange(n), np.diff(g.indptr))
    keep = ~(np.isin(src, dead) | np.isin(g.indices, dead))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(src[keep], minlength=n))])
    return CSRGraph(indptr.astype(g.indptr.dtype), g.indices[keep])


def _graph(weighted, dead=False):
    g = erdos_renyi(3000, 3000 * 8, seed=4)
    if dead:
        g = _isolate(g, DEAD)
    w = None
    if weighted:
        w = np.random.default_rng(4).uniform(0.1, 2.0, g.indices.shape).astype(np.float32)
    starts = np.array([0, 1000, 2000, 3000])
    return BlockedGraph(CSRGraph(g.indptr, g.indices, w), starts, build_alias=weighted)


def _lanes(bg, dev, n=900, dead=False):
    r = np.random.default_rng(5)
    g = bg.graph
    cur = r.integers(0, 1000, n)
    k = DEAD.size
    if dead:  # lanes that stand on a dead end, in either slot
        cur[:k] = DEAD
    deg = g.indptr[cur + 1] - g.indptr[cur]
    kk = np.minimum((r.random(n) * deg).astype(np.int64), np.maximum(deg - 1, 0))
    prev = np.where(r.random(n) < 0.7, g.indices[g.indptr[cur] + kk], r.integers(0, 3000, n))
    prev = np.where(deg > 0, prev, cur)
    hop = r.integers(0, LENGTH, n)
    if dead:  # and lanes whose prev is one (an empty membership range)
        prev[k : 2 * k] = DEAD
        hop[: 2 * k] = 1
    prev = np.where(hop == 0, cur, prev)
    N = pow2_pad(n)
    lanes = np.zeros((4, N), np.int32)
    lanes[0, :n], lanes[1, :n], lanes[2, :n], lanes[3, :n] = np.arange(n) * 5, prev, cur, hop
    alive = np.zeros(N, bool)
    alive[:n] = r.random(n) < 0.9
    if dead:
        alive[: 2 * k] = True
    return [*torch.as_tensor(lanes, device=dev).unbind(0), torch.as_tensor(alive, device=dev)]


def _oracle_args(bg, dev):
    """The whole graph as one slot, slot 1 aliasing it, every base 0 (the
    layout of ``InMemoryWalker``)."""
    from repro_torch.core.sampling import build_alias_rows

    g = bg.graph
    V = g.num_vertices
    indptr = g.indptr.astype(np.int32)
    alias_j, alias_q = np.zeros(1, np.int32), np.ones(1, np.float32)
    if g.weights is not None:
        alias_j, alias_q = build_alias_rows(indptr, V, max(g.num_edges, 1), g.weights)
    base0 = np.zeros(2, np.int32)
    arrays = (np.arange(V, dtype=np.int32), np.array([V, V], np.int32), base0, indptr, base0,
              g.indices.astype(np.int32), base0, alias_j, alias_q)  # fmt: skip
    return tuple(torch.as_tensor(a, device=dev) for a in arrays), remap_search_iters(V)


def _prev_outside_pair(lanes, n=900):
    """Move every real lane past hop 0 with its prev in block 2, outside
    both slots of a (block 0, block 1) pair."""
    r = np.random.default_rng(8)
    lanes[1][:n] = torch.as_tensor(r.integers(2000, 3000, n), dtype=torch.int32)
    lanes[3][:n] = lanes[3][:n].clamp(min=1)
    return lanes


def _check_launch(call, statics, contiguous):
    """One wrapper call equals the plain version bitwise, and each slot took
    the side of the contiguity guard given in ``contiguous``."""
    want = pair_advance_ref(*call, **statics)
    before = kernel.fused_advance_pair.launches
    got = kernel.fused_advance_pair(*call, **statics)
    torch.cuda.synchronize()
    assert kernel.fused_advance_pair.launches == before + 1
    for a, b in zip(want, got):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)
    assert kernel.contiguous_slots() == contiguous
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize(
    "case", ["pair", "dedup", "activated", "deadend", "oracle", "gathered", "prevmiss"]
)
@pytest.mark.parametrize("order", [1, 2])
def test_kernel_matches_plain_version(cuda, order, case, weighted, record):
    dead = case == "deadend"
    bg = _graph(weighted, dead)
    lanes = _lanes(bg, cuda, dead=dead)
    if case == "prevmiss":
        lanes = _prev_outside_pair(lanes)
    # slot 1 of a deduped pair and of the oracle takes slot 0's flag
    contiguous = {"activated": [True, False], "gathered": [True, False]}.get(case, [True, True])
    edges = bg.max_block_edges
    if case == "oracle":
        args, v_iters = _oracle_args(bg, cuda)
        edges = bg.num_edges
    else:
        pair = ResidentPair(bg, weighted, device=cuda)
        full = lambda b: BlockView.from_resident(bg.materialize_block(b))
        prev = lanes[1].cpu().numpy()[:900]
        outside = (prev >= 1000) & (lanes[3].cpu().numpy()[:900] > 0)
        v1 = {
            "dedup": lambda: pair.views[0],
            "activated": lambda: bg.partial_view(1, np.arange(1000, 2000, 3)),
            "gathered": lambda: bg.gather_view(np.unique(prev[outside])),  # as SOGW builds it
        }.get(case, lambda: full(1))
        pair.set_slot(0, full(0))
        pair.set_slot(1, v1())
        args, v_iters = pair.device_args()
    statics = dict(
        order=order,
        k_max=16 if order == 2 else 1,
        n_iters=int(np.ceil(np.log2(max(edges, 2)))) + 2,
        v_iters=v_iters,
        record=record,
        has_alias=weighted,
        max_len=LENGTH,
    )
    call = (*args, *lanes, key_halves(11), LENGTH, 0.85, 3.0, 0.5)
    got = _check_launch(call, statics, contiguous)
    assert int(got[4]) > 0
    if dead:  # the dead-end lanes died where they stood, writing no trace
        k = DEAD.size
        assert not got[3][:k].any()
        assert torch.equal(got[2][:k], lanes[3][:k])
        assert torch.equal(got[1][:k].cpu(), torch.as_tensor(DEAD, dtype=torch.int32))
        if record:
            assert (got[5][:k] == -1).all()


def _broken_run(bg, layout):
    """Block 1 as a view whose vids keep the block's end points and length
    but are not its contiguous run: 1500 dropped and 1501 repeated (a gap),
    or 1500 and 1501 swapped (unsorted)."""
    g = bg.graph
    vids = np.arange(1000, 2000)
    if layout == "gap":
        vids[500] = 1501
    else:
        vids[500], vids[501] = 1501, 1500
    segs = [g.indices[g.indptr[v] : g.indptr[v + 1]] for v in vids]
    alias = None
    if g.weights is not None:
        blk = bg.materialize_block(1)
        rows = [slice(blk.indptr[v - 1000], blk.indptr[v - 999]) for v in vids]
        alias = [(blk.alias_j[r], blk.alias_q[r]) for r in rows]
    return BlockView.from_rows(1, vids, segs, alias)


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("layout", ["gap", "swap", "few_iters"])
@pytest.mark.parametrize("order", [1, 2])
def test_kernel_contiguity_guard(cuda, order, layout, weighted):
    """Slots that look contiguous from their end points (or are contiguous
    but searched with too few halvings) keep the search, and walk exactly
    as the plain version does through the vertices where the O(1) remap
    would differ."""
    bg = _graph(weighted)
    pair = ResidentPair(bg, weighted, device=cuda)
    pair.set_slot(0, BlockView.from_resident(bg.materialize_block(0)))
    if layout == "few_iters":
        pair.set_slot(1, BlockView.from_resident(bg.materialize_block(1)))
    else:
        pair.set_slot(1, _broken_run(bg, layout))
    args, v_iters = pair.device_args()
    contiguous = [True, False]
    if layout == "few_iters":  # 2^6 < 1000 vertices: the search stops short in both slots
        v_iters, contiguous = 6, [False, False]
    lanes = _lanes(bg, cuda)
    # lanes on and next to the altered ids, as cur and as prev
    lanes[2][:8] = torch.as_tensor([1499, 1500, 1501, 1502] * 2, dtype=torch.int32)
    lanes[1][8:16] = torch.as_tensor([1499, 1500, 1501, 1502] * 2, dtype=torch.int32)
    lanes[3][:16] = 1
    lanes[4][:16] = True
    statics = dict(
        order=order, k_max=16 if order == 2 else 1, n_iters=20, v_iters=v_iters, record=True,
        has_alias=weighted, max_len=LENGTH,
    )  # fmt: skip
    call = (*args, *lanes, key_halves(12), LENGTH, 0.85, 3.0, 0.5)
    _check_launch(call, statics, contiguous)


@pytest.mark.gpu
def test_engine_kernel_matches_plain_version(cuda):
    from repro_torch.core import partition_into_n_blocks, rwnv_task

    bg = partition_into_n_blocks(erdos_renyi(2000, 16000, seed=2), 3)
    task = rwnv_task(p=4.0, q=0.25, walks_per_vertex=1, length=8, seed=2)
    kw = dict(record_walks=True, async_pipeline=False)
    before = kernel.fused_advance_pair.launches
    a = BiBlockEngine(bg, task, device=cuda, **kw).run()
    assert kernel.fused_advance_pair.launches - before == a.advance_calls > 0
    before = kernel.fused_advance_pair.launches
    b = BiBlockEngine(bg, task, device="cpu", **kw).run()
    assert kernel.fused_advance_pair.launches == before
    np.testing.assert_array_equal(a.endpoint_counts, b.endpoint_counts)
    np.testing.assert_array_equal(a.corpus, b.corpus)
    assert a.steps_sampled == b.steps_sampled
    assert a.stats.block_ios == b.stats.block_ios
    assert a.stats.ondemand_ios == b.stats.ondemand_ios


@pytest.mark.gpu
def test_wrapper_rejects_wrong_dtype(cuda):
    bg = _graph(False)
    pair = ResidentPair(bg, False, device=cuda)
    pair.set_slot(0, BlockView.from_resident(bg.materialize_block(0)))
    pair.set_slot(1, BlockView.from_resident(bg.materialize_block(1)))
    args, v_iters = pair.device_args()
    lanes = _lanes(bg, cuda)
    lanes[1] = lanes[1].long()
    with pytest.raises(TypeError, match="prev"):
        kernel.fused_advance_pair(
            *args, *lanes, key_halves(0), LENGTH, 1.0, 1.0, 1.0,
            order=2, k_max=1, n_iters=4, v_iters=v_iters, record=False,
            has_alias=False, max_len=LENGTH,
        )  # fmt: skip


@pytest.mark.gpu
@pytest.mark.parametrize("max_len", [LENGTH, LENGTH - 2], ids=["full", "clamped"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize(
    "case", ["pair", "dedup", "activated", "deadend", "oracle", "gathered", "prevmiss"]
)
@pytest.mark.parametrize("order", [1, 2])
def test_kernel_corpus_matches_plain_version(cuda, order, case, weighted, max_len):
    """Recording into a corpus on the card, the kernel writes each step
    into its walk's row exactly as the plain version does: permuted walk
    ids, padded dead lanes on walk id 0 (row 0 stays as it was), two
    successive calls on one corpus, and hops past ``max_len`` clamped to
    its column."""
    dead = case == "deadend"
    bg = _graph(weighted, dead)
    lanes = _lanes(bg, cuda, dead=dead)
    if case == "prevmiss":
        lanes = _prev_outside_pair(lanes)
    rows = 4001
    ids = np.random.default_rng(6).permutation(np.arange(1, rows))[:900]
    lanes[0][:900] = torch.as_tensor(ids, dtype=torch.int32, device=cuda)
    edges = bg.max_block_edges
    if case == "oracle":
        args, v_iters = _oracle_args(bg, cuda)
        edges = bg.num_edges
    else:
        pair = ResidentPair(bg, weighted, device=cuda)
        full = lambda b: BlockView.from_resident(bg.materialize_block(b))
        prev = lanes[1].cpu().numpy()[:900]
        outside = (prev >= 1000) & (lanes[3].cpu().numpy()[:900] > 0)
        v1 = {
            "dedup": lambda: pair.views[0],
            "activated": lambda: bg.partial_view(1, np.arange(1000, 2000, 3)),
            "gathered": lambda: bg.gather_view(np.unique(prev[outside])),
        }.get(case, lambda: full(1))
        pair.set_slot(0, full(0))
        pair.set_slot(1, v1())
        args, v_iters = pair.device_args()
    statics = dict(
        order=order, k_max=16 if order == 2 else 1,
        n_iters=int(np.ceil(np.log2(max(edges, 2)))) + 2, v_iters=v_iters, record=True,
        has_alias=weighted, max_len=max_len,
    )  # fmt: skip
    start = torch.full((rows, max_len + 1), -1, dtype=torch.int32, device=cuda)
    start[:, 0] = torch.arange(rows, device=cuda, dtype=torch.int32) % 3000
    want, got = start.clone(), start.clone()
    state = lanes
    for call, hops in enumerate((2, None)):  # a partial advance, then the rest
        call_args = (*args, *state, key_halves(13), LENGTH, 0.85, 3.0, 0.5)
        a = pair_advance_ref(*call_args, max_hops=hops, corpus=want, **statics)
        b = kernel.fused_advance_pair(*call_args, max_hops=hops, corpus=got, **statics)
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            assert x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y), call
        assert b[5].shape == (1, 1) and int(b[5]) == -1
        assert torch.equal(want, got), call
        state = [lanes[0], *b[:4]]
    assert not torch.equal(got, start)
    assert torch.equal(got[0], start[0])  # the padded lanes wrote nothing
    if max_len < LENGTH:
        assert bool((b[2][:900] > max_len).any())


@pytest.mark.gpu
def test_wrapper_rejects_a_wrong_corpus(cuda):
    bg = _graph(False)
    pair = ResidentPair(bg, False, device=cuda)
    pair.set_slot(0, BlockView.from_resident(bg.materialize_block(0)))
    pair.set_slot(1, BlockView.from_resident(bg.materialize_block(1)))
    args, v_iters = pair.device_args()
    lanes = _lanes(bg, cuda)
    call = (*args, *lanes, key_halves(0), LENGTH, 1.0, 1.0, 1.0)
    statics = dict(order=2, k_max=1, n_iters=4, v_iters=v_iters, record=True, has_alias=False,
                   max_len=LENGTH)  # fmt: skip
    good = torch.full((4000, LENGTH + 1), -1, dtype=torch.int32, device=cuda)
    for bad, err in (
        (good.long(), TypeError),
        (good.cpu(), ValueError),
        (good[:, :LENGTH], ValueError),
        (good.t().contiguous().t(), ValueError),
    ):
        with pytest.raises(err, match="corpus"):
            kernel.fused_advance_pair(*call, corpus=bad, **statics)


@pytest.mark.gpu
def test_engine_device_corpus_matches_cpu(cuda, monkeypatch):
    """A recording bi-block engine on the card keeps its corpus there and
    gives the corpus of the same engine on the CPU; forced onto the host
    path, the card's engine gives it too.  With the fetch's chunk cut to
    16 KiB, two card engines of different seeds run back to back: each
    fetch takes ceil(bytes / chunk) chunks through the page-locked ring,
    each corpus is the CPU engine's, and the second fetch leaves the first
    corpus as it was."""
    from repro_torch.core import partition_into_n_blocks, rwnv_task, spans
    from repro_torch.engines import base

    chunk = 16 << 10
    monkeypatch.setattr(base, "FETCH_CHUNK_BYTES", chunk)
    bg = partition_into_n_blocks(erdos_renyi(2000, 16000, seed=2), 3)
    tasks = [rwnv_task(p=4.0, q=0.25, walks_per_vertex=2, length=8, seed=s) for s in (2, 3)]
    kw = dict(record_walks=True, async_pipeline=False)
    cpu = [BiBlockEngine(bg, t, device="cpu", **kw).run() for t in tasks]
    assert cpu[0].corpus.tobytes() != cpu[1].corpus.tobytes()
    spans.take()
    spans.enable()
    try:
        card = []
        for t in tasks:
            card.append(BiBlockEngine(bg, t, device=cuda, **kw).run())
            _, counts = spans.take()
            assert counts.get("corpus.device") == 1 and "corpus.host" not in counts
            nbytes = card[-1].corpus.nbytes
            assert nbytes > 4 * chunk
            assert counts["corpus.fetch.chunks"] == -(-nbytes // chunk)
        ring = base._fetch_rings[torch.device("cuda", torch.cuda.current_device())]
        assert all(buf.is_pinned() and buf.numel() == chunk for buf in ring)
        monkeypatch.setattr(base, "corpus_fits", lambda nbytes, device: False)
        host = BiBlockEngine(bg, tasks[0], device=cuda, **kw).run()
        _, counts = spans.take()
        assert counts.get("corpus.host") == 1 and "corpus.device" not in counts
        assert "corpus.fetch.chunks" not in counts
    finally:
        spans.disable()
        spans.take()
    for res, want in zip([*card, host], [*cpu, cpu[0]]):
        assert isinstance(res.corpus, np.ndarray) and res.corpus.dtype == np.int32
        assert res.corpus.flags.c_contiguous
        assert not any(np.shares_memory(res.corpus, buf.numpy()) for buf in ring)
        np.testing.assert_array_equal(res.corpus, want.corpus)
        np.testing.assert_array_equal(res.endpoint_counts, want.endpoint_counts)
        assert res.steps_sampled == want.steps_sampled


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
def test_device_built_pair_matches_cpu(cuda, weighted):
    """The card's pair, its segments built through page-locked staging, kept
    by block and assembled on the card, gives the CPU pair's arrays byte for
    byte over a run of slot changes: slot 1 full, activated, extended and
    another block's full view beside a fixed slot 0, then a new slot 0, then
    one view in both slots."""
    bg = _graph(weighted)
    full = lambda b: BlockView.from_resident(bg.materialize_block(b))  # noqa: E731
    act = bg.partial_view(2, np.arange(2000, 3000, 3))
    ext = act.extended(bg.partial_view(2, np.arange(2001, 3000, 3)))
    both = full(1)
    calls = [
        [(0, full(0)), (1, full(1))], [(1, act)], [(1, ext)], [(1, full(2))],
        [(0, full(2)), (1, full(1))], [(0, both), (1, both)], [(0, ext), (1, ext)],
    ]  # fmt: skip
    cpu = ResidentPair(bg, weighted, device="cpu")
    card = ResidentPair(bg, weighted, device=cuda)
    for call in calls:
        for s, v in call:
            cpu.set_slot(s, v)
            card.set_slot(s, v)
        want, wv = cpu.device_args()
        got, gv = card.device_args()
        assert gv == wv
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and a.is_contiguous()
            a = a.cpu().numpy()
            assert a.dtype == b.numpy().dtype and a.tobytes() == b.numpy().tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
def test_engine_ondemand_on_card_matches_cpu(cuda, weighted):
    """An 8-block run with on-demand loading, whose pair stages a new
    activated view through page-locked memory at almost every call, walks
    on the card exactly as on the CPU: no staging buffer was written again
    before its copy had completed."""
    from repro_torch.core import partition_into_n_blocks, rwnv_task

    g = erdos_renyi(4000, 32000, seed=6)
    if weighted:
        w = np.random.default_rng(6).uniform(0.1, 2.0, g.indices.shape).astype(np.float32)
        g = CSRGraph(g.indptr, g.indices, w)
    starts = partition_into_n_blocks(g, 8).block_starts
    bg = BlockedGraph(g, starts, build_alias=weighted)
    task = rwnv_task(p=4.0, q=0.25, walks_per_vertex=2, length=10, seed=6)
    kw = dict(loading="ondemand", record_walks=True, async_pipeline=False)
    cpu = BiBlockEngine(bg, task, device="cpu", **kw).run()
    card = BiBlockEngine(bg, task, device=cuda, **kw).run()
    assert card.advance_calls == cpu.advance_calls > 8
    assert card.stats.ondemand_ios == cpu.stats.ondemand_ios > 0
    np.testing.assert_array_equal(card.corpus, cpu.corpus)
    np.testing.assert_array_equal(card.endpoint_counts, cpu.endpoint_counts)
    assert card.steps_sampled == cpu.steps_sampled
    assert card.stats.peak_resident_bytes == cpu.stats.peak_resident_bytes


@pytest.mark.gpu
@pytest.mark.parametrize("max_hops", [1, 2])
@pytest.mark.parametrize("order", [1, 2])
def test_kernel_max_hops_matches_plain_version(cuda, order, max_hops):
    bg = _graph(False)
    pair = ResidentPair(bg, False, device=cuda)
    pair.set_slot(0, BlockView.from_resident(bg.materialize_block(0)))
    pair.set_slot(1, BlockView.from_resident(bg.materialize_block(1)))
    args, v_iters = pair.device_args()
    statics = dict(
        order=order, k_max=16 if order == 2 else 1, n_iters=20, v_iters=v_iters, record=True,
        has_alias=False, max_len=LENGTH, max_hops=max_hops,
    )  # fmt: skip
    lanes = _lanes(bg, cuda)
    call = (*args, *lanes, key_halves(3), LENGTH, 1.0, 4.0, 0.25)
    want = pair_advance_ref(*call, **statics)
    got = kernel.fused_advance_pair(*call, **statics)
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert int((got[2] - lanes[3]).max()) == max_hops


# ---- the bucket histogram ---------------------------------------------------


def _hist_inputs(n, nb, dev, seed=0):
    r = np.random.default_rng(seed)
    ids = r.integers(0, nb, n).astype(np.int32)
    out = r.random(n) < 0.05  # out of range on both sides
    ids[out] = r.choice([-1, -7, nb, nb + 3], out.sum())
    valid = r.random(n) < 0.7
    return torch.as_tensor(ids, device=dev), torch.as_tensor(valid, device=dev)


#: the path the host plan takes on an H100 (132 SMs, 232,448 bytes of
#: shared memory per block) at 1,048,576 walks, the main path's count: both
#: sides of each of its limits, and past the shared paths' capacity (4
#: ranges of 58,112 bins)
_H100_PATHS = {
    1: "block", 16: "block", 248: "block", 249: "block", 283: "block", 284: "block",
    300: "block", 512: "block", 513: "block", 682: "block", 683: "block", 1024: "block",
    1025: "range", 2048: "range", 2049: "range", 4096: "range", 18724: "range", 18725: "range",
    29127: "range", 29128: "range", 58112: "range", 58113: "range", 65536: "range", 80659: "range",
    80660: "global", 104857: "global", 104858: "global", 232449: "global", 464897: "global",
}  # fmt: skip
#: the bin ranges of the range path there
_H100_RANGES = {
    1025: 2, 2048: 2, 2049: 2, 4096: 2, 18724: 2, 18725: 4, 29127: 4, 29128: 4, 58112: 4,
    58113: 4, 65536: 4, 80659: 4,
}  # fmt: skip


@pytest.mark.gpu
@pytest.mark.parametrize("nb", sorted(_H100_PATHS))
@pytest.mark.parametrize("n", [1024, 1 << 17, 1 << 20])
def test_bucket_hist_matches_plain_version(cuda, n, nb):
    from repro_torch.kernels import bucket_hist as bh

    ids, valid = _hist_inputs(n, nb, cuda)
    want = bh.bucket_hist_ref(ids, valid, num_buckets=nb)
    before = bh.bucket_hist_kernel.launches
    got = bh.bucket_hist_kernel(ids, valid, num_buckets=nb)
    torch.cuda.synchronize()
    assert bh.bucket_hist_kernel.launches == before + 1
    assert got.dtype == torch.int32 and got.device == ids.device
    assert torch.equal(got, want)
    card = bh.device_info(cuda)
    if (card.sms, card.smem_block, card.smem_sm) == (132, 232448, 233472) and n == 1 << 20:
        assert bh.plan(n, nb, card).path == _H100_PATHS[nb]
        assert bh.plan(n, nb, card).ranges == _H100_RANGES.get(nb, 1)


def _forced(path, nb):
    """A plan for ``path`` at ``nb`` bins, whatever the plan would choose."""
    from repro_torch.kernels.bucket_hist import Plan

    if path == "block":
        return Plan("block", 1, 8, 1024)
    if path == "range":  # three ranges: the last one shorter than the others
        return Plan("range", 3, 12, 1024)
    return Plan("global", 1, 64, 256)


_FORCED_PATHS = ["block", "range", "global"]


@pytest.mark.gpu
@pytest.mark.parametrize("path", _FORCED_PATHS)
def test_bucket_hist_both_paths_at_small_nb(cuda, path):
    from repro_torch.kernels import bucket_hist as bh

    ids, valid = _hist_inputs(1 << 16, 300, cuda, seed=1)
    out = torch.zeros(300, dtype=torch.int32, device=cuda)
    assert bh._launch(ids, valid, out, forced=_forced(path, 300)).path == path
    torch.cuda.synchronize()
    assert torch.equal(out, bh.bucket_hist_ref(ids, valid, num_buckets=300))


@pytest.mark.gpu
@pytest.mark.parametrize("path", _FORCED_PATHS)
def test_bucket_hist_counts_nothing_invalid_or_out_of_range(cuda, path):
    from repro_torch.kernels import bucket_hist as bh

    ids, valid = _hist_inputs(1 << 14, 40, cuda, seed=2)
    outside = torch.where(ids % 2 == 0, -1 - ids.abs(), 40 + ids.abs())  # both sides
    for ids_, valid_ in ((ids, torch.zeros_like(valid)), (outside, valid)):
        out = torch.full((40,), 7, dtype=torch.int32, device=cuda)
        bh._launch(ids_, valid_, out, forced=_forced(path, 40), zero=True)
        torch.cuda.synchronize()
        assert out.tolist() == [0] * 40


@pytest.mark.gpu
def test_bucket_hist_errors_and_empty(cuda):
    from repro_torch.kernels import bucket_hist as bh

    ids, valid = _hist_inputs(2048, 8, cuda)
    with pytest.raises(TypeError, match="valid"):
        bh.bucket_hist_kernel(ids, valid.to(torch.int32), num_buckets=8)
    with pytest.raises(TypeError, match="ids"):
        bh.bucket_hist_kernel(ids.long(), valid, num_buckets=8)
    with pytest.raises(ValueError, match="multiple of 1024"):
        bh.bucket_hist_kernel(ids[:1000], valid[:1000], num_buckets=8)
    with pytest.raises(ValueError, match="valid is on"):
        bh.bucket_hist_kernel(ids, valid.cpu(), num_buckets=8)
    empty = bh.bucket_hist_kernel(ids[:0], valid[:0], num_buckets=8)
    assert empty.device == ids.device and empty.tolist() == [0] * 8
    # the kernel reads 16 bytes of ids and 4 of flags at a time
    with pytest.raises(ValueError, match="16-byte boundary"):
        bh.bucket_hist_kernel(ids[1:1025], valid[:1024], num_buckets=8)
    with pytest.raises(ValueError, match="16-byte boundary"):
        bh.bucket_hist_kernel(ids[:1024], valid[1:1025], num_buckets=8)
    # a plan with more bins than a block's shared memory holds is refused
    # by the launch
    with pytest.raises(RuntimeError, match="CUDA error"):
        bh._launch(ids, valid, torch.zeros(1 << 17, dtype=torch.int32, device=cuda),
                   forced=_forced("block", 1 << 17))  # fmt: skip


# ---- the single-hop kernel tier --------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("pq", [(1.0, 1.0), (4.0, 0.25)])
def test_node2vec_step_kernel_matches_dense_oracle(cuda, pq, weighted):
    from repro_torch.kernels import alias_step, node2vec_step

    bg = _graph(weighted)
    pair = ResidentPair(bg, weighted, device=cuda)
    pair.set_slot(0, BlockView.from_resident(bg.materialize_block(0)))
    pair.set_slot(1, BlockView.from_resident(bg.materialize_block(2)))
    args, v_iters = pair.device_args()
    wid, prev, cur, hop, alive = _lanes(bg, cuda, n=512)
    kw = dict(p=pq[0], q=pq[1], k_max=4, n_iters=20, v_iters=v_iters, has_alias=weighted)
    before = kernel.fused_advance_pair.launches
    zk, mk = node2vec_step(*args, wid, prev, cur, hop, alive, key_halves(9), **kw)
    zr, mr = node2vec_step(*args, wid, prev, cur, hop, alive, key_halves(9), use_kernel=False, **kw)
    torch.cuda.synchronize()
    assert kernel.fused_advance_pair.launches == before + 1
    assert torch.equal(zk, zr) and torch.equal(mk, mr)
    assert int(mk.sum()) > 0
    ak = alias_step(*args, wid, cur, alive, key_halves(9), v_iters=v_iters, has_alias=weighted)
    ar = alias_step(*args, wid, cur, alive, key_halves(9), v_iters=v_iters, has_alias=weighted,
                    use_kernel=False)  # fmt: skip
    assert all(torch.equal(a, b) for a, b in zip(ak, ar))


# ---- the other engines -----------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["oracle", "pb", "sogw", "sgsc"])
def test_other_engines_kernel_match_plain_version(cuda, engine):
    from repro_torch.core import (
        InMemoryWalker, PlainBucketEngine, SOGWEngine, partition_into_n_blocks, rwnv_task,
    )  # fmt: skip

    bg = partition_into_n_blocks(erdos_renyi(2000, 16000, seed=2), 3)
    task = rwnv_task(p=4.0, q=0.25, walks_per_vertex=1, length=8, seed=2)
    runs = {}
    for dev in (cuda, "cpu"):
        kw = dict(device=dev)
        before = kernel.fused_advance_pair.launches
        if engine == "oracle":
            res = InMemoryWalker(bg, task, **kw).run()
        elif engine == "pb":
            res = PlainBucketEngine(bg, task, record_walks=True, **kw).run()
        else:
            res = SOGWEngine(bg, task, static_cache=engine == "sgsc", record_walks=True, **kw).run()
        launched = kernel.fused_advance_pair.launches - before
        assert launched == (res.advance_calls if dev == cuda else 0)
        runs[dev] = res
    a, b = runs[cuda], runs["cpu"]
    np.testing.assert_array_equal(a.endpoint_counts, b.endpoint_counts)
    np.testing.assert_array_equal(a.corpus, b.corpus)
    assert a.steps_sampled == b.steps_sampled
    for field in ("block_ios", "vertex_ios", "vertex_bytes", "ondemand_ios", "walk_bytes_written"):
        assert getattr(a.stats, field) == getattr(b.stats, field)
    oracle = InMemoryWalker(bg, task, device=cuda).run()
    np.testing.assert_array_equal(a.endpoint_counts, oracle.endpoint_counts)


# ---- the query server ------------------------------------------------------


@pytest.mark.gpu
def test_server_kernel_matches_plain_version(cuda):
    """A small server on the card against the same server on the CPU: the
    same answers and charges, and one launch per advance on the card."""
    from repro_torch.core import barabasi_albert, partition_into_n_blocks
    from repro_torch.serve import QueryConfig, WalkQueryServer

    bg = partition_into_n_blocks(barabasi_albert(2000, 5, seed=3), 4)
    r = np.random.default_rng(7)
    hot = int(bg.block_starts[1])
    sources = np.where(r.random(48) < 0.85, r.integers(0, hot, 48), r.integers(0, 2000, 48))
    cfg = QueryConfig(p=4.0, q=0.25, length=10, samples=16)
    runs = {}
    for dev in (cuda, "cpu"):
        before = kernel.fused_advance_pair.launches
        with WalkQueryServer(bg, max_batch=16, hot_blocks=2, seed=5, device=dev) as server:
            for s in sources:
                server.submit(int(s), cfg)
            answers = server.flush()
        launched = kernel.fused_advance_pair.launches - before
        assert launched == (server.advance_calls if dev == cuda else 0)
        assert server.advance_calls > 0 and server.batches_served == 3
        runs[dev] = (answers, server.stats.as_dict())
    (ac, sc), (at, st) = runs[cuda], runs["cpu"]
    for a, b in zip(ac, at):
        assert a.qid == b.qid and a.source == b.source
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.counts, b.counts)
        assert int(a.counts.sum()) == cfg.samples
    timing = {"exec_time", "sim_wall_time", "writer_queue_peak"}
    assert {k: v for k, v in sc.items() if k not in timing} == {
        k: v for k, v in st.items() if k not in timing
    }
    assert sc["pinned_block_hits"] > 0
