"""The port's bi-block engine walks exactly as the JAX package's does.

Same graph, task and seed through ``repro``'s ``BiBlockEngine``
(``advance_impl="jax"``) and the port's (``device="cpu"``, the plain
PyTorch advance): endpoint counts, corpus, step counts and every
deterministic ``IOStats`` charge must be identical across {full, ondemand,
auto} loading x {ram, disk} graph x {memory, disk} pool, serially and under
the async pipeline with ``pool_shards`` in {1, 4}, for node2vec (order 2)
and DeepWalk (order 1), and on a weighted graph (alias proposals) with full
and on-demand loading.  Tolerance: bitwise.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI legs without it skip

import repro.io as jio  # noqa: E402
import repro_torch.io as tio  # noqa: E402
from repro.core import BiBlockEngine as JBiBlockEngine  # noqa: E402
from repro.core import BlockedGraph as JBlockedGraph  # noqa: E402
from repro.core import CSRGraph as JCSRGraph  # noqa: E402
from repro.core import deepwalk_task as j_deepwalk  # noqa: E402
from repro.core import erdos_renyi, partition_into_n_blocks  # noqa: E402
from repro.core import rwnv_task as j_rwnv  # noqa: E402
from repro.testing import given, settings, st  # noqa: E402
from repro_torch.convert import blocked_graph_from_arrays  # noqa: E402
from repro_torch.core import deepwalk_task as t_deepwalk  # noqa: E402
from repro_torch.core import rwnv_task as t_rwnv  # noqa: E402
from repro_torch.engines import BiBlockEngine as TBiBlockEngine  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _sig(res):
    return (
        res.endpoint_counts.tobytes(),
        None if res.corpus is None else res.corpus.tobytes(),
        res.stats.steps_sampled,
        res.stats.block_ios,
        res.stats.block_bytes,
        res.stats.ondemand_ios,
        res.stats.ondemand_bytes,
        res.stats.walk_bytes_written,
        res.stats.peak_resident_bytes,
    )


def _graphs(seed=3, nv=90, nblocks=3):
    jbg = partition_into_n_blocks(erdos_renyi(nv, nv * 5, seed=seed), nblocks)
    g = jbg.graph
    return jbg, blocked_graph_from_arrays(g.indptr, g.indices, None, jbg.block_starts)


def _weighted_graphs(seed=3, nv=90, nblocks=3):
    """The graph of :func:`_graphs` with seeded edge weights, alias tables
    built on both sides."""
    jbg, _ = _graphs(seed, nv, nblocks)
    g = jbg.graph
    w = np.random.default_rng(seed).uniform(0.1, 2.0, g.indices.shape).astype(np.float32)
    jbgw = JBlockedGraph(JCSRGraph(g.indptr, g.indices, w), jbg.block_starts, build_alias=True)
    tbgw = blocked_graph_from_arrays(g.indptr, g.indices, w, jbg.block_starts)
    tbgw.ensure_alias()
    return jbgw, tbgw


def _tasks(order, seed=3):
    if order == 2:
        kw = dict(p=3.0, q=0.5, walks_per_vertex=1, length=6, seed=seed)
        return j_rwnv(**kw), t_rwnv(**kw)
    kw = dict(walks_per_vertex=1, length=8, seed=seed)
    return j_deepwalk(**kw), t_deepwalk(**kw)


def _open(bg, backend, io, path):
    if backend == "ram":
        return bg
    io.write_block_file(bg, path)
    return io.DiskBlockedGraph(path)


def _pair_of_runs(tmp_path, jbg, tbg, order, backend, **kw):
    jtask, ttask = _tasks(order)
    out = {}
    for name, bg, task, engine, io, extra in (
        ("jax", jbg, jtask, JBiBlockEngine, jio, dict(advance_impl="jax")),
        ("torch", tbg, ttask, TBiBlockEngine, tio, dict(device="cpu")),
    ):
        bgx = _open(bg, backend, io, str(tmp_path / f"{name}.grb"))
        pool_dir = str(tmp_path / f"pool_{name}")
        try:
            res = engine(bgx, task, record_walks=True, pool_dir=pool_dir, **kw, **extra).run()
        finally:
            if backend == "disk":
                bgx.close()
        out[name] = res
    return out


@pytest.mark.parametrize("pool", ["memory", "disk"])
@pytest.mark.parametrize("backend", ["ram", "disk"])
@pytest.mark.parametrize("loading", ["full", "ondemand", "auto"])
def test_biblock_matrix_matches_jax(tmp_path, loading, backend, pool):
    jbg, tbg = _graphs()
    runs = _pair_of_runs(
        tmp_path, jbg, tbg, 2, backend, loading=loading, pool=pool, async_pipeline=False
    )
    assert _sig(runs["torch"]) == _sig(runs["jax"]), (loading, backend, pool)
    res = runs["torch"]
    assert res.endpoint_counts.sum() == res.num_walks
    assert res.advance_calls > 0


@pytest.mark.parametrize("shards", [1, 4])
def test_biblock_async_shards_matches_jax(tmp_path, shards):
    jbg, tbg = _graphs()
    runs = _pair_of_runs(
        tmp_path, jbg, tbg, 2, "ram", pool="disk", async_pipeline=True, pool_shards=shards
    )
    a, b = runs["jax"], runs["torch"]
    np.testing.assert_array_equal(a.endpoint_counts, b.endpoint_counts)
    np.testing.assert_array_equal(a.corpus, b.corpus)
    assert _sig(a)[2:7] == _sig(b)[2:7]


@pytest.mark.parametrize("loading", ["full", "ondemand"])
def test_biblock_deepwalk_first_order_matches_jax(tmp_path, loading):
    jbg, tbg = _graphs()
    runs = _pair_of_runs(tmp_path, jbg, tbg, 1, "ram", loading=loading, async_pipeline=False)
    assert _sig(runs["torch"]) == _sig(runs["jax"])


#: IOStats charges that do not depend on wall clock or thread timing
CHARGES = (
    "block_ios", "block_bytes", "vertex_ios", "vertex_bytes", "walk_ios", "walk_bytes",
    "walk_bytes_written", "walk_bytes_read", "ondemand_ios", "ondemand_bytes",
    "ondemand_syscalls", "coalesced_ranges", "coalesce_waste_bytes", "peak_resident_bytes",
    "time_slots", "supersteps", "steps_sampled", "bucket_executions", "sim_block_io_time",
    "sim_vertex_io_time", "sim_ondemand_io_time",
)  # fmt: skip


def _charges(res):
    return [getattr(res.stats, k) for k in CHARGES] + [dict(res.stats.per_block_loads)]


def _kept_and_fresh_runs(monkeypatch, tbg, ttask, **kw):
    """Runs of one task through a pair that keeps its full views (the
    engine's) and one that keeps none; each with the ``(block, kind)`` of
    every segment its pair built."""
    from repro_torch.engines.base import ResidentPair

    builds = []
    build = ResidentPair._build

    def counted(pair, view):
        builds.append((view.block_id, view.kind))
        return build(pair, view)

    monkeypatch.setattr(ResidentPair, "_build", counted)
    runs = {}
    for keep in (2, 0):
        eng = TBiBlockEngine(tbg, ttask, device="cpu", **kw)
        assert eng.pair.keep_full == 2
        eng.pair.keep_full = keep
        builds.clear()
        runs[keep] = (eng.run(), list(builds))
    return runs[2], runs[0]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("loading", ["full", "auto"])
def test_first_order_pair_uploads_each_full_view_once(monkeypatch, loading, weighted):
    """On 2 blocks a DeepWalk pair keeps both blocks' full views on its
    device: each is built and uploaded once a run, not once a visit, and
    the walks, charges and peak gauge are those of a pair that uploads
    every visit and of the JAX package."""
    jbg, tbg = (_weighted_graphs if weighted else _graphs)(seed=5, nv=200, nblocks=2)
    jtask, ttask = _tasks(1, seed=5)
    kw = dict(loading=loading, record_walks=True, async_pipeline=False)
    (kept, kept_up), (fresh, fresh_up) = _kept_and_fresh_runs(monkeypatch, tbg, ttask, **kw)
    kinds, fresh_kinds = [k for _, k in kept_up], [k for _, k in fresh_up]
    assert kinds.count("full") == 2 < fresh_kinds.count("full")
    assert kinds.count("activated") == fresh_kinds.count("activated")
    assert _sig(kept) == _sig(fresh)
    assert _sig(kept) == _sig(JBiBlockEngine(jbg, jtask, **kw).run())


def _node2vec_tasks(traffic, tbg, seed=5):
    """A node2vec RWNV task or a PRNV query from the vertex of most edges,
    for both packages."""
    from repro.core import prnv_task as j_prnv
    from repro_torch.core import prnv_task as t_prnv

    if traffic == "rwnv":
        return _tasks(2, seed)
    deg = np.diff(tbg.graph.indptr)
    kw = dict(p=3.0, q=0.5, length=6, samples_per_vertex=2, seed=seed)
    src = int(np.argmax(deg))
    return j_prnv(src, tbg.num_vertices, **kw), t_prnv(src, tbg.num_vertices, **kw)


@pytest.mark.parametrize("traffic", ["rwnv", "prnv"])
@pytest.mark.parametrize("loading", ["full", "auto"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("nblocks", [2, 8])
def test_second_order_pair_keeps_full_views(monkeypatch, nblocks, weighted, loading, traffic):
    """A node2vec pair keeps its full views on its device too: the walks,
    endpoint counts, corpus, every IOStats charge and the peak gauge equal
    those of a pair that keeps none and of the JAX package; on 2 blocks
    each block's full view is built once a run."""
    jbg, tbg = (_weighted_graphs if weighted else _graphs)(seed=5, nv=200, nblocks=nblocks)
    jtask, ttask = _node2vec_tasks(traffic, tbg)
    kw = dict(loading=loading, record_walks=True, async_pipeline=False)
    (kept, kept_up), (fresh, fresh_up) = _kept_and_fresh_runs(monkeypatch, tbg, ttask, **kw)
    want = JBiBlockEngine(jbg, jtask, **kw).run()
    assert _sig(kept) == _sig(fresh) == _sig(want)
    assert _charges(kept) == _charges(fresh) == _charges(want)
    assert kept.advance_calls == fresh.advance_calls > 0
    full = [b for b, k in kept_up if k == "full"]
    fresh_full = [b for b, k in fresh_up if k == "full"]
    assert [k for _, k in kept_up if k != "full"] == [k for _, k in fresh_up if k != "full"]
    assert len(full) < len(fresh_full)
    if nblocks == 2:
        assert sorted(full) == sorted(set(fresh_full)) == [0, 1]


def _pair_calls(jbg, tbg):
    """A run of slot changes an engine makes, as ``(slot, view)`` lists of
    each call, for both packages: slot 0 fixed while slot 1 goes from a full
    view to an activated one, to that view extended, to another block's
    full view; then slot 0 changes; then both slots hold one view."""
    from repro.core.graph import BlockView as JBlockView
    from repro_torch.core.graph import BlockView as TBlockView

    out = []
    for bg, view_cls in ((jbg, JBlockView), (tbg, TBlockView)):
        full = lambda b: view_cls.from_resident(bg.materialize_block(b))  # noqa: E731
        s, e = int(bg.block_starts[2]), int(bg.block_starts[3])
        act = bg.partial_view(2, np.arange(s, e, 3))
        ext = act.extended(bg.partial_view(2, np.arange(s + 1, e, 3)))
        both = full(1)
        out.append(
            [
                [(0, full(0)), (1, full(1))],
                [(1, act)],
                [(1, ext)],
                [(1, full(3))],
                [(0, full(3)), (1, full(1))],
                [(0, both), (1, both)],
                [(0, ext), (1, ext)],
            ]
        )
    return out


@pytest.mark.parametrize("weighted", [False, True])
def test_pair_packing_sequence_matches_jax(weighted):
    """Over a run of ``set_slot`` / ``device_args`` calls the port's pair,
    which keeps full-view segments on its device and assembles the pair
    there, returns the JAX package's packed arrays byte for byte, with the
    same ``v_iters``; the counters say which segments were built and which
    kept."""
    from repro.engines.base import ResidentPair as JResidentPair
    from repro_torch.core import spans
    from repro_torch.engines.base import ResidentPair as TResidentPair

    jbg, tbg = (_weighted_graphs if weighted else _graphs)(seed=5, nv=200, nblocks=4)
    jpair = JResidentPair(jbg, weighted)
    tpair = TResidentPair(tbg, weighted, device="cpu")
    # (built, kept) a call: block 0's full view stays kept while slot 1
    # changes; block 1's, dropped for block 3's, is built again, and then
    # kept; activated views are built every call
    want_counts = [(2, 0), (1, 1), (1, 1), (1, 1), (1, 1), (0, 1), (1, 0)]
    spans.take()
    spans.enable()
    try:
        for jcall, tcall, counts in zip(*_pair_calls(jbg, tbg), want_counts):
            for s, v in jcall:
                jpair.set_slot(s, v)
            for s, v in tcall:
                tpair.set_slot(s, v)
            jargs, jv = jpair.device_args()
            targs, tv = tpair.device_args()
            _, got = spans.take()
            assert (got.get("pair.segment.built", 0), got.get("pair.segment.kept", 0)) == counts
            assert tv == jv
            for a, b in zip(jargs, targs):
                a, b = np.asarray(a), b.numpy()
                assert b.dtype == a.dtype and b.shape == a.shape
                assert b.tobytes() == a.tobytes()
    finally:
        spans.disable()
        spans.take()


@pytest.mark.parametrize("loading", ["full", "ondemand"])
def test_biblock_weighted_matches_jax(tmp_path, loading):
    """A weighted graph walks through the alias tables of both packages'
    packed pairs (full blocks, and activated views under on-demand loading)."""
    jbg, tbg = _weighted_graphs()
    assert jbg.has_weights and tbg.has_weights
    runs = _pair_of_runs(tmp_path, jbg, tbg, 2, "ram", loading=loading, async_pipeline=False)
    assert _sig(runs["torch"]) == _sig(runs["jax"]), loading
    res = runs["torch"]
    assert res.endpoint_counts.sum() == res.num_walks
    assert res.advance_calls > 0
    assert (res.stats.ondemand_ios > 0) == (loading == "ondemand")


@given(seed=st.integers(0, 10_000), nv=st.integers(50, 100), nblocks=st.integers(2, 4))
@settings(max_examples=2, deadline=None)
def test_biblock_random_graphs_match_jax(seed, nv, nblocks):
    jbg, tbg = _graphs(seed, nv, nblocks)
    jtask, ttask = _tasks(2, seed)
    a = JBiBlockEngine(jbg, jtask, record_walks=True, async_pipeline=False).run()
    b = TBiBlockEngine(tbg, ttask, record_walks=True, async_pipeline=False, device="cpu").run()
    assert _sig(a) == _sig(b)


def test_cuda_impl_on_cpu_tensors_takes_plain_version():
    """An engine on CPU tensors runs the kernel wrapper's plain path (no
    launch) and walks as the JAX engine does."""
    from repro_torch.kernels.pair_advance import fused_advance_pair

    jbg, tbg = _graphs()
    jtask, ttask = _tasks(2)
    before = fused_advance_pair.launches
    kw = dict(record_walks=True, async_pipeline=False)
    a = TBiBlockEngine(tbg, ttask, device="cpu", **kw).run()
    assert fused_advance_pair.launches == before
    assert _sig(a) == _sig(JBiBlockEngine(jbg, jtask, **kw).run())


@pytest.mark.parametrize("engine", ["biblock", "pb", "sogw", "oracle"])
def test_device_corpus_matches_host_fallback(monkeypatch, engine):
    """The corpus kept on the engine's device (the CPU here), written by the
    advance and fetched once, equals the host corpus filled from each
    advance's trace, which an engine keeps when the corpus does not fit on
    its device; each run counts the path it took, once."""
    from repro_torch.core import spans
    from repro_torch.engines import InMemoryWalker, PlainBucketEngine, SOGWEngine
    from repro_torch.engines import base

    jbg, tbg = _graphs()
    jtask, ttask = _tasks(2)
    if engine == "oracle":
        make = lambda: InMemoryWalker(tbg, ttask, device="cpu").run(record_walks=True)
    else:
        cls = {"biblock": TBiBlockEngine, "pb": PlainBucketEngine, "sogw": SOGWEngine}[engine]
        kw = dict(record_walks=True, async_pipeline=False, device="cpu")
        make = lambda: cls(tbg, ttask, **kw).run()
    runs = {}
    spans.take()
    spans.enable()
    try:
        for path in ("device", "host"):
            if path == "host":
                monkeypatch.setattr(base, "corpus_fits", lambda nbytes, device: False)
            res = make()
            got, counts = spans.take()
            names = {s.name for s in got}
            other = "host" if path == "device" else "device"
            assert counts.get(f"corpus.{path}") == 1 and f"corpus.{other}" not in counts
            assert ("corpus.fetch" in names) == (path == "device")
            assert ("advance.record" in names) == (path == "host")
            runs[path] = res
    finally:
        spans.disable()
        spans.take()
    a, b = runs["device"], runs["host"]
    assert isinstance(a.corpus, np.ndarray) and a.corpus.dtype == np.int32
    assert a.corpus.shape == (a.num_walks, ttask.length + 1)
    np.testing.assert_array_equal(a.corpus, b.corpus)
    assert _sig(a) == _sig(b)
    if engine in ("biblock", "oracle"):  # and both are the JAX package's corpus
        want = JBiBlockEngine(jbg, jtask, record_walks=True, async_pipeline=False).run()
        np.testing.assert_array_equal(a.corpus, want.corpus)


#: launcher CSV columns that do not depend on wall clock or thread timing
DETERMINISTIC = (
    "block_ios",
    "vertex_ios",
    "ondemand_ios",
    "ondemand_syscalls",
    "coalesced_ranges",
    "coalesce_waste_bytes",
    "walk_bytes_written",
    "peak_resident_bytes",
    "sim_io_s",
)


def _launch(module, *extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    argv = ["--vertices", "300", "--blocks", "3", "--length", "6", "--p", "3", "--q", "0.5"]
    out = subprocess.run(
        [sys.executable, "-m", module, *argv, "--engine", "biblock", *extra],
        capture_output=True,
        text=True,
        env=env,
        cwd=REPO,
        timeout=300,
        check=True,
    ).stdout.strip().splitlines()
    header, row = out[-2].split(","), out[-1].split(",")
    return {k: row[header.index(k)] for k in DETERMINISTIC}, header


def test_launcher_csv_matches_jax_launcher():
    want, jheader = _launch("repro.launch.walk")
    got, theader = _launch("repro_torch.launch.walk", "--device", "cpu")
    assert theader == jheader
    assert got == want
