"""The port's bi-block engine walks exactly as the JAX package's does.

Same graph, task and seed through ``repro``'s ``BiBlockEngine``
(``advance_impl="jax"``) and the port's (``device="cpu"``,
``advance_impl="torch"``): endpoint counts, corpus, step counts and every
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
        ("torch", tbg, ttask, TBiBlockEngine, tio, dict(advance_impl="torch", device="cpu")),
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
    b = TBiBlockEngine(
        tbg, ttask, record_walks=True, async_pipeline=False, device="cpu", advance_impl="torch"
    ).run()
    assert _sig(a) == _sig(b)


def test_engine_validates_advance_impl():
    _, tbg = _graphs()
    _, ttask = _tasks(2)
    with pytest.raises(ValueError, match="advance_impl"):
        TBiBlockEngine(tbg, ttask, advance_impl="jax", device="cpu")


def test_cuda_impl_on_cpu_tensors_takes_plain_version():
    """``advance_impl="cuda"`` on CPU tensors runs the wrapper's plain path
    (no launch) and walks the same as ``"torch"``."""
    from repro_torch.kernels.pair_advance import fused_advance_pair

    _, tbg = _graphs()
    _, ttask = _tasks(2)
    before = fused_advance_pair.launches
    kw = dict(record_walks=True, async_pipeline=False, device="cpu")
    a = TBiBlockEngine(tbg, ttask, advance_impl="cuda", **kw).run()
    b = TBiBlockEngine(tbg, ttask, advance_impl="torch", **kw).run()
    assert fused_advance_pair.launches == before
    assert _sig(a) == _sig(b)


@pytest.mark.parametrize("engine", ["biblock", "pb", "sogw"])
def test_device_corpus_matches_host_fallback(monkeypatch, engine):
    """The corpus kept on the engine's device (the CPU here), written by the
    advance and fetched once, equals the host corpus filled from each
    advance's trace, which an engine keeps when the corpus does not fit on
    its device; each run counts the path it took, once."""
    from repro_torch.core import spans
    from repro_torch.engines import PlainBucketEngine, SOGWEngine
    from repro_torch.engines import base

    cls = {"biblock": TBiBlockEngine, "pb": PlainBucketEngine, "sogw": SOGWEngine}[engine]
    jbg, tbg = _graphs()
    jtask, ttask = _tasks(2)
    kw = dict(record_walks=True, async_pipeline=False, device="cpu", advance_impl="torch")
    runs = {}
    spans.take()
    spans.enable()
    try:
        for path in ("device", "host"):
            if path == "host":
                monkeypatch.setattr(base, "corpus_fits", lambda nbytes, device: False)
            res = cls(tbg, ttask, **kw).run()
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
    if engine == "biblock":  # and both are the JAX package's corpus
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
    got, theader = _launch("repro_torch.launch.walk", "--device", "cpu", "--advance", "torch")
    assert theader == jheader
    assert got == want
