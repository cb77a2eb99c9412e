"""The port's baseline engines and in-memory oracle walk exactly as the JAX
package's do.

Same graph, task and seed through ``repro``'s ``InMemoryWalker``,
``PlainBucketEngine`` (PB), ``SOGWEngine`` and ``SOGWEngine(static_cache=True)``
(SGSC) and the port's (``device="cpu"``): endpoint counts, corpus, step
counts and every deterministic ``IOStats`` charge (block, vertex and
on-demand I/Os and bytes, walk bytes written and read, peak resident bytes)
must be identical — for rwnv, prnv and DeepWalk, on a weighted graph (alias
tables), and across {ram, disk} graph x {memory, disk} pool.  Each port
engine is also pinned to the port's oracle, as the JAX package pins its
engines.  Tolerance: bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI legs without it skip

import repro.core as jcore  # noqa: E402
import repro.io as jio  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.io as tio  # noqa: E402
from repro_torch.convert import blocked_graph_from_arrays  # noqa: E402

torch.set_num_threads(1)

NV, NBLOCKS, SEED = 90, 3, 3
ENGINES = ("oracle", "pb", "sogw", "sgsc")


def _graphs(weighted=False):
    g = jcore.erdos_renyi(NV, NV * 5, seed=SEED)
    w = None
    if weighted:
        w = np.random.default_rng(SEED).uniform(0.1, 2.0, g.indices.shape).astype(np.float32)
        g = jcore.CSRGraph(g.indptr, g.indices, w)
    jbg = jcore.partition_into_n_blocks(g, NBLOCKS)
    return jbg, blocked_graph_from_arrays(g.indptr, g.indices, w, jbg.block_starts)


def _task(core, kind):
    if kind == "rwnv":
        return core.rwnv_task(p=3.0, q=0.5, walks_per_vertex=1, length=6, seed=SEED)
    if kind == "prnv":
        return core.prnv_task(5, NV, p=0.5, q=2.0, length=8, samples_per_vertex=1, seed=SEED)
    return core.deepwalk_task(walks_per_vertex=1, length=8, seed=SEED)


def _open(bg, backend, io, path):
    if backend == "ram":
        return bg
    io.write_block_file(bg, path)
    return io.DiskBlockedGraph(path)


def _run(core, io, bg, task, engine, tmp_path, tag, *, backend="ram", pool="memory", **kw):
    if engine == "oracle":
        return core.InMemoryWalker(bg, task, **kw).run(record_walks=True)
    bgx = _open(bg, backend, io, str(tmp_path / f"{tag}.grb"))
    if engine == "pb":
        cls, extra = core.PlainBucketEngine, {}
    else:
        cls, extra = core.SOGWEngine, dict(static_cache=engine == "sgsc")
    try:
        return cls(
            bgx, task, record_walks=True, pool=pool, pool_dir=str(tmp_path / f"pool_{tag}"),
            **extra, **kw,
        ).run()  # fmt: skip
    finally:
        if backend == "disk":
            bgx.close()


def _sig(res):
    s = res.stats
    return (
        res.endpoint_counts.tobytes(),
        res.corpus.tobytes(),
        res.steps_sampled,
        s.steps_sampled,
        s.block_ios,
        s.block_bytes,
        s.vertex_ios,
        s.vertex_bytes,
        s.ondemand_ios,
        s.ondemand_bytes,
        s.ondemand_syscalls,
        s.walk_bytes_written,
        s.walk_bytes_read,
        s.peak_resident_bytes,
    )


def _both(tmp_path, engine, kind, weighted=False, **kw):
    jbg, tbg = _graphs(weighted)
    want = _run(jcore, jio, jbg, _task(jcore, kind), engine, tmp_path, "jax", **kw)
    got = _run(tcore, tio, tbg, _task(tcore, kind), engine, tmp_path, "torch", device="cpu", **kw)
    return want, got, tbg


@pytest.mark.parametrize("kind", ["rwnv", "prnv", "deepwalk"])
@pytest.mark.parametrize("engine", ENGINES)
def test_engine_matches_jax(tmp_path, engine, kind):
    want, got, tbg = _both(tmp_path, engine, kind)
    assert _sig(got) == _sig(want)
    assert got.endpoint_counts.sum() == got.num_walks
    assert got.advance_calls > 0
    if engine != "oracle":  # pinned to the port's own oracle, too
        oracle = tcore.InMemoryWalker(tbg, _task(tcore, kind), device="cpu").run()
        np.testing.assert_array_equal(got.endpoint_counts, oracle.endpoint_counts)
        np.testing.assert_array_equal(got.corpus, oracle.corpus)


@pytest.mark.parametrize("engine", ENGINES)
def test_engine_weighted_matches_jax(tmp_path, engine):
    want, got, _ = _both(tmp_path, engine, "rwnv", weighted=True)
    assert _sig(got) == _sig(want)


@pytest.mark.parametrize(
    "backend,pool", [("ram", "disk"), ("disk", "memory"), ("disk", "disk")]
)
@pytest.mark.parametrize("engine", ["pb", "sogw", "sgsc"])
def test_baseline_storage_matrix_matches_jax(tmp_path, engine, backend, pool):
    want, got, _ = _both(tmp_path, engine, "rwnv", backend=backend, pool=pool)
    assert _sig(got) == _sig(want)


def test_sgsc_cache_charge_and_sogw_vertex_io():
    """SGSC pays its cache up front and fewer vertex I/Os than SOGW; the
    first-order DeepWalk pays none in SOGW (it never touches prev)."""
    _, tbg = _graphs()
    kw = dict(device="cpu")
    sogw = tcore.SOGWEngine(tbg, _task(tcore, "rwnv"), **kw).run()
    sgsc_eng = tcore.SOGWEngine(tbg, _task(tcore, "rwnv"), static_cache=True, **kw)
    cache_ios = sgsc_eng.stats.vertex_ios
    sgsc = sgsc_eng.run()
    assert cache_ios > 0
    assert sogw.stats.vertex_ios > sgsc.stats.vertex_ios - cache_ios
    dw = tcore.SOGWEngine(tbg, _task(tcore, "deepwalk"), **kw).run()
    assert dw.stats.vertex_ios == 0


def test_oracle_rejects_disk_graph_and_bad_impl(tmp_path):
    _, tbg = _graphs()
    task = _task(tcore, "rwnv")
    dbg = _open(tbg, "disk", tio, str(tmp_path / "g.grb"))
    try:
        with pytest.raises(TypeError, match="in-RAM BlockedGraph"):
            tcore.InMemoryWalker(dbg, task, device="cpu")
    finally:
        dbg.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_cuda_impl_on_cpu_tensors_takes_plain_version(tmp_path, engine):
    """An engine on CPU tensors runs the kernel wrapper's plain path (no
    launch) and walks as the JAX engine does."""
    from repro_torch.kernels.pair_advance import fused_advance_pair

    before = fused_advance_pair.launches
    want, got, _ = _both(tmp_path, engine, "rwnv")
    assert fused_advance_pair.launches == before
    assert _sig(got) == _sig(want)


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a CUDA device")
    _, tbg = _graphs()
    task = _task(tcore, "rwnv")
    for make in (
        lambda: tcore.InMemoryWalker(tbg, task),
        lambda: tcore.PlainBucketEngine(tbg, task),
        lambda: tcore.SOGWEngine(tbg, task, static_cache=True),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
