"""The port's query server answers, seeds and charges as the JAX server does.

The fixture of ``tests/test_serve.py`` (``barabasi_albert(400, 5, seed=3)``
in 5 blocks), built by ``repro`` and carried over with
``blocked_graph_from_arrays``; a skewed mix of queries under two configs
goes through ``repro.serve.WalkQueryServer`` and the port's
(``device="cpu"``, the plain PyTorch advance) for the hot-set and the
pure-LRU policy, the serial and the async pipeline, and the memory and disk
walk pools: answers (qid, source, walk count, endpoint vertices and
counts), batch counts, batch seeds and every ``IOStats`` charge but the
wall-clock and thread-timing ones must be identical.  Then the port's own
contracts (served batches equal direct runs, pinning changes charges and
never answers), its admission, policy and answer classes against the JAX
ones, its error paths, its launcher against ``repro.launch.serve`` (every
CSV column but the latency percentiles) and its example against
``examples/pagerank_query.py``.  Tolerance: bitwise everywhere.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI legs without it skip

import repro.serve as jserve  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.core import barabasi_albert, partition_into_n_blocks  # noqa: E402
from repro_torch.convert import blocked_graph_from_arrays  # noqa: E402
from repro_torch.core.stats import IOStats  # noqa: E402
from repro_torch.engines import BiBlockEngine  # noqa: E402
from repro_torch.io import BlockStore  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = dict(device="cpu")
#: ``IOStats.as_dict`` fields read off the wall clock or thread timing
TIMING = {"exec_time", "sim_wall_time", "writer_queue_peak"}
CFG_A = dict(p=1.0, q=2.0, length=6, decay=0.85, samples=8)
CFG_B = dict(p=4.0, q=0.25, length=5, decay=0.9, samples=6)


@pytest.fixture(scope="module")
def graphs():
    jbg = partition_into_n_blocks(barabasi_albert(400, 5, seed=3), 5)
    g = jbg.graph
    return jbg, blocked_graph_from_arrays(g.indptr, g.indices, None, jbg.block_starts)


def _skewed_sources(bg, n, frac=0.8, seed=7):
    rng = np.random.default_rng(seed)
    hi = int(bg.block_starts[1])
    return np.where(
        rng.random(n) < frac,
        rng.integers(0, hi, n),
        rng.integers(0, bg.num_vertices, n),
    ).astype(np.int64)


def _serve(pkg, bg, sources, mixed=True, **kw):
    """Submit ``sources`` (every third under the second config when
    ``mixed``) to ``pkg``'s server and flush it."""
    kw.setdefault("async_pipeline", False)
    cfgs = [pkg.QueryConfig(**CFG_A), pkg.QueryConfig(**CFG_B)]
    with pkg.WalkQueryServer(bg, seed=11, **kw) as server:
        for i, s in enumerate(sources):
            server.submit(int(s), cfgs[int(mixed and i % 3 == 2)])
        return server, server.flush()


def _charges(stats):
    return {k: v for k, v in stats.as_dict().items() if k not in TIMING}


def _answer_key(a):
    return (a.qid, a.source, a.num_walks, a.vertices.dtype, a.vertices.tobytes(),
            a.counts.dtype, a.counts.tobytes())  # fmt: skip


# -- the port against the JAX server ------------------------------------------
@pytest.mark.parametrize("hot_blocks", [2, 0])
@pytest.mark.parametrize("pool", ["memory", "disk"])
@pytest.mark.parametrize("async_pipeline", [False, True], ids=["serial", "async"])
def test_server_matches_jax_server(graphs, async_pipeline, pool, hot_blocks):
    jbg, tbg = graphs
    sources = _skewed_sources(jbg, 20)
    kw = dict(max_batch=6, hot_blocks=hot_blocks, pool=pool, async_pipeline=async_pipeline)
    if pool == "disk":
        kw["pool_flush_walks"] = 16  # spill on most pushes
    js, ja = _serve(jserve, jbg, sources, **kw)
    ts, ta = _serve(tserve, tbg, sources, **PORT, **kw)
    assert ts.batches_served == js.batches_served == 4  # 14 + 6 queries, max_batch 6
    assert [ts.batch_seed(k) for k in range(4)] == [js.batch_seed(k) for k in range(4)]
    assert [_answer_key(a) for a in ta] == [_answer_key(a) for a in ja]
    assert _charges(ts.stats) == _charges(js.stats)
    assert (ts.stats.pinned_block_hits > 0) == (hot_blocks > 0)
    assert ts.advance_calls > 0
    assert ts.latency_summary()["answered"] == js.latency_summary()["answered"] == 20


# -- the port's own contracts ------------------------------------------------
def test_served_batches_match_direct_runs(graphs):
    _, bg = graphs
    sources = _skewed_sources(bg, 12)
    server, answers = _serve(tserve, bg, sources, mixed=False, max_batch=8, **PORT)
    assert server.batches_served == 2
    cfg = tserve.QueryConfig(**CFG_A)
    calls = 0
    for k, lo in enumerate((0, 8)):
        batch = answers[lo : lo + 8]
        served = np.zeros(bg.num_vertices, np.int64)
        for a in batch:
            served += a.dense_counts(bg.num_vertices)
        direct = BiBlockEngine(
            bg,
            cfg.task(server.batch_seed(k)),
            initial_walks=np.repeat([a.source for a in batch], cfg.samples),
            async_pipeline=False,
            **PORT,
        ).run()
        assert np.array_equal(served, direct.endpoint_counts)
        calls += direct.advance_calls
    assert server.advance_calls == calls


def test_pinning_never_changes_answers_and_saves_block_loads(graphs):
    _, bg = graphs
    sources = _skewed_sources(bg, 24)
    hot, hot_ans = _serve(tserve, bg, sources, max_batch=8, hot_blocks=2, **PORT)
    lru, lru_ans = _serve(tserve, bg, sources, max_batch=8, hot_blocks=0, **PORT)
    assert [_answer_key(a) for a in hot_ans] == [_answer_key(a) for a in lru_ans]
    assert hot.stats.pinned_block_hits > 0
    assert hot.stats.pinned_bytes_saved > 0
    assert hot.stats.block_ios < lru.stats.block_ios
    assert lru.stats.pinned_block_hits == 0
    for a in hot_ans:
        assert int(a.counts.sum()) == a.num_walks  # every walk retired once
        assert isinstance(a.vertices, np.ndarray) and a.vertices.dtype == np.int64


def test_collect_receives_host_arrays(graphs):
    """``on_retire`` hands numpy arrays over, never device tensors."""
    _, bg = graphs
    seen = []
    cfg = tserve.QueryConfig(**CFG_A)
    BiBlockEngine(
        bg, cfg.task(3), initial_walks=np.arange(0, 400, 7), async_pipeline=False,
        on_retire=lambda wid, ends: seen.append((type(wid), type(ends))), **PORT,
    ).run()  # fmt: skip
    assert seen and set(seen) == {(np.ndarray, np.ndarray)}


# -- the numpy classes against the JAX ones ----------------------------------
def test_query_config_builds_the_jax_task():
    for kw in (CFG_A, CFG_B, {}):
        jc, tc = jserve.QueryConfig(**kw), tserve.QueryConfig(**kw)
        assert dataclasses.astuple(tc) == dataclasses.astuple(jc)
        assert hash(tc) == hash(jc)  # the batching key
        jt, tt = jc.task(5), tc.task(5)
        assert (tt.length, tt.decay, tt.seed) == (jt.length, jt.decay, jt.seed)
        assert dataclasses.astuple(tt.model) == dataclasses.astuple(jt.model)
        assert tt.model.order == jt.model.order
        np.testing.assert_array_equal(tt.initial_walks(50), jt.initial_walks(50))


def test_admission_order_matches_jax():
    r = np.random.default_rng(2)
    cfgs = [dict(q=2.0), dict(q=4.0), dict(p=0.5)]
    picks = r.integers(0, 3, 40)
    for max_batch in (1, 2, 3, 7, 64):
        queues = [pkg.AdmissionQueue(max_batch=max_batch) for pkg in (jserve, tserve)]
        pops = []
        for pkg, queue in zip((jserve, tserve), queues):
            out = []
            for qid, c in enumerate(picks):
                cfg = pkg.QueryConfig(**cfgs[c])
                queue.submit(pkg.WalkQuery(qid, source=qid, config=cfg, t_submit=0.0))
                if qid % 9 == 8:  # pops interleaved with arrivals
                    cfg_popped, batch = queue.pop_batch()
                    out.append((dataclasses.astuple(cfg_popped), [w.qid for w in batch]))
            while (popped := queue.pop_batch()) is not None:
                out.append((dataclasses.astuple(popped[0]), [w.qid for w in popped[1]]))
            assert len(queue) == 0
            pops.append(out)
        assert pops[0] == pops[1]


def test_admission_groups_by_config_oldest_head_first():
    q = tserve.AdmissionQueue(max_batch=2)
    cfg_a, cfg_b = tserve.QueryConfig(q=2.0), tserve.QueryConfig(q=4.0)
    for qid, cfg in enumerate([cfg_b, cfg_a, cfg_b, cfg_a, cfg_b]):
        q.submit(tserve.WalkQuery(qid, source=qid, config=cfg, t_submit=0.0))
    assert [w.qid for w in q.pop_batch()[1]] == [0, 2]
    assert [w.qid for w in q.pop_batch()[1]] == [1, 3]
    assert [w.qid for w in q.pop_batch()[1]] == [4]
    assert q.pop_batch() is None


@pytest.mark.parametrize("max_pinned", [0, 1, 2, 3, 6])
@pytest.mark.parametrize("min_arrivals", [0, 1, 2, 4])
def test_hot_set_policy_matches_jax(max_pinned, min_arrivals):
    r = np.random.default_rng(max_pinned * 10 + min_arrivals)
    policies = [pkg.HotSetPolicy(6, max_pinned=max_pinned, min_arrivals=min_arrivals)
                for pkg in (jserve, tserve)]  # fmt: skip
    assert policies[1].hot_set().tolist() == policies[0].hot_set().tolist()
    for _ in range(12):  # few arrivals per step, so ties are common
        b, n = int(r.integers(0, 6)), int(r.integers(1, 3))
        for pol in policies:
            pol.observe(b, n)
        jh, th = policies[0].hot_set(), policies[1].hot_set()
        assert th.dtype == jh.dtype and th.tolist() == jh.tolist()


def test_hot_set_policy_ties_and_thresholds():
    p = tserve.HotSetPolicy(6, max_pinned=2, min_arrivals=2)
    assert p.hot_set().size == 0
    for b, n in ((4, 3), (1, 3), (2, 1)):
        p.observe(b, n)
    assert p.hot_set().tolist() == [1, 4]  # 1 and 4 tie; 2 is below min_arrivals
    with pytest.raises(ValueError):
        tserve.HotSetPolicy(6, max_pinned=-1)


def test_query_answer_readouts_match_jax():
    r = np.random.default_rng(4)
    verts = np.unique(r.integers(0, 90, 30)).astype(np.int64)
    counts = r.integers(1, 4, verts.size).astype(np.int64)
    counts[:4] = counts.max()  # ties in probability break toward low ids
    args = dict(qid=3, source=9, num_walks=int(counts.sum()), vertices=verts, counts=counts,
                latency=0.5)  # fmt: skip
    ja, ta = jserve.QueryAnswer(**args), tserve.QueryAnswer(**args)
    for x, y in zip(ja.ppr(), ta.ppr()):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for k in (1, 5, 100):
        assert ta.top(k) == ja.top(k)
    assert ta.neighbor_multiset() == ja.neighbor_multiset()
    np.testing.assert_array_equal(ta.dense_counts(90), ja.dense_counts(90))
    empty = tserve.QueryAnswer(0, 0, 0, np.zeros(0, np.int64), np.zeros(0, np.int64), 0.0)
    assert empty.top() == [] and empty.ppr()[1].size == 0


def test_port_serve_exports_match_jax():
    assert sorted(tserve.__all__) == sorted(jserve.__all__)


# -- error paths ---------------------------------------------------------------
def test_bad_max_batch_raises(graphs):
    _, bg = graphs
    with pytest.raises(ValueError):
        tserve.AdmissionQueue(max_batch=0)
    with pytest.raises(ValueError):
        tserve.WalkQueryServer(bg, max_batch=0, **PORT)


def test_submit_rejects_out_of_range_source(graphs):
    _, bg = graphs
    with tserve.WalkQueryServer(bg, **PORT) as server:
        for bad in (bg.num_vertices, -1):
            with pytest.raises(ValueError):
                server.submit(bad)
        assert server.pending() == 0


def test_shared_store_requires_matching_stats(graphs):
    _, bg = graphs
    stats = IOStats()
    store = BlockStore(bg, stats, enable_prefetch=False, capacity=2)
    cfg = tserve.QueryConfig(**CFG_A)
    with pytest.raises(ValueError):
        BiBlockEngine(bg, cfg.task(0), block_store=store, stats=IOStats(), **PORT)
    store.close()


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a CUDA device")


def test_default_device_raises_at_construction_without_gpu(graphs, no_cuda):
    _, bg = graphs
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.WalkQueryServer(bg)
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--vertices", "200", "--blocks", "2", "--queries", "2"])


# -- the launcher and the example ---------------------------------------------
LAUNCH = ["--vertices", "800", "--blocks", "5", "--queries", "40", "--max-batch", "16",
          "--samples", "12", "--length", "8", "--p", "4", "--q", "0.25"]  # fmt: skip
#: the launcher's CSV columns read off the wall clock
LATENCY = {"p50_ms", "p95_ms", "p99_ms"}


def _run(argv, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, *argv], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=timeout, check=True,
    ).stdout  # fmt: skip


def _csv(out):
    lines = out.strip().splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("queries,"))
    cols = lines[start].split(",")
    row = dict(zip(cols, lines[start + 1].split(",")))
    return lines[start], {k: v for k, v in row.items() if k not in LATENCY}


@pytest.mark.parametrize(
    "backend",
    [("--graph-backend", "ram"), ("--graph-backend", "disk", "--io-coalesce-gap", "4096")],
    ids=["ram", "disk"],
)
def test_launcher_csv_matches_jax_launcher(backend):
    jheader, want = _csv(_run(["-m", "repro.launch.serve", *LAUNCH, *backend]))
    theader, got = _csv(_run(["-m", "repro_torch.launch.serve", *LAUNCH, *backend,
                              "--device", "cpu"]))  # fmt: skip
    assert theader == jheader
    assert got == want
    assert int(got["queries"]) == 40 and int(got["batches"]) == 3


def test_launcher_main_returns_answers_and_server(capsys):
    from repro_torch.launch import serve

    answers, server = serve.main(
        ["--vertices", "300", "--blocks", "3", "--queries", "10", "--max-batch", "4",
         "--samples", "4", "--length", "5", "--device", "cpu"]
    )  # fmt: skip
    assert [a.qid for a in answers] == list(range(10))
    assert server.batches_served == 3 and server.advance_calls > 0
    assert server.stats.block_ios > 0
    assert capsys.readouterr().out.startswith(serve.CSV_HEADER)


def _example_lines(out):
    """The example's per-query lines and ledger, latencies taken out."""
    keep = [line for line in out.splitlines() if line.startswith(("  query", "===", "block"))]
    return [re.sub(r"latency=[0-9.]+ ms", "", line) for line in keep]


def test_example_twin_matches_jax_example():
    tiny = ["--vertices", "300", "--blocks", "4", "--samples", "16", "--length", "6"]
    want = _example_lines(_run(["examples/pagerank_query.py", *tiny], timeout=600))
    got = _example_lines(_run(["examples/torch_port/pagerank_query.py", *tiny,
                               "--device", "cpu"], timeout=600))  # fmt: skip
    assert len([line for line in want if "top5=" in line]) == 9
    assert got == want
