"""The port's distributed half-ring engine walks exactly as the JAX one does.

``repro_torch.core.distributed.DistributedWalkEngine`` on ``torch.distributed``
(gloo, one process per rank, ``device="cpu"``) against
``repro.core.distributed.DistributedWalkEngine`` under ``shard_map`` (eight
fake XLA host devices, every scenario in one subprocess) on ``(1, 1)``,
``(1, 2)`` and ``(2, 4)`` meshes: ``prev``/``cur``/``hop``/``alive``,
``sweeps`` and every ``IOStats.as_dict()`` field but the timing ones
(``exec_time``, ``sim_wall_time``, ``writer_queue_peak``), on every rank.
Tolerance: bitwise.  The scenarios cover capacity overflow (several
sweeps), rwnv, prnv, DeepWalk, a weighted graph, disk pools and a mesh
built with its axes in the other order.

Ranks rendezvous through a file under ``tmp_path`` (no fixed port, so
parallel test workers never collide), and every wait is bounded: the
process group's ``timeout`` and each subprocess's.  Each rank asserts that
no ``jax`` or ``repro`` module was loaded.

The JAX references and each world of ranks are module fixtures, built once
per worker that runs a test of this file: under ``-n 6 --dist loadfile``
the whole module runs in one worker, in about 35 s on a CPU host.
"""

import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI legs without it skip

REPO = Path(__file__).resolve().parents[1]
SRC = str(REPO / "src")
#: seconds any one subprocess (the JAX references, a rank) may take
PROC_TIMEOUT = 150
#: ``IOStats.as_dict`` fields read off the wall clock or thread timing
TIMING_FIELDS = ("exec_time", "sim_wall_time", "writer_queue_peak")

_SMALL = dict(graph=[300, 2400, 3], task=["rwnv", dict(p=2.0, q=0.5, walks_per_vertex=1,
                                                       length=6, seed=5)])  # fmt: skip
_MESH = dict(mesh=[2, 4], graph=[800, 6400, 3],
             task=["rwnv", dict(walks_per_vertex=2, length=8, seed=1)])  # fmt: skip
_DISK = dict(pool="disk", pool_flush_walks=0)

#: name -> mesh shape, graph (vertices, edges, seed) in mesh[-1] blocks, task,
#: engine keywords; ``weighted`` adds seeded edge weights, ``axes`` builds the
#: port's mesh with other axis names in that order, ``jax`` names the JAX
#: scenario to compare with (default: the same name)
SCENARIOS = {
    # tests/test_distributed.py's (1, 1) scenarios
    "single": dict(_SMALL, mesh=[1, 1]),
    "single_overflow": dict(_SMALL, mesh=[1, 1], engine=dict(capacity_factor=0.1)),
    "single_disk": dict(_SMALL, mesh=[1, 1],
                        engine=dict(_DISK, capacity_factor=0.1, pool_shards=2)),  # fmt: skip
    "single_prnv": dict(_SMALL, mesh=[1, 1], task=["prnv", dict(query_vertex=7, p=2.0, q=0.5,
                                                               samples_per_vertex=2, seed=4)]),
    # two blocks on two ranks
    "pair_overflow": dict(_SMALL, mesh=[1, 2], engine=dict(capacity_factor=0.1),
                          task=["rwnv", dict(p=2.0, q=0.5, walks_per_vertex=2, length=6, seed=5)]),
    "pair_prnv": dict(_SMALL, mesh=[1, 2], task=["prnv", dict(query_vertex=7, p=2.0, q=0.5,
                                                             samples_per_vertex=2, seed=4)]),
    "pair_deepwalk": dict(_SMALL, mesh=[1, 2], engine=dict(capacity_factor=0.5),
                          task=["deepwalk", dict(walks_per_vertex=1, length=8, seed=3)]),
    "pair_weighted": dict(_SMALL, mesh=[1, 2], weighted=True,
                          engine=dict(advance_impl="torch")),  # fmt: skip
    # tests/test_distributed.py's subprocess configuration: (2, 4), 4 blocks
    "mesh_rwnv": dict(_MESH),
    "mesh_prnv": dict(_MESH, task=["prnv", dict(query_vertex=5, samples_per_vertex=1, seed=2)]),
    "mesh_disk": dict(_MESH, engine=dict(_DISK, capacity_factor=0.5)),
    "mesh_axes_swapped": dict(_MESH, port_mesh=[4, 2], axes=["model", "data"], jax="mesh_rwnv"),
}

_BUILD = r"""
import importlib, json, sys
import numpy as np

def build(pkg, sc):
    core = importlib.import_module(pkg + ".core")
    nv, ne, seed = sc["graph"]
    bg = core.partition_into_n_blocks(core.erdos_renyi(nv, ne, seed=seed), sc["mesh"][-1])
    if sc.get("weighted"):
        g = bg.graph
        w = np.random.default_rng(seed).uniform(0.1, 2.0, g.indices.shape).astype(np.float32)
        bg = core.BlockedGraph(core.CSRGraph(g.indptr, g.indices, w), bg.block_starts,
                               build_alias=True)
    kind, kw = sc["task"]
    if kind == "rwnv":
        task = core.rwnv_task(**kw)
    elif kind == "deepwalk":
        task = core.deepwalk_task(**kw)
    else:
        kw = dict(kw)
        task = core.prnv_task(kw.pop("query_vertex"), nv, **kw)
    return bg, task

def save(path, res, **extra):
    stats = {k: v for k, v in res["stats"].as_dict().items()}
    np.savez(path, prev=res["prev"], cur=res["cur"], hop=res["hop"], alive=res["alive"],
             sweeps=res["sweeps"], stats=json.dumps(stats), extra=json.dumps(extra))
"""

_JAX = _BUILD + r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import jax
from jax.sharding import Mesh
from repro.core.distributed import DistributedWalkEngine

out, scenarios = sys.argv[2], json.loads(sys.argv[3])
for name, sc in scenarios.items():
    bg, task = build("repro", sc)
    shape = sc["mesh"]
    mesh = Mesh(np.array(jax.devices()[: shape[0] * shape[1]]).reshape(shape), ("data", "model"))
    kw = {k: v for k, v in sc.get("engine", {}).items() if k != "advance_impl"}
    pool_dir = os.path.join(out, name + "_pool")
    if kw.get("pool") == "disk":
        kw["pool_dir"] = pool_dir
    res = DistributedWalkEngine(bg, task, mesh, **kw).run()
    save(os.path.join(out, f"jax_{name}.npz"), res, pool_dir_left=os.path.isdir(pool_dir))
print("JAX OK")
"""

_RANK = _BUILD + r"""
import datetime, os
sys.path.insert(0, sys.argv[1])
rank, world, rdzv, out = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
scenarios = json.loads(sys.argv[6])
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.core.distributed import DistributedWalkEngine

torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + rdzv, rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
try:
    for name, sc in scenarios.items():
        bg, task = build("repro_torch", sc)
        mesh = init_device_mesh("cpu", tuple(sc.get("port_mesh", sc["mesh"])),
                                mesh_dim_names=tuple(sc.get("axes", ["data", "model"])))
        kw = dict(sc.get("engine", {}))
        pool_dir = os.path.join(out, name + "_pool")
        if kw.get("pool") == "disk":
            kw["pool_dir"] = pool_dir
        eng = DistributedWalkEngine(bg, task, mesh, device="cpu", **kw)
        res = eng.run()
        dist.barrier()
        save(os.path.join(out, f"port_{name}_r{rank}.npz"), res, rounds=eng.rounds,
             advance_calls=eng.advance_calls, block=eng.block, shard=eng.shard,
             pool_dir_left=os.path.isdir(pool_dir), owns_pool=eng.pool is not None)
finally:
    dist.destroy_process_group()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print("RANK OK", rank)
"""


def _world(sc) -> int:
    return sc["mesh"][0] * sc["mesh"][1]


def _check(procs, what):
    """Wait for every process (bounded); fail with the first failure's
    output.  Kills whatever is still running."""
    try:
        for p in procs:
            p.wait(timeout=PROC_TIMEOUT)
    except subprocess.TimeoutExpired:
        pytest.fail(f"{what}: a process did not finish within {PROC_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p in procs:
        out, err = p.communicate()
        assert p.returncode == 0, f"{what}: exit {p.returncode}\n{out[-2000:]}\n{err[-4000:]}"


def _spawn(args, env):
    return subprocess.Popen([sys.executable, "-c", *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)  # fmt: skip


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """Every scenario through the JAX engine, in one subprocess with eight
    fake host devices."""
    out = tmp_path_factory.mktemp("jax")
    wanted = {n: sc for n, sc in SCENARIOS.items() if "jax" not in sc}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    _check([_spawn([_JAX, SRC, str(out), json.dumps(wanted)], env)], "JAX references")
    return lambda name: dict(np.load(out / f"jax_{name}.npz"))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """The port's ranks, one world per mesh size, started on first use: each
    rank runs every scenario of its world size in turn."""
    cache = {}

    def get(name):
        world = _world(SCENARIOS[name])
        if world not in cache:
            out = tmp_path_factory.mktemp(f"port{world}")
            wanted = {n: sc for n, sc in SCENARIOS.items() if _world(sc) == world}
            env = dict(os.environ, OMP_NUM_THREADS="1")
            procs = [_spawn([_RANK, SRC, str(r), str(world), str(out / "rdzv"), str(out),
                             json.dumps(wanted)], env) for r in range(world)]  # fmt: skip
            _check(procs, f"{world} port ranks")
            cache[world] = out
        out = cache[world]
        return [dict(np.load(out / f"port_{name}_r{r}.npz")) for r in range(world)]

    return get


def _charges(res) -> dict:
    stats = json.loads(str(res["stats"]))
    return {k: v for k, v in stats.items() if k not in TIMING_FIELDS}


def _assert_matches_jax(name, jax_ref, port_runs):
    want = jax_ref(SCENARIOS[name].get("jax", name))
    ranks = port_runs(name)
    for r, got in enumerate(ranks):
        for k in ("prev", "cur", "hop", "alive"):
            assert got[k].dtype == want[k].dtype, (name, r, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} rank {r}: {k}")
        assert int(got["sweeps"]) == int(want["sweeps"]), (name, r)
    # rank 0 owns the pool and carries the walk-I/O charges; the others none
    assert _charges(ranks[0]) == _charges(want), name
    for got in ranks[1:]:
        assert json.loads(str(got["stats"]))["walk_ios"] == 0
    extras = [json.loads(str(got["extra"])) for got in ranks]
    assert [e["owns_pool"] for e in extras] == [True] + [False] * (len(ranks) - 1)
    assert not any(e["pool_dir_left"] for e in extras), f"{name}: spill dir leaked"
    assert not json.loads(str(want["extra"]))["pool_dir_left"]
    return want, ranks, extras


@pytest.mark.parametrize("nb", range(1, 9))
def test_ring_owner_and_round_matches_jax(nb):
    """Every (a, b) for nb blocks, vectorised: the same owners and rounds
    (ties at nb/2 to min(a, b); a == b gives round 0, owner a), as int32."""
    import jax.numpy as jnp

    from repro.core.distributed import ring_owner_and_round as j_ring
    from repro_torch.core.distributed import ring_owner_and_round as t_ring

    a, b = np.meshgrid(np.arange(nb, dtype=np.int32), np.arange(nb, dtype=np.int32))
    jo, jr = j_ring(jnp.asarray(a), jnp.asarray(b), nb)
    to, tr = t_ring(torch.from_numpy(a), torch.from_numpy(b), nb)
    assert to.dtype == tr.dtype == torch.int32
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    # ints give the same 0-d answers
    for i in range(nb):
        for j in range(nb):
            o, r = t_ring(i, j, nb)
            assert o.shape == r.shape == () and o.dtype == torch.int32
            assert (int(o), int(r)) == (int(jo[j, i]), int(jr[j, i]))
    # each unordered pair is resident once per sweep, within nb // 2 rounds
    pairs = {}
    for i in range(nb):
        for j in range(nb):
            if i != j:
                pairs.setdefault((min(i, j), max(i, j)), set()).add((int(to[j, i]), int(tr[j, i])))
    assert all(len(v) == 1 and 1 <= next(iter(v))[1] <= nb // 2 for v in pairs.values())


@pytest.mark.parametrize("name", ["single", "single_overflow", "single_prnv"])
def test_single_rank_matches_jax(name, jax_ref, port_runs):
    """(1, 1) mesh, one block: the walks, sweeps and charges of the JAX
    engine; capacity 0.1 pushes the frontier through several sweeps."""
    want, ranks, extras = _assert_matches_jax(name, jax_ref, port_runs)
    if name == "single_overflow":
        assert int(want["sweeps"]) > int(jax_ref("single")["sweeps"])
    assert extras[0]["rounds"] == int(want["sweeps"])  # one round per sweep at one block


def test_single_rank_disk_pool_matches_jax(jax_ref, port_runs):
    """A disk pool with two writer shards spilling every push moves real
    bytes, charged as the JAX engine charges them, and leaves no spill
    directory; the walks are the memory pool's."""
    want, ranks, _ = _assert_matches_jax("single_disk", jax_ref, port_runs)
    stats = _charges(ranks[0])
    assert stats["walk_bytes_written"] > 0
    assert sum(stats["shard_spill_bytes"].values()) == stats["walk_bytes_written"]
    base = port_runs("single_overflow")[0]
    for k in ("prev", "cur", "hop", "alive"):
        np.testing.assert_array_equal(ranks[0][k], base[k])


@pytest.mark.parametrize("name", ["pair_overflow", "pair_prnv", "pair_deepwalk", "pair_weighted"])
def test_two_ranks_match_jax(name, jax_ref, port_runs):
    """(1, 2) mesh, two blocks (the ring's tie at distance 1), with capacity
    overflow, prnv, first-order DeepWalk and alias proposals on a weighted
    graph; every rank returns the global arrays."""
    want, ranks, extras = _assert_matches_jax(name, jax_ref, port_runs)
    assert [e["block"] for e in extras] == [0, 1]
    if name == "pair_overflow":
        assert int(want["sweeps"]) > 1


@pytest.mark.parametrize("name", ["mesh_rwnv", "mesh_prnv"])
def test_eight_ranks_match_jax(name, jax_ref, port_runs):
    """tests/test_distributed.py's subprocess configuration on a (2, 4)
    mesh: 4 blocks, two rounds a sweep, walks sharded over data x model."""
    want, ranks, extras = _assert_matches_jax(name, jax_ref, port_runs)
    assert not want["alive"].any()
    assert [(e["block"], e["shard"]) for e in extras] == [(r % 4, r) for r in range(8)]
    assert all(e["rounds"] == 2 * int(want["sweeps"]) for e in extras)


def test_eight_ranks_disk_pool_matches_jax(jax_ref, port_runs):
    """A (2, 4) mesh whose frontier crosses sweeps through a disk pool on
    rank 0, with capacity overflow: walks and charges of the JAX engine."""
    _, ranks, _ = _assert_matches_jax("mesh_disk", jax_ref, port_runs)
    assert _charges(ranks[0])["walk_bytes_written"] > 0


def test_mesh_axis_order_does_not_move_walks(jax_ref, port_runs):
    """A (4, 2) mesh named ("model", "data"): walk shards are linearised by
    axis name, so every rank's wids — and the walks — are the (2, 4)
    ("data", "model") JAX run's."""
    _, ranks, extras = _assert_matches_jax("mesh_axes_swapped", jax_ref, port_runs)
    # rank r sits at (model, data) = divmod(r, 2): shard data * 4 + model
    assert [(e["block"], e["shard"]) for e in extras] == [
        (r // 2, (r % 2) * 4 + r // 2) for r in range(8)
    ]


@pytest.fixture
def world1(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))  # fmt: skip
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_constructor_checks(world1):
    """The JAX engine's block-count check, the mesh's axis names, the
    advance's name, and no silent CPU fallback: the default device raises
    on a host without a card."""
    from repro_torch.core import erdos_renyi, partition_into_n_blocks, rwnv_task
    from repro_torch.core.distributed import DistributedWalkEngine

    g = erdos_renyi(60, 240, seed=0)
    task = rwnv_task(walks_per_vertex=1, length=4, seed=0)
    with pytest.raises(ValueError, match="num_blocks"):
        DistributedWalkEngine(partition_into_n_blocks(g, 2), task, world1, device="cpu")
    bg = partition_into_n_blocks(g, 1)
    with pytest.raises(ValueError, match="no axes"):
        DistributedWalkEngine(bg, task, world1, block_axis="blocks", device="cpu")
    with pytest.raises(ValueError, match="advance_impl"):
        DistributedWalkEngine(bg, task, world1, device="cpu", advance_impl="jax")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DistributedWalkEngine(bg, task, world1)
    eng = DistributedWalkEngine(bg, task, world1, device="cpu")
    assert (eng.backend, eng.block, eng.shard, eng.pool is not None) == ("gloo", 0, 0, True)
    res = eng.run()
    assert res["sweeps"] == 1 and not res["alive"].any()
    assert res["stats"].walk_ios == 0  # one sweep: nothing crossed the pool
