"""The port's multi-pod dry run against the JAX package's.

``repro_torch.launch.dryrun`` runs each cell's step on fake DTensors over a
fake 256- or 512-rank mesh.  Held here, on the CPU (``device_type="cpu"``):

* ``input_specs`` gives JAX's shapes and dtypes for every arch x applicable
  shape, but for decode's ``cache_len``, the Python int ``S - 1`` where JAX
  has a scalar int32;
* ``bytes_per_device["arguments"]`` is, byte for byte, the sum over JAX's
  inputs of ``NamedSharding(mesh, spec).shard_shape(shape)`` x itemsize,
  for every arch x applicable shape x {1pod, 2pod} at full width (shapes
  only; ``cache_len`` left out of both);
* every arch x applicable shape runs on the fake (16, 16) mesh with the
  reduced config (``ok``), and llama3.2-1b and deepseek-v2-236b on
  (2, 16, 16); ``all-to-all`` is counted exactly where ``_moe_ep`` runs, and
  every one comes from ``models/moe.py``;
* the counts are rank 0's: on a (1, 4) mesh a matmul split over ``model``
  counts a quarter of the unsplit one's FLOPs and output bytes;
* on four gloo ranks on a (2, 2) mesh, with the JAX package's reduced
  weights carried across (``repro_torch.convert``), the DTensor-placed
  prefill logits and caches and the train step's loss, parameters and
  master equal the port's single-device step within 1e-4 (llama3.2-1b,
  mixtral-8x22b on the expert-parallel path, mamba2-2.7b; deepseek-v2-236b's
  expert-parallel prefill with the sequence split);
* ``run_cell``'s record and artifact, ``run_all``'s skipped and failed
  cells, and ``main``.

The JAX sides, the sweeps of reduced cells and the gloo ranks are
subprocesses started together when the file starts; every wait is bounded.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI legs without it skip
pytest.importorskip("jax")

REPO = Path(__file__).resolve().parents[1]
SRC = str(REPO / "src")
#: seconds any one subprocess may take
PROC_TIMEOUT = 200
#: the gloo ranks' archs; mixtral takes the expert-parallel path on (2, 2)
#: with the sequence whole, deepseek (prefill only: its train loss takes the
#: shards' mean aux, which JAX's pmean takes too) with the sequence split
GLOO_ARCHS = ["llama3.2-1b", "mixtral-8x22b", "mamba2-2.7b", "deepseek-v2-236b"]
PREFILL_ONLY = ["deepseek-v2-236b"]
TOL = 1e-4

_JAX_SIDE = r"""
import json, pickle, sys
import repro.launch.dryrun as jd  # sets XLA_FLAGS to 512 host devices before jax loads
import jax
import numpy as np
from jax.sharding import NamedSharding
from repro.configs import ARCH_IDS, SHAPES, get_config, reduced_config, shape_applicable
from repro.launch.mesh import make_production_mesh
from repro.models import init_params_shape, model_init
from repro.sharding import batch_specs, cache_specs, named, param_specs

def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k) for k in path): leaf for path, leaf in leaves}

def shard_bytes(tree, shardings):
    total = 0
    for leaf, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(shardings)):
        total += int(np.prod(sh.shard_shape(leaf.shape))) * np.dtype(leaf.dtype).itemsize
    return total

if sys.argv[1] == "trees":  # the reduced weights for the gloo ranks
    out = {a: jax.tree.map(np.asarray, model_init(jax.random.PRNGKey(7 + i), reduced_config(a)))
           for i, a in enumerate(sys.argv[3].split(","))}
    pickle.dump(out, open(sys.argv[2], "wb"))
    sys.exit(0)

meshes = {"1pod": make_production_mesh(multi_pod=False),
          "2pod": make_production_mesh(multi_pod=True)}
res = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    params = init_params_shape(cfg)
    for shape, spec in SHAPES.items():
        if not shape_applicable(cfg, shape):
            continue
        ins = jd.input_specs(cfg, shape)
        rec = {"inputs": {k: [list(v.shape), np.dtype(v.dtype).name] for k, v in flat(ins).items()}}
        for name, mesh in meshes.items():
            mode = "train" if spec.kind == "train" else "serve"
            pshard = named(mesh, param_specs(cfg, params, mesh, mode=mode))
            total = shard_bytes(params, pshard)
            if spec.kind == "train":  # the optimiser state: step + float32 master, m, v
                f32 = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, np.float32), params)
                total += 4 + 3 * shard_bytes(f32, pshard)
            bspecs = batch_specs(cfg, mesh, spec.global_batch, kind=spec.kind)
            batch = {k: v for k, v in ins["batch"].items() if k != "cache_len"}
            total += shard_bytes(batch, named(mesh, {k: bspecs[k] for k in batch}))
            if spec.kind == "decode":
                cspecs = cache_specs(cfg, ins["caches"], mesh, spec.global_batch)
                total += shard_bytes(ins["caches"], named(mesh, cspecs))
            rec[name] = total
        res[f"{arch}|{shape}"] = rec
print(json.dumps(res))
"""

_SWEEP = r"""
import dataclasses, json, sys
from pathlib import Path
from repro_torch.configs import reduced_config
from repro_torch.launch import dryrun
from repro_torch.models import moe

calls = [0]
ep = moe._moe_ep
def counted(*args, **kwargs):
    calls[0] += 1
    return ep(*args, **kwargs)
moe._moe_ep = counted
dryrun.RESULTS_DIR = Path(sys.argv[2])
out = []
for arch, shape, multi_pod, over in json.loads(sys.argv[1]):
    dryrun.get_config = lambda a, over=over: dataclasses.replace(reduced_config(a), **over)
    calls[0] = 0
    rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod, device_type="cpu")
    comms = json.loads(Path(rec["comms_path"]).read_text())
    rec.update(over=over, ep_calls=calls[0], a2a_sites=sorted(
        {c["issued_by"].split(":")[0] for c in comms if c["collective"] == "all-to-all"}))
    out.append(rec)
print(json.dumps(out))
"""

_RANK = r"""
import datetime, json, pickle, sys
import numpy as np
import torch, torch.distributed as dist

rank, rdzv, trees, out, archs = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
prefill_only = sys.argv[6].split(",")
dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=4,
                        timeout=datetime.timedelta(seconds=120))
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import reduced_config
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding import batch_specs, named, param_specs
from repro_torch.sharding.context import activation_rules, default_rules
from repro_torch.train import make_prefill_step, make_train_step

mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
def gap(a, b):
    return max(float((full(x) - y).abs().max()) for x, y in zip(tree_leaves(a), tree_leaves(b)))

def place(tree, specs):
    put = lambda t, p: distribute_tensor(t, mesh, p, src_data_rank=None)
    return tree_map(put, tree, named(mesh, specs))

res = {}
for arch in archs.split(","):
    cfg = reduced_config(arch)
    params = lm_params_from_arrays(pickle.load(open(trees, "rb"))[arch], cfg, "cpu")
    rng = np.random.default_rng(3)
    # mixtral: an odd length (the sequence stays whole) and batch rows 2, 3 =
    # rows 0, 1, so every shard routes alike and the expert-parallel aux (a
    # mean over the shards) is the single-device one
    mixtral = arch == "mixtral-8x22b"
    B, S = 4, (15 if mixtral else 16)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labs = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if mixtral:
        toks[2:], labs[2:] = toks[:2], labs[:2]
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)}
    rules = default_rules(mesh, B, S, cfg.d_model)
    prompt = {"tokens": batch["tokens"]}
    ref_logits, ref_caches = make_prefill_step(cfg)(params, prompt)
    with activation_rules(rules), implicit_replication():
        logits, caches = make_prefill_step(cfg)(
            place(params, param_specs(cfg, params, mesh, mode="serve")),
            place(prompt, batch_specs(cfg, mesh, B, kind="prefill")))
    res[arch] = {"logits": gap(logits, ref_logits), "caches": gap(caches, ref_caches)}
    if arch in prefill_only:
        continue
    p1 = tree_map(lambda t: t.clone(), params)
    p1, o1, m1 = make_train_step(cfg, OptConfig())(p1, adamw_init(p1), dict(batch))
    specs = param_specs(cfg, params, mesh, mode="train")
    p2 = tree_map(lambda t: t.clone(), params)
    o2 = adamw_init(p2)
    o2 = AdamWState(distribute_tensor(o2.step, mesh, [Replicate()] * 2, src_data_rank=None),
                    place(o2.master, specs), place(o2.m, specs), place(o2.v, specs))
    with activation_rules(rules), implicit_replication():
        p2, o2, m2 = make_train_step(cfg, OptConfig())(
            place(p2, specs), o2, place(dict(batch), batch_specs(cfg, mesh, B, kind="train")))
    res[arch].update({
        "loss": abs(float(full(m2["loss"])) - float(m1["loss"])),
        "params": gap(p2, p1), "master": gap(o2.master, o1.master),
        "placed": sorted({str(p) for leaf in tree_leaves(p2) for p in leaf.placements}),
    })
if rank == 0:
    json.dump(res, open(out, "w"))
dist.destroy_process_group()
"""

#: rough seconds of a reduced cell on one core (train, prefill; decode and
#: long_500k take about 1), doubled on (2, 16, 16): spreads the sweep over
#: its processes
_COST = {"recurrentgemma-2b": (9, 3), "qwen1.5-0.5b": (3, 7), "llama3.2-1b": (2, 7),
         "phi3-mini-3.8b": (2, 6), "yi-34b": (3, 7), "whisper-tiny": (6, 19),
         "mamba2-2.7b": (9, 14), "mixtral-8x22b": (2, 1), "deepseek-v2-236b": (5, 10),
         "internvl2-1b": (2, 8)}  # fmt: skip
N_SWEEPS = 4


def _cost(cell):
    arch, shape, multi_pod, _ = cell
    kind = {"train_4k": 0, "prefill_32k": 1}.get(shape)
    return (1 if kind is None else _COST[arch][kind]) * (2 if multi_pod else 1)


def _cells():
    from repro_torch.configs import ARCH_IDS, SHAPES, reduced_config, shape_applicable

    cells = [
        [arch, shape, False, {}]
        for arch in ARCH_IDS
        for shape in SHAPES
        if shape_applicable(reduced_config(arch), shape)
    ]
    two_pods = ("llama3.2-1b", "deepseek-v2-236b")
    cells += [[a, s, True, {}] for a, s, _, _ in list(cells) if a in two_pods]
    # the reduced deepseek with 16 experts: E_v divides the 16-way model axis,
    # so moe_apply takes the expert-parallel branch
    cells.append(["deepseek-v2-236b", "decode_32k", False, {"n_experts": 16}])
    return cells


def _env(**extra):
    return dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **extra)


class _Proc:
    """A subprocess whose output goes to files (a full pipe would stall it
    until its test reads it)."""

    def __init__(self, argv, log: Path):
        self.log = log
        with open(log.with_suffix(".out"), "w") as out, open(log.with_suffix(".err"), "w") as err:
            self.p = subprocess.Popen(argv, stdout=out, stderr=err, text=True, env=_env())
        self.out = None

    def result(self):
        if self.out is None:
            self.p.wait(timeout=PROC_TIMEOUT)
            err = self.log.with_suffix(".err").read_text()
            assert self.p.returncode == 0, err[-3000:]
            self.out = self.log.with_suffix(".out").read_text()
        return self.out


class _Gloo:
    """The four gloo ranks, started by a thread once the JAX weights are
    written."""

    def __init__(self, trees_proc, trees, tmp):
        import threading

        tmp.mkdir()
        self.out, self.ranks, self.error = tmp / "gloo.json", [], None

        def start():
            try:
                trees_proc.result()
                for r in range(4):
                    self.ranks.append(_Proc(
                        [sys.executable, "-c", _RANK, str(r), str(tmp / "rdzv"), str(trees),
                         str(self.out), ",".join(GLOO_ARCHS), ",".join(PREFILL_ONLY)],
                        tmp / f"rank{r}"))  # fmt: skip
            except BaseException as e:  # noqa: BLE001 — reported by result()
                self.error = e

        self.thread = threading.Thread(target=start, daemon=True)
        self.thread.start()

    def result(self):
        self.thread.join(PROC_TIMEOUT)
        if self.error is not None:
            raise self.error
        assert len(self.ranks) == 4
        for rank in self.ranks:
            rank.result()
        return json.loads(self.out.read_text())


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """Every subprocess of the file, started together."""
    tmp = tmp_path_factory.mktemp("dryrun")
    trees = tmp / "trees.pkl"
    started = {
        "jax": _Proc([sys.executable, "-c", _JAX_SIDE, "specs"], tmp / "jax"),
        "trees": _Proc([sys.executable, "-c", _JAX_SIDE, "trees", str(trees),
                        ",".join(GLOO_ARCHS)], tmp / "trees"),  # fmt: skip
    }
    groups = [[] for _ in range(N_SWEEPS)]
    load = [0] * N_SWEEPS
    for cell in sorted(_cells(), key=_cost, reverse=True):
        i = load.index(min(load))
        groups[i].append(cell)
        load[i] += _cost(cell)
    for i, group in enumerate(groups):
        group.sort(key=lambda c: c[2])  # one change of world size a process
        out = tmp / f"sweep{i}"
        out.mkdir()
        started[f"sweep{i}"] = _Proc([sys.executable, "-c", _SWEEP, json.dumps(group), str(out)],
                                     tmp / f"sweep{i}_log")  # fmt: skip
    started["tmp"], started["trees_path"] = tmp, trees
    started["gloo"] = _Gloo(started["trees"], trees, tmp / "gloo")
    yield started
    started["gloo"].thread.join(PROC_TIMEOUT)
    for proc in [v for v in started.values() if isinstance(v, _Proc)] + started["gloo"].ranks:
        if proc.p.poll() is None:
            proc.p.kill()
            proc.p.wait()


@pytest.fixture
def fake_world():
    """``init(n)`` starts torch's fake backend over ``n`` ranks (this rank
    is 0); the group is destroyed after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


def _port_flat(tree):
    from repro_torch.sharding.rules import _map_with_path

    flat = {}
    _map_with_path(lambda path, leaf: flat.__setitem__(path, leaf), tree)
    return flat


def test_input_specs_match_jax(procs):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import input_specs

    want = json.loads(procs["jax"].result().strip().splitlines()[-1])
    assert len(want) == 32
    for cell, rec in want.items():
        arch, shape = cell.split("|")
        got = _port_flat(input_specs(get_config(arch), shape))
        jax_inputs = dict(rec["inputs"])
        if SHAPES[shape].kind == "decode":  # the documented difference
            assert jax_inputs.pop("['batch']/['cache_len']") == [[], "int32"]
            assert got.pop("['batch']/['cache_len']") == SHAPES[shape].seq_len - 1
        assert sorted(got) == sorted(jax_inputs), cell
        for path, leaf in got.items():
            assert leaf.device.type == "meta"
            assert [list(leaf.shape), str(leaf.dtype).removeprefix("torch.")] == jax_inputs[path], (
                cell, path)  # fmt: skip


@pytest.mark.parametrize("multi_pod", [False, True], ids=["1pod", "2pod"])
def test_arguments_match_jax_shard_shapes(procs, fake_world, multi_pod):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    want = json.loads(procs["jax"].result().strip().splitlines()[-1])
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    for cell, rec in want.items():
        arch, shape = cell.split("|")
        with FakeTensorMode(), dryrun._dtensor_patches():
            ins = dryrun._placed_inputs(get_config(arch), SHAPES[shape], mesh, "cpu")
            got = dryrun._local_bytes(ins)
        assert got == rec["2pod" if multi_pod else "1pod"], cell


@pytest.mark.parametrize("product", ["dtensor", "linear"])
def test_counts_are_per_device(fake_world, product):
    """A (1, 4) mesh: x [8, 64, 256] whole, w [256, 512] split over its
    columns on ``model`` or whole; rank 0 counts a quarter of the FLOPs and
    of the output bytes (DTensor's own product and the port's ``linear``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import dryrun
    from repro_torch.models.common import linear
    from repro_torch.sharding.context import from_shards

    fake_world(4)
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    counted = {}
    for split in (False, True):
        tally = dryrun._Tally(mesh)
        with FakeTensorMode(), dryrun._dtensor_patches(tally), implicit_replication():
            whole = [Replicate(), Replicate()]
            x = from_shards(torch.empty(8, 64, 256), mesh, whole, (8, 64, 256))
            wp = [Replicate(), Shard(1)] if split else whole
            w = from_shards(torch.empty(256, 128 if split else 512), mesh, wp, (256, 512))
            for t in (x, w):  # the inputs, live before the step as in _estimate
                tally.track(t.to_local())
            before = tally.live
            with tally.mode:
                out = x @ w if product == "dtensor" else linear(x, w)
            assert out.shape == (8, 64, 512)
            counted[split] = (tally.flops, tally.live - before, out.to_local().numel())
    assert counted[False][0] == 2 * 8 * 64 * 256 * 512
    assert counted[True][0] * 4 == counted[False][0]
    assert counted[True][1] * 4 == counted[False][1]  # the bytes the product left live
    assert counted[False][1] == 8 * 64 * 512 * 4
    assert counted[True][2] * 4 == counted[False][2]


def test_vlm_prefix_leaves_before_the_head(fake_world, monkeypatch):
    """The reduced internvl2-1b's train step at train_4k's shape on the fake
    (16, 16) mesh, the residual split over the sequence on ``model``: no
    all-gather's output is logits over the whole sequence (last dim the
    padded vocabulary, at least the S - P token rows).  Slicing the prefix
    off the logits made DTensor gather them over the sequence."""
    from repro_torch.configs import SHAPES, reduced_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    cfg, spec = reduced_config("internvl2-1b"), SHAPES["train_4k"]
    gathered = []
    collective = dryrun._Tally._collective

    def recorded(self, name, op, args, kwargs, out):
        if name == "all-gather":
            gathered.extend(tuple(t.shape) for t in dryrun._tensors(out))
        return collective(self, name, op, args, kwargs, out)

    monkeypatch.setattr(dryrun._Tally, "_collective", recorded)
    fake_world(256)
    mesh = make_production_mesh(device_type="cpu")
    rec = dryrun._estimate(cfg, spec, mesh, device_type="cpu")
    assert rec["collectives"]["all-gather"] == len(gathered) > 0
    rows = spec.seq_len - cfg.num_prefix
    whole = [s for s in gathered if s[-1] == cfg.vocab_padded and math.prod(s) // s[-1] >= rows]
    assert whole == []


def test_run_cell_record_artifact_run_all_and_main(fake_world, monkeypatch, tmp_path, capsys):
    from repro_torch.configs import SHAPES, reduced_config
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path / "results")
    monkeypatch.setattr(dryrun, "get_config", reduced_config)
    rec = dryrun.run_cell("llama3.2-1b", "decode_32k", device_type="cpu")
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["devices"] == 256
    cfg = reduced_config("llama3.2-1b")
    assert (rec["params"], rec["params_active"]) == (cfg.param_count(), cfg.active_param_count())
    comms = json.loads(Path(rec["comms_path"]).read_text())
    assert Path(rec["comms_path"]).name == "llama3.2-1b_decode_32k_16x16.comms.json"
    assert sum(rec["collectives"].values()) == len(comms) > 0
    for c in comms:
        assert set(c) == {"collective", "op", "mesh_dim", "bytes", "issued_by"}
        assert c["mesh_dim"] in ("data", "model") and c["issued_by"].startswith("repro_torch/")

    # without donation the step works on copies: nothing aliases, and the
    # copies count in temp
    kept = dryrun.run_cell("llama3.2-1b", "decode_32k", donate=False, save_comms=False,
                           device_type="cpu")  # fmt: skip
    assert kept["bytes_per_device"]["alias"] == 0 and "comms_path" not in kept
    assert kept["bytes_per_device"]["temp"] >= (
        rec["bytes_per_device"]["temp"] + rec["bytes_per_device"]["alias"])  # fmt: skip

    # run_all: an inapplicable cell is skipped, a failing one recorded, the run goes on
    real = dryrun.run_cell

    def run_cell(arch, shape, **kw):
        if arch == "whisper-tiny":
            raise RuntimeError("boom")
        return real(arch, shape, **kw)

    monkeypatch.setattr(dryrun, "run_cell", run_cell)
    monkeypatch.setattr(dryrun, "ARCH_IDS", ["llama3.2-1b", "whisper-tiny"])
    monkeypatch.setattr(dryrun, "SHAPES", {k: SHAPES[k] for k in ("decode_32k", "long_500k")})
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--all", "--device-type", "cpu"])
    assert exit_.value.code == 1
    assert "cells ok=2 skipped=2 failed=2" in capsys.readouterr().out
    summary = json.loads((tmp_path / "results" / "summary.json").read_text())
    assert summary["llama3.2-1b|long_500k|1pod"]["skipped"] is True
    assert summary["whisper-tiny|decode_32k|2pod"]["error"] == "RuntimeError: boom"
    assert "Traceback" in summary["whisper-tiny|decode_32k|1pod"]["trace"]
    assert summary["llama3.2-1b|decode_32k|2pod"]["mesh"] == "2x16x16"

    # main: one cell, its record as JSON
    monkeypatch.setattr(dryrun, "run_cell", real)
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--device-type", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["ok"] is True and printed["kind"] == "decode"


def test_placed_steps_match_one_device(procs):
    res = procs["gloo"].result()
    assert sorted(res) == sorted(GLOO_ARCHS)
    for arch, gaps in res.items():
        steps = ("logits", "caches") if arch in PREFILL_ONLY else (
            "logits", "caches", "loss", "params", "master")  # fmt: skip
        for what in steps:
            assert gaps[what] <= TOL, (arch, what, gaps)
        if arch not in PREFILL_ONLY:  # the parameters stay split
            assert any(p.startswith("S(") for p in gaps["placed"]), arch


def _sweep(procs):
    last = lambda i: procs[f"sweep{i}"].result().strip().splitlines()[-1]
    return [r for i in range(N_SWEEPS) for r in json.loads(last(i))]


def test_every_reduced_cell_runs(procs):
    recs = _sweep(procs)
    assert len(recs) == len(_cells())
    keys = {"arch", "shape", "mesh", "devices", "kind", "ok", "params", "params_active",
            "bytes_per_device", "cost_analysis", "collectives", "collective_bytes",
            "trace_s"}  # fmt: skip
    names = ["all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute"]
    for r in recs:
        cell = (r["arch"], r["shape"], r["mesh"], r["over"])
        assert r["ok"] is True and keys <= set(r), cell
        assert r["mesh"] == ("2x16x16" if r["devices"] == 512 else "16x16"), cell
        assert list(r["collectives"])[:5] == names, cell
        b = r["bytes_per_device"]
        assert b["arguments"] > 0 and b["temp"] >= 0 and b["outputs"] > 0, cell
        assert r["cost_analysis"]["flops"] > 0 and r["cost_analysis"]["bytes_accessed"] is None
        if r["kind"] == "train":
            assert r["microbatches"] >= 1 and b["alias"] > 0, cell
        elif r["kind"] == "decode":
            assert b["alias"] > 0, cell  # the caches, written in place
        else:
            assert b["alias"] == 0, cell
        # all-to-all exactly where the expert-parallel dispatch ran
        if r["ep_calls"]:
            assert r["collectives"]["all-to-all"] >= 2 * r["ep_calls"], cell
            assert r["a2a_sites"] == ["repro_torch/models/moe.py"], cell
        else:
            assert r["collectives"]["all-to-all"] == 0, cell
    assert [(r["arch"], r["kind"]) for r in recs if r["ep_calls"]] == [
        ("deepseek-v2-236b", "decode")]  # fmt: skip
    assert {r["mesh"] for r in recs if r["arch"] in ("llama3.2-1b", "deepseek-v2-236b")} == {
        "16x16", "2x16x16"}  # fmt: skip


def test_module_imports_touch_no_process_group():
    import torch.distributed as dist

    import repro_torch.launch.dryrun  # noqa: F401

    assert not dist.is_initialized()
