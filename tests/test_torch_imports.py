"""The port stands alone and runs on the card unless asked not to.

* Importing every module of ``repro_torch`` (in a fresh interpreter)
  leaves ``jax`` and every ``repro`` module out of ``sys.modules``, and
  builds nothing.
* The port's ``core``, ``engines``, ``kernels``, ``core.engine``, ``serve``,
  ``core.sampling``, ``models``, ``configs``, ``train``, ``optim``,
  ``data``, ``checkpoint`` and ``runtime`` export the JAX package's names,
  but for the documented differences; the last five take the JAX
  package's parameters.
* An engine built with the default device raises a clear error on a host
  without a CUDA device instead of falling back to the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI legs without it skip

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
mods = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    mods.append(m.name)
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": mods, "leaked": leaked}))
"""


def test_port_imports_neither_jax_nor_repro(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), REPRO_TORCH_BUILD_DIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True, env=env, check=True
    ).stdout
    import json

    res = json.loads(out.strip().splitlines()[-1])
    assert res["leaked"] == []
    for m in (
        "repro_torch.kernels.rng",
        "repro_torch.kernels.pair_advance",
        "repro_torch.kernels.bucket_hist",
        "repro_torch.kernels.node2vec_ref",
        "repro_torch.kernels.ops",
        "repro_torch.engines.step",
        "repro_torch.engines.base",
        "repro_torch.engines.biblock",
        "repro_torch.engines.baselines",
        "repro_torch.engines.inmemory",
        "repro_torch.launch.walk",
        "repro_torch.launch.serve",
        "repro_torch.serve",
        "repro_torch.serve.server",
        "repro_torch.convert",
        "repro_torch.core.sampling",
        "repro_torch.core.engine",
        "repro_torch.io.blockfile",
        "repro_torch.models",
        "repro_torch.models.attention",
        "repro_torch.models.transformer",
        "repro_torch.models.module",
        "repro_torch.configs",
        "repro_torch.configs.llama32_1b",
        "repro_torch.train",
        "repro_torch.train.step",
        "repro_torch.train.loss",
        "repro_torch.optim",
        "repro_torch.optim.adamw",
        "repro_torch.data",
        "repro_torch.data.corpus",
        "repro_torch.checkpoint",
        "repro_torch.checkpoint.ckpt",
        "repro_torch.runtime",
        "repro_torch.runtime.fault",
        "repro_torch.launch.train",
    ):
        assert m in res["modules"]
    assert list(tmp_path.iterdir()) == []  # importing builds no kernel


def test_port_sources_do_not_name_jax_imports():
    src = REPO / "src" / "repro_torch"
    for py in src.rglob("*.py"):
        for line in py.read_text(encoding="utf-8").splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import repro.", "from repro.")), (
                f"{py}: {s}"
            )


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a CUDA device")


def test_default_device_raises_without_gpu(no_cuda):
    from repro_torch.core import erdos_renyi, partition_into_n_blocks, rwnv_task
    from repro_torch.engines import BiBlockEngine

    bg = partition_into_n_blocks(erdos_renyi(40, 160, seed=0), 2)
    task = rwnv_task(walks_per_vertex=1, length=4, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BiBlockEngine(bg, task)
    # the explicit host path still runs
    res = BiBlockEngine(bg, task, device="cpu").run()
    assert res.endpoint_counts.sum() == res.num_walks


def test_kernel_wrapper_rejects_other_devices():
    from repro_torch.kernels.pair_advance import fused_advance_pair

    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_advance_pair(
            *(meta,) * 8,
            meta.float(),
            *(meta,) * 4,
            meta.bool(),
            (0, 0),
            4,
            1.0,
            1.0,
            1.0,
            order=2,
            k_max=1,
            n_iters=4,
            v_iters=4,
            record=False,
            has_alias=False,
            max_len=4,
        )


#: (package, names only the JAX package exports, names only the port exports):
#: the JAX package's jitted pair advance (``advance_pair``,
#: ``pair_advance_impl``) is the port's ``pair_advance_ref``; ``WALK_TILE``
#: and ``pair_advance_kernel`` are Pallas; ``resolve_device``, ``BlockView``
#: and ``ResidentPair`` are exported by the port alone
_EXPORT_DIFFS = [
    ("core", {"advance_pair"}, {"pair_advance_ref", "BlockView", "ResidentPair"}),
    ("engines", {"advance_pair", "pair_advance_impl"}, {"pair_advance_ref", "resolve_device"}),
    ("kernels", {"WALK_TILE", "pair_advance_kernel"}, set()),
    ("core.engine", {"advance_pair", "pair_advance_impl"}, {"pair_advance_ref"}),
    ("serve", set(), set()),
    ("core.sampling", set(), set()),
    ("models", set(), set()),
    ("configs", set(), set()),
    ("train", set(), set()),
    ("optim", set(), set()),
    ("data", set(), set()),
    ("checkpoint", set(), set()),
    ("runtime", set(), set()),
]

_EXPORTS_PROBE = r"""
import importlib, json, sys, types

def exported(mod):  # __all__, or the public names a package without one binds
    if hasattr(mod, "__all__"):
        return mod.__all__
    return [n for n in dir(mod)
            if not n.startswith("_") and not isinstance(getattr(mod, n), types.ModuleType)]

out = {}
for pkg in sys.argv[1:]:
    jax_mod = importlib.import_module("repro." + pkg)
    port_mod = importlib.import_module("repro_torch." + pkg)
    out[pkg] = [sorted(exported(jax_mod)), sorted(exported(port_mod))]
    for name in exported(port_mod):
        getattr(port_mod, name)  # every exported name resolves
print(json.dumps(out))
"""


def test_port_exports_match_jax_but_for_documented_differences():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    pkgs = [p for p, _, _ in _EXPORT_DIFFS]
    out = subprocess.run(
        [sys.executable, "-c", _EXPORTS_PROBE, *pkgs],
        capture_output=True, text=True, env=env, check=True,
    ).stdout  # fmt: skip
    import json

    res = json.loads(out.strip().splitlines()[-1])
    for pkg, jax_only, port_only in _EXPORT_DIFFS:
        jax_names, port_names = map(set, res[pkg])
        assert jax_names - port_names == jax_only, pkg
        assert port_names - jax_names == port_only, pkg


_SIGNATURES_PROBE = r"""
import importlib, inspect, json, sys

def params(obj):  # (name, kind, default) of each parameter; annotations differ by class
    if not callable(obj):  # a constant (data.BOS_OFFSET): its value
        return repr(obj)
    return [[p.name, p.kind.name, repr(p.default)]
            for p in inspect.signature(obj).parameters.values()]

out = {}
for pkg in sys.argv[1:]:
    jax_mod = importlib.import_module("repro." + pkg)
    port_mod = importlib.import_module("repro_torch." + pkg)
    out[pkg] = {name: [params(getattr(jax_mod, name)), params(getattr(port_mod, name))]
                for name in jax_mod.__all__}
print(json.dumps(out))
"""


#: (package, exported names whose signatures differ from the JAX package's):
#: none — ``restore_checkpoint``'s ``shardings`` keeps its name and default,
#: and takes a tree of ``torch.device`` where the JAX one takes
#: ``NamedSharding``s; ``ResilientTrainer.resume`` likewise
_SIGNATURE_DIFFS = {"train": set(), "optim": set(), "data": set(), "checkpoint": set(),
                    "runtime": set()}  # fmt: skip


def test_train_and_optim_signatures_match_jax():
    """Every exported name of ``train``, ``optim``, ``data``, ``checkpoint``
    and ``runtime`` takes the JAX package's parameters: the same names,
    kinds and defaults, in order (no ``device`` keyword or
    ``torch.Generator`` seed is needed there); a constant has the same
    value."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _SIGNATURES_PROBE, *_SIGNATURE_DIFFS],
        capture_output=True, text=True, env=env, check=True,
    ).stdout  # fmt: skip
    import json

    res = json.loads(out.strip().splitlines()[-1])
    assert sorted(res["train"]) == [
        "lm_loss", "make_decode_step", "make_loss_fn", "make_prefill_step", "make_train_step",
    ]  # fmt: skip
    assert sorted(res["runtime"]) == [
        "FailureInjector", "Heartbeat", "ResilientTrainer", "StragglerWatchdog",
    ]  # fmt: skip
    for pkg, names in res.items():
        differ = {name for name, (jax_params, port_params) in names.items()
                  if port_params != jax_params}  # fmt: skip
        assert differ == _SIGNATURE_DIFFS[pkg], pkg


def test_core_reexports_the_storage_layer_and_the_engine_shim():
    import repro_torch.core as core
    import repro_torch.io as io
    from repro_torch.core import engine
    from repro_torch.engines import ResidentPair

    for name in ("BlockFileError", "DiskWalkPool", "MemoryWalkPool", "ShardedWalkPool",
                 "WalkPool", "make_walk_pool"):  # fmt: skip
        assert getattr(core, name) is getattr(io, name)
        assert name in core.__all__ and name in dir(core)
    assert engine._DeviceBlockPair is ResidentPair
    assert engine.BiBlockEngine is core.BiBlockEngine
