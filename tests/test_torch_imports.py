"""The port stands alone and runs on the card unless asked not to.

* Importing every module of ``repro_torch`` (in a fresh interpreter)
  leaves ``jax`` and every ``repro`` module out of ``sys.modules``, and
  builds nothing.
* The port's ``core``, ``engines``, ``kernels``, ``core.engine``, ``serve``,
  ``core.sampling``, ``models``, ``configs``, ``train``, ``optim``,
  ``data``, ``checkpoint``, ``runtime``, ``core.distributed``, ``sharding``
  (and its ``context`` and ``rules``) and ``launch.mesh`` export the
  JAX package's names, but for the documented differences; ``train``,
  ``optim``, ``data``, ``checkpoint``, ``runtime`` and ``core.distributed``
  take the JAX package's parameters (``core.distributed`` adds only the
  port's ``device`` and ``advance_impl`` keywords), the ``sharding``
  modules too, and ``launch.mesh`` but for its added ``device_type``;
  ``models.moe``,
  ``models.mla``, ``models.ssm``, ``models.rglru`` and ``models.encdec``
  too, but for the init functions' generator; ``core``, ``engines``,
  ``kernels`` (and ``kernels.rng``), ``serve``,
  ``models.{common,attention,transformer,registry}`` and ``launch.*``
  (``launch.dryrun`` included) differ from the JAX package's names and
  signatures by exactly a pinned list of edits.
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
        "repro_torch.core.distributed",
        "repro_torch.io.blockfile",
        "repro_torch.models",
        "repro_torch.models.attention",
        "repro_torch.models.moe",
        "repro_torch.models.mla",
        "repro_torch.models.ssm",
        "repro_torch.models.rglru",
        "repro_torch.models.encdec",
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
        "repro_torch.launch.mesh",
        "repro_torch.launch.dryrun",
        "repro_torch.sharding",
        "repro_torch.sharding.context",
        "repro_torch.sharding.rules",
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
    ("core.distributed", set(), set()),
    ("sharding", set(), set()),
    ("sharding.context", set(), set()),
    ("sharding.rules", set(), set()),
    ("launch.mesh", set(), set()),
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


def _model_signatures(pkgs):
    """``_SIGNATURES_PROBE``'s (JAX, port) parameters of each exported name."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _SIGNATURES_PROBE, *pkgs],
        capture_output=True, text=True, env=env, check=True,
    ).stdout  # fmt: skip
    import json

    return json.loads(out.strip().splitlines()[-1])


def _same_but_for_the_generator(res):
    """Each module exports the JAX module's names, and each takes the JAX
    function's parameters (names, kinds, defaults, in order), but for the
    init functions' first: a ``torch.Generator`` ``gen`` where the JAX one
    takes a PRNG ``key``, as ``attn_init``."""
    import importlib

    for pkg in res:
        assert sorted(importlib.import_module("repro_torch." + pkg).__all__) == sorted(res[pkg])
        for name, (jax_params, port_params) in res[pkg].items():
            if name.endswith("_init"):
                assert jax_params[0][0] == "key" and port_params[0][0] == "gen", name
                jax_params, port_params = jax_params[1:], port_params[1:]
            assert port_params == jax_params, f"{pkg}.{name}"


def test_moe_and_mla_signatures_match_jax_but_for_the_generator():
    res = _model_signatures(["models.moe", "models.mla"])
    assert sorted(res["models.moe"]) == ["moe_apply", "moe_init"]
    assert sorted(res["models.mla"]) == ["init_mla_cache", "mla_apply", "mla_decode", "mla_init"]
    _same_but_for_the_generator(res)


def test_recurrent_and_encdec_signatures_match_jax_but_for_the_generator():
    res = _model_signatures(["models.ssm", "models.rglru", "models.encdec"])
    assert sorted(res["models.ssm"]) == ["init_ssd_cache", "ssd_apply", "ssd_decode", "ssd_init"]
    assert sorted(res["models.rglru"]) == [
        "init_rglru_cache", "rglru_apply", "rglru_decode", "rglru_init",
    ]  # fmt: skip
    assert sorted(res["models.encdec"]) == [
        "encdec_decode_step", "encdec_forward", "encdec_init", "encdec_prefill", "encode",
        "init_decoder_caches",
    ]  # fmt: skip
    _same_but_for_the_generator(res)


def test_distributed_signatures_match_jax_but_for_device_and_advance():
    """``DistributedWalkEngine`` takes the JAX engine's parameters (a
    ``DeviceMesh`` where the JAX one takes a ``jax.sharding.Mesh``: the
    same name, kind and default) and adds only the port's ``device`` and
    ``advance_impl`` keywords, last; ``ring_owner_and_round`` is the same."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _SIGNATURES_PROBE, "core.distributed"],
        capture_output=True, text=True, env=env, check=True,
    ).stdout  # fmt: skip
    import json

    res = json.loads(out.strip().splitlines()[-1])["core.distributed"]
    assert sorted(res) == ["DistributedWalkEngine", "ring_owner_and_round"]
    jax_params, port_params = res["ring_owner_and_round"]
    assert port_params == jax_params
    jax_params, port_params = res["DistributedWalkEngine"]
    assert [p[0] for p in jax_params][:3] == ["bg", "task", "mesh"]
    assert port_params == jax_params + [
        ["device", "KEYWORD_ONLY", "'cuda'"], ["advance_impl", "KEYWORD_ONLY", "'cuda'"],
    ]  # fmt: skip


def test_sharding_and_mesh_signatures_match_jax_but_for_the_device_type():
    """``sharding``, ``sharding.context``, ``sharding.rules`` and
    ``launch.mesh`` export the JAX modules' names, each with the JAX
    function's parameters; ``make_production_mesh`` adds only
    ``init_device_mesh``'s ``device_type``, last."""
    import importlib

    res = _model_signatures(["sharding", "sharding.context", "sharding.rules", "launch.mesh"])
    assert sorted(res["sharding"]) == [
        "batch_specs", "cache_specs", "dp_axes", "named", "param_specs",
    ]  # fmt: skip
    assert sorted(res["sharding.context"]) == ["activation_rules", "constrain", "default_rules"]
    for pkg, names in res.items():
        assert sorted(importlib.import_module("repro_torch." + pkg).__all__) == sorted(names)
        for name, (jax_params, port_params) in names.items():
            if name == "make_production_mesh":
                jax_params = jax_params + [["device_type", "KEYWORD_ONLY", "'cuda'"]]
            assert port_params == jax_params, f"{pkg}.{name}"


_ALL_SIGNATURES_PROBE = r"""
import importlib, inspect, json, sys, types

def exported(mod):  # __all__, else the public functions and classes the module defines
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n in dir(mod) if not n.startswith("_") and callable(getattr(mod, n))
            and getattr(getattr(mod, n), "__module__", None) == mod.__name__]

def params(obj):  # (name, kind, default) of each parameter, the port's package named as JAX's
    if isinstance(obj, types.ModuleType):
        return "module"
    if not callable(obj):
        return type(obj).__name__
    try:
        sig = inspect.signature(obj)
    except ValueError:  # a builtin's subclass (an exception type): none to compare
        return "no signature"
    return [[p.name, p.kind.name, repr(p.default).replace("repro_torch.", "repro.")]
            for p in sig.parameters.values()]

out = {}
for pkg in sys.argv[1:]:
    jax_mod = importlib.import_module("repro." + pkg)
    port_mod = importlib.import_module("repro_torch." + pkg)
    jax_names, port_names = exported(jax_mod), exported(port_mod)
    out[pkg] = {"jax_only": sorted(set(jax_names) - set(port_names)),
                "port_only": sorted(set(port_names) - set(jax_names)),
                "params": {n: [params(getattr(jax_mod, n)), params(getattr(port_mod, n))]
                           for n in sorted(set(jax_names) & set(port_names))}}
print(json.dumps(out))
"""

_CUDA = "'cuda'"


def _kw(name, default=_CUDA):
    return [name, "KEYWORD_ONLY", default]


#: every known difference of the remaining packages' signatures, as edits of
#: the JAX parameters: ``drop`` names, ``default`` {name: the port's},
#: ``rename`` {JAX's: the port's}, ``after`` {name: parameters inserted after
#: it}, ``append`` parameters; each package also lists the names only one
#: side exports.  The port's ``device`` (it runs on the card unless asked)
#: and ``advance_impl``, the Pallas knobs it drops (``interpret``,
#: ``walk_tile``, ``advance_interpret``), a ``torch.Generator`` ``gen`` for a
#: PRNG ``key``, the launchers' ``argv``, ``device_type`` for the meshes the
#: dry run builds, and its artifact's keyword, ``save_comms`` for ``save_hlo``;
#: the pair advance's ``corpus``, an engine's walks that it records into
_ENGINE = {"default": {"advance_impl": _CUDA}, "drop": ["advance_interpret"],
           "after": {"advance_impl": [_kw("device")]}}  # fmt: skip
_WALKER = {"append": [_kw("advance_impl"), _kw("device")]}
_RESULT = {"append": [["advance_calls", "POSITIONAL_OR_KEYWORD", "0"]]}
_GEN = {"rename": {"key": "gen"}}
_ARGV = {"append": [["argv", "POSITIONAL_OR_KEYWORD", "None"]]}
_PINNED = {
    "core": ({"advance_pair"}, {"BlockView", "ResidentPair", "pair_advance_ref"},
             {"EngineBase": _ENGINE, "InMemoryWalker": _WALKER, "WalkResult": _RESULT}),
    "engines": ({"advance_pair", "pair_advance_impl"}, {"pair_advance_ref", "resolve_device"},
                {"EngineBase": _ENGINE, "InMemoryWalker": _WALKER, "WalkResult": _RESULT,
                 "ResidentPair": {"append": [["device", "POSITIONAL_OR_KEYWORD", _CUDA]]}}),
    "kernels": ({"WALK_TILE", "pair_advance_kernel"}, set(),
                {"alias_step": {"drop": ["interpret", "walk_tile"]},
                 "node2vec_step": {"drop": ["interpret", "walk_tile"]},
                 "fused_advance_pair": {"drop": ["interpret", "walk_tile"],
                                        "append": [_kw("corpus", "None")]},
                 "bucket_hist_kernel": {"drop": ["interpret"]},
                 "bucket_hist_ref": {"append": [_kw("tile", "1024")]}}),
    "kernels.rng": (set(), {"bits_to_unit"}, {"key_halves": {"rename": {"key": "seed"}}}),
    "serve": (set(), set(), {"WalkQueryServer": {
        "after": {"engine_cls": [_kw("device"), _kw("advance_impl")]}}}),
    "models.common": (set(), set(), {"ModelConfig": {"default": {"dtype": "torch.bfloat16"}},
                                     "dense_init": _GEN, "mlp_init": _GEN}),
    "models.attention": (set(), set(), {"attn_init": _GEN}),
    "models.transformer": (set(), set(), {"init_params": _GEN}),
    "models.registry": (set(), set(), {"model_init": {"append": [_kw("device")]},
                                       "model_caches": {"append": [_kw("device")]}}),
    "launch.walk": (set(), {"csv_row", "parse_args"}, {"main": _ARGV}),
    "launch.serve": (set(), {"parse_args", "skewed_sources"}, {"main": _ARGV}),
    "launch.train": (set(), {"parse_args"}, {"main": {"append": [
        ["argv", "POSITIONAL_OR_KEYWORD", "None"], _kw("on_metrics", "None")]}}),
    "launch.mesh": (set(), set(), {"make_production_mesh": {"append": [_kw("device_type")]}}),
    "launch.dryrun": (set(), {"RESULTS_DIR"}, {
        "main": _ARGV, "run_all": {"append": [_kw("device_type")]},
        "run_cell": {"rename": {"save_hlo": "save_comms"}, "append": [_kw("device_type")]}}),
}  # fmt: skip


def _edited(params, drop=(), default=None, rename=None, after=None, append=()):
    out = []
    for name, kind, dflt in params:
        if name in drop:
            continue
        out.append([(rename or {}).get(name, name), kind, (default or {}).get(name, dflt)])
        out.extend((after or {}).get(name, []))
    return out + list(append)


@pytest.fixture(scope="module")
def all_signatures():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _ALL_SIGNATURES_PROBE, *_PINNED],
        capture_output=True, text=True, env=env, check=True,
    ).stdout  # fmt: skip
    import json

    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("pkg", list(_PINNED))
def test_remaining_signatures_match_jax_but_for_the_pinned_differences(all_signatures, pkg):
    """``core``, ``engines``, ``kernels`` (and ``kernels.rng``), ``serve``,
    ``models.{common,attention,transformer,registry}`` and ``launch.*``: the
    names each side exports, and every shared name's parameters (names,
    kinds, defaults, in order), differ from the JAX package's by exactly the
    pinned list (``launch.dryrun``'s ``RESULTS_DIR`` is a module constant in
    JAX, not exported; the port writes to its own directory)."""
    jax_only, port_only, edits = _PINNED[pkg]
    res = all_signatures[pkg]
    assert set(res["jax_only"]) == jax_only and set(res["port_only"]) == port_only
    assert set(edits) <= set(res["params"]), pkg
    for name, (jax_params, port_params) in res["params"].items():
        if isinstance(jax_params, str):  # a module or a constant: the same kind
            assert port_params == jax_params, f"{pkg}.{name}"
            continue
        assert port_params == _edited(jax_params, **edits.get(name, {})), f"{pkg}.{name}"


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
