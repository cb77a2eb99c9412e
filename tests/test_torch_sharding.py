"""The port's placement rules give the JAX package's specs, leaf for leaf.

``repro_torch.sharding`` against ``repro.sharding`` on the production
meshes' sizes (tests/test_sharding_rules.py's shape-only ``FakeMesh``: 16 x
16 and 2 x 16 x 16): ``param_specs`` in both modes for every arch, on the
port's meta-device parameters and ``jax.eval_shape``'s; ``cache_specs`` on
tests/test_sharding_rules.py's cache cells (the KV cache's sequence dim and
the RG-LRU state stay off ``model``, as JAX's path-string match leaves
them), which also pass that file's divisibility check; ``batch_specs`` for
every applicable shape; ``default_rules``.  Specs compare as
``{JAX path string: tuple(PartitionSpec)}``.  ``named`` and
``make_production_mesh`` run on DeviceMeshes under torch's fake process
group backend (256 and 512 ranks, no devices), each test with its own
group.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI legs without it skip
jax = pytest.importorskip("jax")

from repro.configs import ARCH_IDS, SHAPES, shape_applicable  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402


class FakeMesh:
    """Shape-only stand-in: ``shape`` maps axis names to sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = [FakeMesh({"data": 16, "model": 16}), FakeMesh({"pod": 2, "data": 16, "model": 16})]
MESH_IDS = ["1pod", "2pod"]
#: tests/test_sharding_rules.py's cache cells
CACHE_ARCHS = ["yi-34b", "mamba2-2.7b", "recurrentgemma-2b", "deepseek-v2-236b", "whisper-tiny"]
CACHE_CELLS = [
    (arch, shape)
    for arch in CACHE_ARCHS
    for shape in ("decode_32k", "long_500k")
    if shape_applicable(jax_config(arch), shape)
]


def _jax_flat(tree):
    """``{JAX path string: tuple(spec)}`` of a JAX spec tree."""
    from jax.sharding import PartitionSpec

    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {"/".join(str(k) for k in path): tuple(spec) for path, spec in flat[0]}


def _port_flat(tree):
    """The same of the port's spec tree (its paths in JAX's string form)."""
    from repro_torch.sharding.rules import _map_with_path

    flat = {}
    _map_with_path(lambda path, spec: flat.__setitem__(path, spec), tree)
    return flat


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    from repro.configs import get_config
    from repro.models import init_params_shape

    return init_params_shape(get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params_shape

    return init_params_shape(get_config(arch))


def _port_caches(cfg, batch, max_len):
    """``model_caches`` on the meta device: shapes only."""
    from repro_torch.models import encdec, transformer

    with torch.device("meta"):
        if cfg.is_encoder_decoder:
            return encdec.init_decoder_caches(cfg, batch, max_len, max_len)
        return transformer.init_caches(cfg, batch, max_len)


def _check_divisible(flat_specs, flat_shapes, mesh, where):
    """tests/test_sharding_rules.py's check: every sharded dim divides."""
    assert flat_specs.keys() == flat_shapes.keys()
    for path, spec in flat_specs.items():
        for dim, axes in enumerate(spec):
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else axes
            n = int(np.prod([mesh.shape[a] for a in axes]))
            size = flat_shapes[path][dim]
            assert size % n == 0, f"{where}: {path} dim {dim} size {size} not divisible by {n}"


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, mesh, mode):
    from repro.sharding import param_specs as jax_specs
    from repro_torch.configs import get_config
    from repro_torch.sharding import param_specs

    want = _jax_flat(jax_specs(jax_config(arch), _jax_params(arch), mesh, mode=mode))
    port = _port_params(arch)
    got = _port_flat(param_specs(get_config(arch), port, mesh, mode=mode))
    assert got == want
    shapes = _port_flat(tree_map(lambda t: tuple(t.shape), port))
    _check_divisible(got, shapes, mesh, f"{arch} params")


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch,shape", CACHE_CELLS)
def test_cache_specs_match_jax_and_divide(arch, shape, mesh):
    from repro.models import model_caches as jax_caches
    from repro.sharding import cache_specs as jax_specs
    from repro_torch.configs import get_config
    from repro_torch.sharding import cache_specs

    spec = SHAPES[shape]
    jcfg = jax_config(arch)
    caches = jax.eval_shape(
        lambda: jax_caches(jcfg, spec.global_batch, spec.seq_len, enc_len=spec.seq_len)
    )
    want = _jax_flat(jax_specs(jcfg, caches, mesh, spec.global_batch))
    cfg = get_config(arch)
    port = _port_caches(cfg, spec.global_batch, spec.seq_len)
    got = _port_flat(cache_specs(cfg, port, mesh, spec.global_batch))
    assert got == want
    shapes = _port_flat(tree_map(lambda t: tuple(t.shape), port))
    assert shapes == {p: tuple(s.shape) for p, s in _jax_flat_shapes(caches).items()}
    _check_divisible(got, shapes, mesh, f"{arch} caches {shape}")
    # the JAX rules' string match: k / v / h never reach ``model``
    for path, s in got.items():
        if path.endswith(("['k']", "['v']", "['h']")):
            assert "model" not in s, (path, s)


def _jax_flat_shapes(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k) for k in path): leaf for path, leaf in flat}


def test_kv_and_state_stay_off_model_where_jax_leaves_them():
    """The cells of the issue that motivated the string form, spelled out."""
    from repro_torch.configs import get_config
    from repro_torch.sharding import cache_specs

    mesh = MESHES[0]
    want = {
        ("yi-34b", "[0]/['pos0']/['k']"): (None, "data", None, None, None),
        ("deepseek-v2-236b", "[1]/['pos0']/['ckv']"): (None, "data", "model", None),
        ("recurrentgemma-2b", "[0]/['pos0']/['h']"): (None, "data", None),
    }
    for (arch, path), spec in want.items():
        cfg = get_config(arch)
        got = _port_flat(cache_specs(cfg, _port_caches(cfg, 128, 32768), mesh, 128))
        assert got[path] == spec, (arch, path, got[path])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_match_jax(arch):
    from repro.sharding import batch_specs as jax_specs
    from repro_torch.configs import get_config
    from repro_torch.sharding import batch_specs

    n = 0
    for mesh in MESHES:
        for name, spec in SHAPES.items():
            if not shape_applicable(jax_config(arch), name):
                continue
            want = jax_specs(jax_config(arch), mesh, spec.global_batch, kind=spec.kind)
            got = batch_specs(get_config(arch), mesh, spec.global_batch, kind=spec.kind)
            assert got == {k: tuple(v) for k, v in want.items()}, (arch, name)
            n += 1
    assert n >= 6
    with pytest.raises(ValueError):
        batch_specs(get_config(arch), MESHES[0], 8, kind="eval")


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("batch,seq", [(256, 4096), (32, 32768), (1, 524288), (6, 100), (16, 8)])
def test_default_rules_match_jax(mesh, batch, seq):
    from repro.sharding.context import default_rules as jax_rules
    from repro_torch.sharding.context import default_rules

    want = jax_rules(mesh, batch, seq, 512)
    got = default_rules(mesh, batch, seq, 512)
    assert got.keys() == want.keys()
    assert got.pop("mesh") is mesh and want.pop("mesh") is mesh
    for key in ("residual", "logits"):
        want[key] = tuple(want[key])
    assert got == want


def test_activation_rules_and_get_rule():
    from repro_torch.sharding.context import activation_rules, constrain, get_rule

    x = torch.ones(2, 3)
    assert get_rule("mesh", "none") == "none" and constrain(x, "residual") is x
    with activation_rules({"residual": (None, "model", None), "moe_ep_axis": "model"}):
        assert get_rule("moe_ep_axis") == "model" and get_rule("mesh") is None
        assert constrain(x, "residual") is x  # a plain tensor stays as it is
        with activation_rules(None):
            assert get_rule("moe_ep_axis") is None
        assert get_rule("moe_ep_axis") == "model"
    assert get_rule("moe_ep_axis") is None


@pytest.fixture
def fake_world():
    """``init(n)`` starts torch's fake backend over ``n`` ranks (this rank
    is 0); the group is destroyed after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(n, rank=0):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod", [False, True], ids=MESH_IDS)
def test_make_production_mesh(fake_world, multi_pod):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import dp_axes, param_specs

    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else ((16, 16), ("data", "model"))
    fake_world(int(np.prod(shape)))
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == names
    assert dp_axes(mesh) == names[:-1]
    # the rules read a DeviceMesh's sizes as they read FakeMesh's
    cfg = get_config("deepseek-v2-236b")
    fake = MESHES[int(multi_pod)]
    assert _port_flat(param_specs(cfg, _port_params(cfg.name), mesh)) == _port_flat(
        param_specs(cfg, _port_params(cfg.name), fake)
    )


def test_named_gives_dtensor_placements(fake_world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding import named

    fake_world(512)
    mesh = init_device_mesh("cpu", (2, 16, 16), mesh_dim_names=("pod", "data", "model"))
    tree = {"a": (("pod", "data"), None, "model"), "b": [(None, None), ()], "c": ("model", None)}
    got = named(mesh, tree)
    assert got == {
        "a": [Shard(0), Shard(0), Shard(2)],
        "b": [[Replicate()] * 3, [Replicate()] * 3],
        "c": [Replicate(), Replicate(), Shard(0)],
    }
    with pytest.raises(ValueError):
        named(mesh, {"x": ("expert", None)})


def test_module_imports_touch_no_process_group():
    import torch.distributed as dist

    import repro_torch.launch.mesh  # noqa: F401
    import repro_torch.sharding.context  # noqa: F401

    assert not dist.is_initialized()
