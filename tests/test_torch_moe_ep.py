"""The port's expert-parallel MoE dispatch computes what the JAX one does.

``repro_torch.models.moe.moe_apply`` under published expert-parallel rules
(``_moe_ep``: one ``all_to_all_single`` each way over the ``model`` axis of
a ``DeviceMesh``) on eight gloo ranks, one process each, on a ``(2, 4)``
``(data, model)`` mesh, against ``repro.models.moe.moe_apply`` under
``shard_map`` on eight fake XLA host devices (one subprocess), for
tests/test_moe_ep.py's cases: the reduced deepseek (2 experts a rank), the
reduced mixtral (as many experts as ranks) and a virtual split (2 experts
x split 2).  Both sides take the same numpy weights and input
(``default_rng``, with a direction every token shares, so the routing
is skewed); each rank calls ``moe_apply`` with the whole [4, 16, D] input
and gets the whole output back.

* capacity 8.0: the output within tests/test_moe_ep.py's 5e-4 of the
  port's ``_moe_dense``, and within 1e-4 of JAX's expert-parallel output;
* capacity 1.25, where assignments drop and only the EP capacity rule
  (``max(int(A/E_v * cf) + 1, 4)`` per shard; for deepseek's 8 tokens a
  shard the floor of 4 binds) keeps JAX's: within 1e-4 of JAX's output,
  with the same count of kept assignments;
* at both: ``aux`` (the mean over the mesh) within 1e-6 of JAX's, the
  gradient of ``out.sum()`` for each rank's expert rows within 1e-4 of
  JAX's matching rows, and every other gradient finite and non-zero.

In process: a virtual expert count that the axis does not divide takes the
capacity path, and on a ``(1, 1)`` gloo mesh the expert-parallel path is
bitwise ``_moe_dense`` (through ``moe_apply``, and through
``model_prefill`` and 3 decode steps) where the two capacities agree.

The JAX subprocess and the eight ranks run at the same time; every wait is
bounded (the process group's timeout and each subprocess's), and the
ranks rendezvous through a file under ``tmp_path``.
"""

import dataclasses
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
MESH, WORLD, X_SHAPE = (2, 4), 8, (4, 16)
#: tests/test_moe_ep.py's cases: (arch, config overrides)
CASES = [
    ("deepseek-v2-236b", {}),  # 8 experts, 2 a rank
    ("mixtral-8x22b", {}),  # 4 experts on 4 ranks
    ("mixtral-8x22b", {"n_experts": 2, "moe_virtual_split": 2}),  # split
]
CASE_IDS = ["deepseek", "mixtral", "split"]
CFS = (8.0, 1.25)
#: tests/test_moe_ep.py's bound against the dense path; the bounds against JAX
DENSE_TOL, JAX_TOL, AUX_TOL = 5e-4, 1e-4, 1e-6

_MAKE = r"""
import json, sys
import numpy as np

CASES = json.loads(sys.argv[2])
CFS = json.loads(sys.argv[3])
X_SHAPE = tuple(json.loads(sys.argv[4]))

def make(i, cfg):
    # the JAX moe_init's shapes and scales, drawn with numpy
    rng = np.random.default_rng(100 + i)
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    split = cfg.moe_virtual_split
    ev, fv = e * split, f // split
    w = lambda *shape: (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
    p = {"router": w(d, e), "experts": {"w_in": w(ev, d, 2 * fv), "w_out": w(ev, fv, d)}}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"w_in": w(d, 2 * fs), "w_out": w(fs, d)}
    # a direction every token shares skews the routing, so experts overflow
    x = (rng.standard_normal((*X_SHAPE, d)) + rng.standard_normal(d)).astype(np.float32)
    return p, x
"""

_JAX = _MAKE + r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp
from repro.configs import reduced_config
from repro.models.common import ModelConfig
from repro.models.moe import _route, moe_apply
from repro.sharding.context import activation_rules

out = sys.argv[5]
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
rules = {"moe_ep_axis": "model", "moe_dp_axes": ("data",), "mesh": mesh}
for i, (arch, over) in enumerate(CASES):
    for cf in CFS:
        cfg = ModelConfig(**{**reduced_config(arch).__dict__, "capacity_factor": cf, **over})
        p, x = make(i, cfg)
        p, x = jax.tree.map(jnp.asarray, p), jnp.asarray(x)

        def loss(p):
            o, aux = moe_apply(p, x, cfg)
            return o.sum(), (o, aux)

        with jax.set_mesh(mesh), activation_rules(rules):
            (_, (o, aux)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(p)
        # the assignments each shard keeps under the EP capacity
        ev = cfg.n_experts * cfg.moe_virtual_split
        bl, sl = X_SHAPE[0] // 2, X_SHAPE[1] // 4
        kept = 0
        for b in range(2):
            for s in range(4):
                xt = x[b * bl:(b + 1) * bl, s * sl:(s + 1) * sl].reshape(-1, cfg.d_model)
                idx = np.asarray(_route(p, xt, cfg)[0]).reshape(-1)
                cap = max(int(idx.size / ev * cf) + 1, 4)
                kept += int(np.minimum(np.bincount(idx, minlength=ev), cap).sum())
        np.savez(os.path.join(out, f"jax_{i}_{cf}.npz"), out=np.asarray(o), aux=np.asarray(aux),
                 w_in=np.asarray(g["experts"]["w_in"]), w_out=np.asarray(g["experts"]["w_out"]),
                 kept=kept)
print("JAX OK")
"""

_RANK = _MAKE + r"""
import dataclasses, datetime, os
sys.path.insert(0, sys.argv[1])
rank, rdzv, out = int(sys.argv[5]), sys.argv[6], sys.argv[7]
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import reduced_config
from repro_torch.models import moe
from repro_torch.sharding.context import activation_rules

torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + rdzv, rank=rank, world_size=8,
                        timeout=datetime.timedelta(seconds=60))
try:
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    r = mesh.get_local_rank("model")
    rules = {"moe_ep_axis": "model", "moe_dp_axes": ("data",), "mesh": mesh}
    kept = []
    dispatch = moe._dispatch

    def counted(idx, T, E, cap):
        got = dispatch(idx, T, E, cap)
        kept.append(int(got[2].sum()))
        return got

    moe._dispatch = counted
    for i, (arch, over) in enumerate(CASES):
        for cf in CFS:
            cfg = dataclasses.replace(reduced_config(arch), capacity_factor=cf, **over)
            p, x = make(i, cfg)
            ev = cfg.n_experts * cfg.moe_virtual_split
            epr = ev // 4
            p = {k: ({kk: torch.tensor(vv) for kk, vv in v.items()} if isinstance(v, dict)
                     else torch.tensor(v)) for k, v in p.items()}
            if i == 1:  # this rank holds only its experts' rows
                p["experts"] = {k: w[r * epr:(r + 1) * epr].clone()
                                for k, w in p["experts"].items()}
            for t in (p["router"], *p["experts"].values(), *p.get("shared", {}).values()):
                t.requires_grad_()
            x = torch.tensor(x, requires_grad=True)
            kept.clear()
            with activation_rules(rules):
                o, aux = moe.moe_apply(p, x, cfg)
            o.sum().backward()
            rows = lambda t: (t if i == 1 else t[r * epr:(r + 1) * epr]).detach().numpy()
            others = [x.grad, p["router"].grad, *(t.grad for t in p.get("shared", {}).values())]
            res = dict(out=o.detach().numpy(), aux=aux.detach().numpy(), kept=sum(kept),
                       ep_calls=len(kept), w_in=rows(p["experts"]["w_in"].grad),
                       w_out=rows(p["experts"]["w_out"].grad),
                       others_finite=all(bool(torch.isfinite(t).all()) for t in others),
                       others_nonzero=all(bool(t.abs().sum() > 0) for t in others))
            if rank == 0:  # the capacity path on the whole stacks
                full = make(i, cfg)[0]
                full = {k: ({kk: torch.tensor(vv) for kk, vv in v.items()} if isinstance(v, dict)
                            else torch.tensor(v)) for k, v in full.items()}
                with torch.no_grad():
                    res["dense"] = moe._moe_dense(full, x, cfg)[0].numpy()
            np.savez(os.path.join(out, f"port_{i}_{cf}_r{rank}.npz"), **res)
finally:
    dist.destroy_process_group()
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print("RANK OK", rank)
"""


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's references and the port's eight ranks, started together."""
    out = tmp_path_factory.mktemp("moe_ep")
    common = [SRC, json.dumps(CASES), json.dumps(CFS), json.dumps(X_SHAPE)]

    def spawn(code, *args, **env):
        return subprocess.Popen([sys.executable, "-c", code, *common, *args],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=dict(os.environ, **env))  # fmt: skip

    jax_proc = spawn(_JAX, str(out), JAX_PLATFORMS="cpu")
    ranks = [spawn(_RANK, str(r), str(out / "rdzv"), str(out), OMP_NUM_THREADS="1")
             for r in range(WORLD)]  # fmt: skip
    _check(ranks, "port ranks")
    _check([jax_proc], "JAX references")

    def get(i, cf):
        want = dict(np.load(out / f"jax_{i}_{cf}.npz"))
        got = [dict(np.load(out / f"port_{i}_{cf}_r{r}.npz")) for r in range(WORLD)]
        return want, got

    return get


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("i", range(len(CASES)), ids=CASE_IDS)
def test_ep_output_and_aux_match_jax(runs, i, cf):
    """Every rank returns JAX's whole output and aux; the ranks keep, in
    all, the assignments JAX's shards keep (at 1.25 some drop)."""
    want, ranks = runs(i, cf)
    for r, got in enumerate(ranks):
        assert got["out"].shape == want["out"].shape
        _close(got["out"], want["out"], JAX_TOL, f"case {i} cf {cf} rank {r}: out")
        _close(got["aux"], want["aux"], AUX_TOL, f"case {i} cf {cf} rank {r}: aux")
        assert int(got["ep_calls"]) == 1, "moe_apply took the capacity path"
    kept = sum(int(got["kept"]) for got in ranks)
    assert kept == int(want["kept"]), (kept, int(want["kept"]))
    if cf == 8.0:  # nothing drops
        assert kept == X_SHAPE[0] * X_SHAPE[1] * 2 * CASES[i][1].get("moe_virtual_split", 1)


def test_some_assignments_drop_at_capacity_1_25(runs):
    """At 1.25 the EP capacity drops assignments (so the count above holds
    the port to JAX's capacity rule, not only to its sort)."""
    dropped = 0
    for i, (_, over) in enumerate(CASES):
        want, _ = runs(i, 1.25)
        dropped += X_SHAPE[0] * X_SHAPE[1] * 2 * over.get("moe_virtual_split", 1) - int(want["kept"])
    assert dropped > 0


@pytest.mark.parametrize("i", range(len(CASES)), ids=CASE_IDS)
def test_ep_matches_dense_without_drops(runs, i):
    """At capacity 8.0 nothing drops: the port's EP output within
    tests/test_moe_ep.py's 5e-4 of the port's ``_moe_dense`` (on the whole
    stacks; in the mixtral case each rank holds only its experts' rows)."""
    _, ranks = runs(i, 8.0)
    _close(ranks[0]["out"], ranks[0]["dense"], DENSE_TOL, f"case {i}: EP vs dense")


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("i", range(len(CASES)), ids=CASE_IDS)
def test_ep_gradients_match_jax(runs, i, cf):
    """The gradient of ``out.sum()`` for each rank's expert rows is JAX's
    for those rows (summed over the ``data`` ranks, as JAX's is); x's, the
    router's and the shared experts' are finite and non-zero."""
    want, ranks = runs(i, cf)
    ev = want["w_in"].shape[0]
    epr = ev // MESH[1]
    for rank, got in enumerate(ranks):
        r = rank % MESH[1]
        for k in ("w_in", "w_out"):
            assert np.abs(got[k]).sum() > 0
            _close(got[k], want[k][r * epr:(r + 1) * epr], JAX_TOL,
                   f"case {i} cf {cf} rank {rank}: d {k}")  # fmt: skip
        assert bool(got["others_finite"]) and bool(got["others_nonzero"])


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------


@pytest.fixture
def world1(tmp_path):
    """A one-rank gloo group and its ``(1, 1)`` mesh, for this test only."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))  # fmt: skip
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _rules(mesh):
    return {"moe_ep_axis": "model", "moe_dp_axes": ("data",), "mesh": mesh}


def _caps(cfg, tokens):
    """(dense capacity, EP capacity) for ``tokens`` tokens on one rank."""
    ev, kv = cfg.n_experts * cfg.moe_virtual_split, cfg.top_k * cfg.moe_virtual_split
    dense = int((tokens * kv / ev) * cfg.capacity_factor) + 1
    return dense, max(int(tokens * kv / ev * cfg.capacity_factor) + 1, 4)


def test_gate_takes_the_capacity_path(tmp_path, monkeypatch):
    """6 experts on a 4-wide ``model`` axis (torch's fake backend, 8 ranks):
    ``moe_apply`` runs ``_moe_dense``, bitwise, and never ``_moe_ep``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import reduced_config
    from repro_torch.models import moe
    from repro_torch.sharding.context import activation_rules

    cfg = dataclasses.replace(reduced_config("mixtral-8x22b"), n_experts=6)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(4, 8, cfg.d_model, generator=torch.Generator().manual_seed(1))
    monkeypatch.setattr(moe, "_moe_ep", lambda *a, **k: pytest.fail("took the EP path"))
    dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=8)
    try:
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
        with activation_rules(_rules(mesh)):
            out, aux = moe.moe_apply(p, x, cfg)
    finally:
        dist.destroy_process_group()
    want, want_aux = moe._moe_dense(p, x, cfg)
    assert torch.equal(out, want) and torch.equal(aux, want_aux)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "mixtral-8x22b"])
def test_world1_moe_apply_is_dense_bitwise(world1, arch):
    """On a ``(1, 1)`` mesh at capacity 1.25 (assignments drop) the EP
    capacity is the dense one, the bins have the dense shapes, and
    ``moe_apply`` returns ``_moe_dense``'s output and aux bitwise."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import moe
    from repro_torch.sharding.context import activation_rules

    cfg = dataclasses.replace(reduced_config(arch), capacity_factor=1.25)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    # a direction every token shares skews the routing, so experts overflow
    x = torch.randn(12, 16, cfg.d_model, generator=gen) + torch.randn(cfg.d_model, generator=gen)
    dense_cap, ep_cap = _caps(cfg, 12 * 16)
    assert dense_cap == ep_cap
    want, want_aux = moe._moe_dense(p, x, cfg)
    assert moe._route(p, x.reshape(-1, cfg.d_model), cfg)[0].reshape(-1).bincount().max() > dense_cap
    calls = []
    ep = moe._moe_ep
    try:
        moe._moe_ep = lambda *a: calls.append(1) or ep(*a)
        with activation_rules(_rules(world1)):
            out, aux = moe.moe_apply(p, x, cfg)
    finally:
        moe._moe_ep = ep
    assert calls == [1]
    assert torch.equal(out, want) and torch.equal(aux, want_aux)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "mixtral-8x22b"])
def test_world1_prefill_and_decode_are_dense_bitwise(world1, arch):
    """The reduced model at capacity 1.25 on a ``(1, 1)`` mesh: prefill's
    logits and every cache leaf, then 3 chained greedy decode steps, bitwise
    the capacity path's (12 sequences, so a decode step's dense capacity is
    the EP floor of 4)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import model_caches, model_decode, model_init, model_prefill
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.sharding.context import activation_rules

    cfg = dataclasses.replace(reduced_config(arch), capacity_factor=1.25)
    assert _caps(cfg, 12)[0] == _caps(cfg, 12)[1]
    params = model_init(0, cfg, device="cpu")
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (12, 16)).astype(np.int32)

    def pad(got, tgt):  # a prefill cache copied into the decode buffer
        tgt[tuple(slice(0, n) for n in got.shape)] = got
        return tgt

    def run():
        logits, caches = model_prefill(params, {"tokens": torch.as_tensor(toks)}, cfg)
        caches = tree_map(pad, caches, model_caches(cfg, 12, 20, device="cpu"))
        seen = [logits]
        tok = torch.argmax(logits[..., : cfg.vocab_size], -1).to(torch.int32)[:, None]
        for i in range(3):
            logits, caches = model_decode(params, tok, caches, 16 + i, cfg)
            seen.append(logits)
            tok = torch.argmax(logits[..., : cfg.vocab_size], -1).to(torch.int32)[:, None]
        return seen, tree_leaves(caches)

    want, want_caches = run()
    with activation_rules(_rules(world1)):
        got, got_caches = run()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got_caches, want_caches))
