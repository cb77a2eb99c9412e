"""Multi-pod dry run: run every (arch x shape x mesh) cell's step on fake ranks.

The port of ``repro/launch/dryrun.py``: the proof that the distribution
config is coherent without the hardware.  Each cell's train, prefill or
decode step (``repro_torch.train``) must run on the (16, 16) single-pod mesh
AND on the (2, 16, 16) multi-pod mesh, under torch's fake process group (256
or 512 ranks, this process rank 0) and ``FakeTensorMode``.  Nothing is
allocated: every input is a fake DTensor, placed by ``param_specs``,
``batch_specs`` and ``cache_specs``, and the step runs under
``default_rules``, so ``constrain`` redistributes the residuals and the
logits and ``moe_apply`` takes its expert-parallel branch.

Where the JAX module reads XLA's analyses of the compiled program, this one
counts rank 0's work as the step runs, on local shapes (:class:`_Tally`, a
``TorchDispatchMode`` that lets DTensor turn each op into its local ops and
collectives before it counts them):

* ``bytes_per_device``: ``arguments``, the inputs' local shards;
  ``outputs``, the step's results; ``temp``, the peak of live local bytes
  during the step less ``arguments``; ``alias``, the results the step wrote
  in place (the train step's parameters and optimiser state, decode's
  caches; the JAX launcher donates them);
* ``cost_analysis.flops``: ``torch.utils.flop_counter``'s formulas on the
  local ops (``bytes_accessed`` is not counted);
* ``collectives``: how many of each collective rank 0 issued, under the JAX
  module's names (``collective_bytes``: the larger of each one's local
  input and output, summed);
* ``trace_s``: the step's wall time on the host, in place of ``lower_s``
  and ``compile_s``.

XLA's HLO has no counterpart: ``save_comms`` writes ``<tag>.comms.json``,
each collective with its op, mesh dim, bytes and the model line that issued
it.  Decode's ``cache_len`` is a Python int, ``S - 1`` (the port's decode
reads ``int(cache_len)``), where the JAX step takes a scalar int32.
Results are cached incrementally in ``dryrun_results_torch/summary.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--device-type cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
import traceback
import weakref
from contextlib import contextmanager
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, ShapeSpec, get_config, shape_applicable
from repro_torch.models import init_params_shape, model_caches
from repro_torch.models.common import ModelConfig, tree_leaves, tree_map
from repro_torch.optim import OptConfig
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding import batch_specs, cache_specs, named, param_specs
from repro_torch.sharding.context import activation_rules, default_rules
from repro_torch.train import make_decode_step, make_prefill_step, make_train_step

from .mesh import make_production_mesh

__all__ = ["RESULTS_DIR", "input_specs", "run_cell", "cell_id", "run_all", "main"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_results_torch"

#: the JAX module's collective names, and the torch ops counted under each
_COLLECTIVES = {
    "all-gather": ("all_gather", "allgather"),
    "all-reduce": ("all_reduce", "allreduce"),
    "reduce-scatter": ("reduce_scatter",),
    "all-to-all": ("all_to_all", "alltoall"),
    "collective-permute": ("send", "recv", "permute"),
}


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape_name: str):
    """Meta-device stand-ins for every model input of this cell.

    train/prefill: the token batch (+ stub frontend embeddings);
    decode: one new token + the full-length caches, and ``cache_len`` as
    the Python int ``S - 1``.
    """
    return _input_specs(cfg, SHAPES[shape_name])


def _input_specs(cfg: ModelConfig, spec: ShapeSpec):
    B, S = spec.global_batch, spec.seq_len
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    if spec.kind in ("train", "prefill"):
        P = cfg.num_prefix if cfg.frontend == "vision" else 0
        batch = {"tokens": meta((B, S - P), torch.int32), "labels": meta((B, S - P), torch.int32)}
        if cfg.frontend == "vision":
            batch["prefix"] = meta((B, P, cfg.d_model), cfg.dtype)
        if cfg.is_encoder_decoder:
            batch["frames"] = meta((B, S, cfg.d_model), cfg.dtype)
        if spec.kind == "prefill":
            batch.pop("labels")
        return {"batch": batch}
    # decode: one token against a seq_len cache
    return {
        "batch": {"token": meta((B, 1), torch.int32), "cache_len": S - 1},
        "caches": model_caches(cfg, B, S, enc_len=S, device="meta"),
    }


# ---------------------------------------------------------------------------
# counting rank 0's work
# ---------------------------------------------------------------------------


def _collective_name(packet) -> str | None:
    """The JAX module's name of a collective op, or ``None`` for another op."""
    ns = packet._qualified_op_name.split("::")[0]
    if ns not in ("_c10d_functional", "c10d_functional", "c10d", "_dtensor",
                  "_c10d_functional_autograd"):  # fmt: skip
        return None
    name = packet.__name__
    for jax_name, keys in _COLLECTIVES.items():
        if any(k in name for k in keys):
            return jax_name
    return None if name in ("wait_tensor", "wait") else name


def _model_line() -> str:
    """``file:line function`` of the innermost frame in the port's model,
    train or optim code (the collective's issuer)."""
    f = sys._getframe(1)
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        if "/repro_torch/" in path and "/sharding/" not in path and "/launch/" not in path:
            short = path[path.index("/repro_torch/") + 1 :]
            return f"{short}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return "?"


class _Tally:
    """Counts the local ops of a step: FLOPs, live bytes, collectives.

    Its mode returns ``NotImplemented`` on a DTensor op, so DTensor runs it
    as local ops and collectives on each rank's shards, which come back to
    the mode and are counted at their local shapes.  A storage counts as
    live from the op that made it until it is freed."""

    def __init__(self, mesh):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        self.flops = 0
        self.paused = 0
        self.live = 0
        self.peak = 0
        self.comms: list = []
        self._sizes: dict = {}
        self._groups = {}
        for i, name in enumerate(mesh.mesh_dim_names):
            self._groups[mesh.get_group(i).group_name] = name
        tally = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor

                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                if tally.paused:
                    return out
                if isinstance(func, torch._ops.OpOverload):
                    packet = func._overloadpacket
                    if packet in flop_registry:
                        tally.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
                    name = _collective_name(packet)
                    if name is not None:
                        tally._collective(name, packet.__name__, args, kwargs, out)
                for t in _tensors(out):
                    tally.track(t)
                return out

        self.mode = _Mode()

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    def _collective(self, name, op, args, kwargs, out) -> None:
        nbytes = max([t.numel() * t.element_size() for t in _tensors((args, out))] or [0])
        group = "?"
        for a in (*args, *kwargs.values()):
            if isinstance(a, str) and a in self._groups:
                group = self._groups[a]
            elif hasattr(a, "group_name") and a.group_name in self._groups:
                group = self._groups[a.group_name]
        self.comms.append({"collective": name, "op": op, "mesh_dim": group,
                           "bytes": int(nbytes), "issued_by": _model_line()})  # fmt: skip


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@contextmanager
def _dtensor_patches(tally: _Tally | None = None):
    """Two DTensor internals, patched while the dry run is on.  It computes
    uneven and strided shards' sizes and offsets with small index tensors,
    whose ``tolist()`` under ``FakeTensorMode`` has no data: that arithmetic
    runs on real tensors.  It infers an op's output metadata by running the
    op on fake tensors of the global shapes: the tally skips those."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _utils
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    def real(fn):
        def wrapped(*args, **kwargs):
            with unset_fake_temporarily():
                return fn(*args, **kwargs)

        return wrapped

    def uncounted(fn):
        if tally is None:
            return fn

        def wrapped(*args, **kwargs):
            tally.paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                tally.paused -= 1

        return wrapped

    sites = [(_StridedShard, "local_shard_size_and_offset", real),
             (_utils, "_compute_local_shape_and_global_offset", real),
             (ShardingPropagator, "_propagate_tensor_meta_non_cached", uncounted)]  # fmt: skip
    saved = [getattr(owner, name) for owner, name, _ in sites]
    for owner, name, wrap in sites:
        setattr(owner, name, wrap(getattr(owner, name)))
    try:
        yield
    finally:
        for (owner, name, _), fn in zip(sites, saved):
            setattr(owner, name, fn)


# ---------------------------------------------------------------------------
# per-cell dry run
# ---------------------------------------------------------------------------


def _local(t):
    from repro_torch.sharding.context import is_dtensor

    return t.to_local() if is_dtensor(t) else t


def _local_bytes(tree) -> int:
    return sum(_local(t).numel() * t.element_size() for t in _tensors(tree))


@functools.lru_cache(maxsize=16)
def _params_shape(cfg: ModelConfig):
    """``init_params_shape(cfg)``, kept for the config's other cells (the
    meta tensors are only read)."""
    return init_params_shape(cfg)


def _placed_inputs(cfg: ModelConfig, spec: ShapeSpec, mesh, device_type: str):
    """The cell's inputs as DTensors over ``mesh`` whose shards are fresh
    tensors of the local shapes (call under ``FakeTensorMode`` to allocate
    nothing): ``{"params", "batch"}`` plus ``"opt_state"`` (train) or
    ``"caches"`` (decode)."""
    from torch.distributed.tensor import Replicate

    from repro_torch.sharding.context import from_shards

    def place(leaf, placements, dtype=None):
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        local, _ = compute_local_shape_and_global_offset(leaf.shape, mesh, placements)
        t = torch.empty(local, dtype=dtype or leaf.dtype, device=device_type)
        return from_shards(t, mesh, placements, leaf.shape)

    params_shape = _params_shape(cfg)
    pmode = "train" if spec.kind == "train" else "serve"
    pplace = named(mesh, param_specs(cfg, params_shape, mesh, mode=pmode))
    ins = _input_specs(cfg, spec)
    bspecs = batch_specs(cfg, mesh, spec.global_batch, kind=spec.kind)
    out = {"params": tree_map(place, params_shape, pplace), "batch": {}}
    for k, leaf in ins["batch"].items():
        out["batch"][k] = leaf if k == "cache_len" else place(leaf, named(mesh, {k: bspecs[k]})[k])
    if spec.kind == "train":
        f32 = lambda leaf, p: place(leaf, p, torch.float32)
        replicated = [Replicate()] * mesh.ndim
        out["opt_state"] = AdamWState(
            step=place(torch.empty((), dtype=torch.int32, device="meta"), replicated),
            master=tree_map(f32, params_shape, pplace),
            m=tree_map(f32, params_shape, pplace),
            v=tree_map(f32, params_shape, pplace),
        )
    elif spec.kind == "decode":
        cplace = named(mesh, cache_specs(cfg, ins["caches"], mesh, spec.global_batch))
        out["caches"] = tree_map(place, ins["caches"], cplace)
    return out


def _estimate(cfg: ModelConfig, spec: ShapeSpec, mesh, *, microbatches: int = 1,
              donate: bool = True, device_type: str = "cuda") -> dict:  # fmt: skip
    """Run ``spec``'s step of ``cfg`` once on fake DTensors over ``mesh``
    and count rank 0's bytes, FLOPs and collectives (the module docstring's
    record, without the cell's names)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    rec: dict = {}
    tally = _Tally(mesh)
    with FakeTensorMode(), _dtensor_patches(tally):
        ins = _placed_inputs(cfg, spec, mesh, device_type)
        inputs = [_local(t) for t in _tensors(ins)]
        for t in inputs:
            tally.track(t)
        arguments = _local_bytes(ins)
        input_keys = {t.untyped_storage()._cdata for t in inputs}
        if spec.kind == "train":
            mb = max(microbatches, cfg.train_microbatches)
            rec["microbatches"] = mb
            step = make_train_step(cfg, OptConfig(), microbatches=mb)
            args = (ins["params"], ins["opt_state"], ins["batch"])
        elif spec.kind == "prefill":
            step = make_prefill_step(cfg)
            args = (ins["params"], ins["batch"])
        else:
            step = make_decode_step(cfg)
            args = (ins["params"], ins["batch"], ins["caches"])
        rules = default_rules(mesh, spec.global_batch, spec.seq_len, cfg.d_model)
        t0 = time.time()
        with activation_rules(rules), implicit_replication(), tally.mode:
            if not donate:  # the step writes in place: without donation it takes copies
                args = _copies(args, spec.kind)
            out = step(*args)
        trace_s = time.time() - t0
        outs = [_local(t) for t in _tensors(out)]
        outputs = sum(t.numel() * t.element_size() for t in outs)
        alias = sum(t.numel() * t.element_size() for t in outs
                    if t.untyped_storage()._cdata in input_keys)  # fmt: skip
    counts = {name: 0 for name in _COLLECTIVES}
    moved: dict = {name: 0 for name in _COLLECTIVES}
    for c in tally.comms:
        counts[c["collective"]] = counts.get(c["collective"], 0) + 1
        moved[c["collective"]] = moved.get(c["collective"], 0) + c["bytes"]
    rec.update(
        trace_s=round(trace_s, 2),
        bytes_per_device={
            "arguments": arguments,
            "outputs": outputs,
            "temp": tally.peak - arguments,
            "alias": alias,
        },
        cost_analysis={
            "flops": tally.flops,
            "bytes_accessed": None,
            "reason": "not counted: the local ops' reads and writes are not traced",
        },
        collectives=counts,
        collective_bytes=moved,
        comms=tally.comms,
    )
    return rec


def _copies(args, kind: str):
    """The step's arguments with what the JAX launcher donates copied."""
    clone = lambda tree: tree_map(lambda t: t.clone(), tree)
    if kind == "train":
        params, opt, batch = args
        opt = AdamWState(opt.step.clone(), clone(opt.master), clone(opt.m), clone(opt.v))
        return clone(params), opt, batch
    if kind == "decode":
        return args[0], args[1], clone(args[2])
    return args


def _fake_world(n: int) -> None:
    """Torch's fake process group over ``n`` ranks, this process rank 0,
    unless a group of that size is up; a fake group of another size is
    replaced."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group of {dist.get_world_size()} "
                               f"ranks is up; the dry run needs {n}")  # fmt: skip
        dist.destroy_process_group()
        # DTensor caches its sharding decisions by mesh shape and names, and
        # a cached decision would carry the destroyed group's mesh
        from torch.distributed.tensor import DTensor

        propagator = DTensor._op_dispatcher.sharding_propagator
        propagator.propagate_op_sharding.cache_clear()
        propagator._propagate_tensor_meta_cached.cache_clear()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    save_comms: bool = True,
    microbatches: int = 1,
    donate: bool = True,
    device_type: str = "cuda",
):
    """Run one cell on fake ranks. Returns the result record (dict)."""
    cfg = get_config(arch)
    spec = SHAPES[shape_name]
    _fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(n) for n in mesh.shape),
        "devices": mesh.size(),
        "kind": spec.kind,
        "ok": False,
    }
    rec = _estimate(cfg, spec, mesh, microbatches=microbatches, donate=donate,
                    device_type=device_type)  # fmt: skip
    comms = rec.pop("comms")
    record.update(rec, ok=True, params=cfg.param_count(), params_active=cfg.active_param_count())
    if save_comms:
        RESULTS_DIR.mkdir(exist_ok=True)
        tag = f"{arch}_{shape_name}_{record['mesh']}"
        path = RESULTS_DIR / f"{tag}.comms.json"
        path.write_text(json.dumps(comms, indent=1))
        record["comms_path"] = str(path)
    return record


def cell_id(arch, shape, multi_pod):
    return f"{arch}|{shape}|{'2pod' if multi_pod else '1pod'}"


def run_all(*, multi_pod_values=(False, True), archs=None, shapes=None, force: bool = False,
            device_type: str = "cuda"):  # fmt: skip
    RESULTS_DIR.mkdir(exist_ok=True)
    summary_path = RESULTS_DIR / "summary.json"
    summary = {}
    if summary_path.exists():
        summary = json.loads(summary_path.read_text())
    archs = archs or ARCH_IDS
    shapes = shapes or list(SHAPES)
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes:
            if not shape_applicable(cfg, shape):
                summary[cell_id(arch, shape, False)] = {
                    "arch": arch, "shape": shape, "skipped": True,
                    "reason": "inapplicable (configs.shape_applicable)",
                }  # fmt: skip
                summary_path.write_text(json.dumps(summary, indent=1))
                continue
            for mp in multi_pod_values:
                cid = cell_id(arch, shape, mp)
                if not force and summary.get(cid, {}).get("ok"):
                    continue
                print(f"=== {cid} ===", flush=True)
                try:
                    rec = run_cell(arch, shape, multi_pod=mp, device_type=device_type)
                    print(f"    ok: trace {rec['trace_s']}s, "
                          f"temp/dev {rec['bytes_per_device']['temp']}", flush=True)  # fmt: skip
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = {
                        "arch": arch, "shape": shape, "ok": False,
                        "error": f"{type(e).__name__}: {e}",
                        "trace": traceback.format_exc()[-2000:],
                    }  # fmt: skip
                    print(f"    FAIL: {rec['error'][:200]}", flush=True)
                summary[cid] = rec
                summary_path.write_text(json.dumps(summary, indent=1))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device-type", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' and the mesh's device type")  # fmt: skip
    args = ap.parse_args(argv)
    if args.all:
        summary = run_all(force=args.force, device_type=args.device_type)
        n_ok = sum(1 for v in summary.values() if v.get("ok"))
        n_skip = sum(1 for v in summary.values() if v.get("skipped"))
        n_fail = sum(1 for v in summary.values() if not v.get("ok") and not v.get("skipped"))
        print(f"\ncells ok={n_ok} skipped={n_skip} failed={n_fail}")
        raise SystemExit(1 if n_fail else 0)
    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod, device_type=args.device_type)
    print(json.dumps({k: v for k, v in rec.items() if k != "trace"}, indent=2))


if __name__ == "__main__":
    main()
