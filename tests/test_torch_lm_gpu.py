"""The port's LM stack on the card against the CPU, for every reduced config.

Imports only torch and the port (the machine with the card has no jax), and
skips on a host without a CUDA device.  Run it there with

    python -m pytest -q -m gpu tests/test_torch_lm_gpu.py

Each of the ten reduced configs, in float32 with TF32 off, runs on the same
weights and the same seeded batch on the card and on the CPU, stage by stage:

* ``forward``: the logits and ``aux``;
* ``prefill``: the last position's logits and every cache leaf;
* ``decode``: STEPS chained decode steps after the prefill, each step's
  logits and every cache leaf, the cache tensors written in place (the same
  tensors, the same ``data_ptr()``);
* ``train``: the loss and every gradient, then one ``make_train_step``
  step: its metrics, the parameters and the optimiser's ``master``, ``m``
  and ``v`` trees.

Tolerance atol = rtol = 1e-4, the one the CPU tests hold the port to
against the JAX package (the card's and the CPU's sums run in other
orders).  internvl2-1b gets ``num_prefix`` patch embeddings drawn after the
tokens from the same generator, and decodes from position S + num_prefix;
whisper-tiny gets S frames, and its caches ``enc_len=S``.  The MoE configs
run at capacity factor MOE_CF, where assignments drop, and their top-k
expert ids must be equal on both sides.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, reduced_config  # noqa: E402
from repro_torch.models import (  # noqa: E402
    model_caches,
    model_decode,
    model_forward,
    model_init,
    model_prefill,
    moe,
)
from repro_torch.models.common import tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402
from repro_torch.optim import OptConfig, adamw_init  # noqa: E402
from repro_torch.train import make_loss_fn, make_train_step  # noqa: E402
from repro_torch.train.loss import IGNORE  # noqa: E402
from repro_torch.train.step import _value_and_grad  # noqa: E402

TOL = 1e-4
#: the MoE configs' capacity factor (the reduced ones keep 8, where
#: nothing drops): at B x S tokens both drop assignments
MOE_CF = 1.0
B, S, STEPS = 2, 24, 3
STAGES = ["forward", "prefill", "decode", "train"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card against the CPU)")
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


def _config(arch):
    cfg = reduced_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=MOE_CF)
    return cfg


def _prefix_len(cfg):
    return cfg.num_prefix if cfg.frontend == "vision" else 0


def _inputs(cfg):
    """The batch (tokens, next-token labels, the prefix or the frames) and
    the decode steps' tokens, as numpy arrays from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int64)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), IGNORE)], axis=1)
    batch = {"tokens": toks, "labels": labels}
    if cfg.frontend == "vision":
        batch["prefix"] = rng.standard_normal((B, cfg.num_prefix, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    steps = rng.integers(1, cfg.vocab_size, (STEPS, B, 1)).astype(np.int64)
    return batch, steps


@contextlib.contextmanager
def _routes():
    """The top-k expert ids of every ``models.moe._route`` call inside."""
    calls, route = [], moe._route

    def recorded(params, xt, cfg):
        idx, gate, aux = route(params, xt, cfg)
        calls.append(idx)
        return idx, gate, aux

    moe._route = recorded
    try:
        yield calls
    finally:
        moe._route = route


def _forward(cfg, params, batch, steps):
    logits, aux = model_forward(params, batch, cfg)
    return {"logits": logits, "aux": aux}


def _prefill(cfg, params, batch, steps):
    logits, caches = model_prefill(params, batch, cfg)
    return {"logits": logits, "cache": caches}


def _pad(got, tgt):
    """A prefill cache copied into the fixed decode buffer (zero beyond)."""
    tgt[tuple(slice(0, n) for n in got.shape)] = got
    return tgt


def _decode(cfg, params, batch, steps):
    _, caches = model_prefill(params, batch, cfg)
    pos = S + _prefix_len(cfg)
    target = model_caches(cfg, B, pos + STEPS + 1, enc_len=S, device=batch["tokens"].device)
    caches = tree_map(_pad, caches, target)
    ptrs = [t.data_ptr() for t in tree_leaves(caches)]
    out = {}
    for i, tok in enumerate(steps):
        logits, returned = model_decode(params, tok, caches, pos + i, cfg)
        assert returned is caches and [t.data_ptr() for t in tree_leaves(caches)] == ptrs
        out[f"step{i}"] = {"logits": logits, "cache": tree_map(torch.clone, caches)}
    return out


def _train(cfg, params, batch, steps):
    (loss, _), grads = _value_and_grad(make_loss_fn(cfg), params, batch)
    step = make_train_step(cfg, OptConfig(warmup_steps=1))
    params, state, metrics = step(params, adamw_init(params), batch)
    return {"loss": loss, "grad": grads, "metrics": metrics, "params": params,
            "master": state.master, "m": state.m, "v": state.v}  # fmt: skip


_STAGE = {"forward": _forward, "prefill": _prefill, "decode": _decode, "train": _train}


def _dropped(idx, cfg) -> int:
    """Assignments past their expert's capacity (``models/moe.py``'s rule)."""
    T, K = idx.shape
    E = cfg.n_experts * cfg.moe_virtual_split
    return int((~moe._dispatch(idx, T, E, int(T * K / E * cfg.capacity_factor) + 1)[2]).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_card_matches_cpu(cuda, arch, stage):
    cfg = _config(arch)
    host = model_init(0, cfg, device="cpu")
    card = tree_map(lambda a: a.to(cuda, copy=True), host)
    batch, steps = _inputs(cfg)
    runs = []
    for params, dev in ((host, "cpu"), (card, cuda)):
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        toks = torch.as_tensor(steps, device=dev)
        if stage != "train":
            b.pop("labels")
        with _routes() as ids:
            tree = _STAGE[stage](cfg, params, b, toks)
        runs.append((tree, ids))
    (want, want_ids), (got, got_ids) = runs
    flat = dict(tree_leaves_with_path(want))
    assert sorted(flat) == sorted(path for path, _ in tree_leaves_with_path(got))
    for path, t in tree_leaves_with_path(got):
        np.testing.assert_allclose(
            t.detach().float().cpu().numpy(), flat[path].detach().float().numpy(),
            atol=TOL, rtol=TOL, err_msg=f"{arch} {stage} {path}",
        )  # fmt: skip
    assert len(got_ids) == len(want_ids)
    for a, b in zip(got_ids, want_ids):
        assert torch.equal(a.cpu(), b), f"{arch} {stage}: top-k ids differ"
    if cfg.n_experts:
        assert want_ids and sum(_dropped(i, cfg) for i in want_ids) > 0, f"{arch}: nothing dropped"
