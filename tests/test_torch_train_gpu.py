"""The port's LM train step on the card against the CPU.

Imports only torch and the port (the machine with the card has no jax), and
skips on a host without a CUDA device.  Run it there with

    python -m pytest -q -m gpu tests/test_torch_train_gpu.py

Tolerances: the reduced llama config in float32 with TF32 off (each remat
policy, one and two microbatches), the loss, every gradient and one train
step (metrics, parameters, optimiser state) within atol = rtol = 1e-4, the
tolerance the CPU tests hold the port to against the JAX package (the
card's and the CPU's matmuls sum in other orders); the flash backward in
float32 within 1e-5 (sums of at most ~100 products of 16-wide rows).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import model_init  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402
from repro_torch.models.common import tree_leaves_with_path, tree_map  # noqa: E402
from repro_torch.optim import OptConfig, adamw_init  # noqa: E402
from repro_torch.train import make_loss_fn, make_train_step  # noqa: E402
from repro_torch.train.step import _value_and_grad  # noqa: E402

TOL = 1e-4
FLASH_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card against the CPU)")
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        got.detach().float().cpu().numpy(), want.detach().float().cpu().numpy(),
        atol=tol, rtol=tol, err_msg=what,
    )  # fmt: skip


def _close_trees(got, want, tol, what=""):
    flat = dict(tree_leaves_with_path(want))
    for path, leaf in tree_leaves_with_path(got):
        _close(leaf, flat[path], tol, what + path)


def _batch(cfg, rng, device):
    toks = rng.integers(1, cfg.vocab_size, (2, 33)).astype(np.int64)
    labels = toks[:, 1:].copy()
    labels[:, -1] = -1
    return {"tokens": torch.as_tensor(toks[:, :-1], device=device),
            "labels": torch.as_tensor(labels, device=device)}  # fmt: skip


@pytest.mark.gpu
@pytest.mark.parametrize("microbatches,remat", [(1, "none"), (2, "nothing"), (1, "dots")])
def test_train_step_card_matches_cpu(cuda, microbatches, remat):
    cfg = dataclasses.replace(reduced_config("llama3.2-1b"), remat_policy=remat)
    host = model_init(0, cfg, device="cpu")
    card = tree_map(lambda a: a.to(cuda, copy=True), host)
    rng = np.random.default_rng(0)
    host_batch = _batch(cfg, rng, "cpu")
    card_batch = {k: v.to(cuda) for k, v in host_batch.items()}
    (hl, hm), hg = _value_and_grad(make_loss_fn(cfg), host, host_batch)
    (cl, cm), cg = _value_and_grad(make_loss_fn(cfg), card, card_batch)
    _close(cl, hl, TOL, "loss")
    _close_trees(cg, hg, TOL, "grad")
    step = make_train_step(cfg, OptConfig(warmup_steps=1), microbatches=microbatches)
    hp, ho, hm = step(host, adamw_init(host), host_batch)
    cp, co, cm = step(card, adamw_init(card), card_batch)
    for key in hm:
        _close(cm[key], hm[key], TOL, key)
    _close_trees(cp, hp, TOL, "params")
    for name in ("master", "m", "v"):
        _close_trees(getattr(co, name), getattr(ho, name), TOL, name)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "causal,window,qc,kc,seq,heads,kv_heads",
    [
        (True, None, 32, 32, 90, 4, 2),  # GQA, padded
        (True, 40, 16, 16, 80, 4, 2),  # banded, the window overrunning a chunk
        (False, None, 48, 24, 96, 3, 3),
    ],
)
def test_flash_backward_card_matches_cpu(cuda, causal, window, qc, kc, seq, heads, kv_heads):
    rng = np.random.default_rng(0)
    arrays = [
        rng.standard_normal((2, seq, h, 16)).astype(np.float32)
        for h in (heads, kv_heads, kv_heads, heads)
    ]
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc)
    res = []
    for device in ("cpu", cuda):
        q, k, v, dout = (torch.tensor(a, device=device) for a in arrays)
        ts = [t.requires_grad_(True) for t in (q, k, v)]
        out = chunked_attention(*ts, **kw)
        res.append((out, *torch.autograd.grad(out, ts, dout)))
    for got, want, name in zip(res[1], res[0], ("out", "dq", "dk", "dv")):
        _close(got, want, FLASH_TOL, name)
