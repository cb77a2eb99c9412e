"""The port's LM train step (``repro_torch.train``, ``optim``, the flash
backward, remat) against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through both packages; the
port gets the JAX package's weights through
``repro_torch.convert.lm_params_from_arrays`` and makes its own optimiser
state with ``adamw_init`` from them, as the JAX side does.  Covered:
``lm_loss`` with ignored labels and a padded vocabulary, ``lr_schedule``,
three ``adamw_update`` steps over a tree with a bf16 leaf and an active
clip, the flash backward against the JAX ``custom_vjp`` (causal, banded,
GQA, padded), the loss and every leaf's gradient for each dense reduced
config, for the MoE ones (mixtral, deepseek with MLA; the load-balance
aux term in the loss) and for the recurrent and encoder-decoder ones
(mamba2, recurrentgemma, whisper), one train step for each dense,
recurrent and encoder-decoder reduced config, ``microbatches=2``, the
remat policies, the twin of ``tests/test_models.py::test_train_step_decreases_loss``, and the
decode step's ``sample`` flag.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.utils.checkpoint import checkpoint  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.models import model_init as j_init  # noqa: E402
from repro.models.attention import chunked_attention as j_chunked_attention  # noqa: E402
from repro.train import lm_loss as j_lm_loss  # noqa: E402
from repro.train import make_loss_fn as j_make_loss_fn  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import model_caches, model_init, model_prefill  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402
from repro_torch.models.common import (  # noqa: E402
    tree_leaves, tree_leaves_with_path, tree_map, tree_unflatten,
)  # fmt: skip
from repro_torch.models.transformer import apply_remat  # noqa: E402
from repro_torch.train import lm_loss, make_decode_step, make_loss_fn, make_train_step  # noqa: E402
from repro_torch.train.step import _value_and_grad  # noqa: E402

#: float32 on both sides: the two frameworks' CPU matmuls sum in other
#: orders and their exp / log / rsqrt may differ in the last place
#: (tests/test_torch_lm.py's tolerance, atol = rtol)
ATOL = RTOL = 1e-4

DENSE = ["llama3.2-1b", "qwen1.5-0.5b", "phi3-mini-3.8b", "yi-34b", "internvl2-1b"]
#: the MoE decoders: mixtral (sliding window + MoE), deepseek (MLA + MoE)
MOE = ["deepseek-v2-236b", "mixtral-8x22b"]
#: mamba2 (SSD), recurrentgemma (RG-LRU + local attention), whisper
#: (encoder-decoder)
RECURRENT = ["mamba2-2.7b", "recurrentgemma-2b", "whisper-tiny"]
B, S = 2, 24
OPT = dict(lr=5e-3, warmup_steps=1, total_steps=50)
#: a train step's parameters and master: Adam's first update is
#: ``lr * g / (|g| + eps)`` after the clip, so where a gradient is near 0
#: (|g| * clip scale ~ eps) the frameworks' last-place gradient gaps move
#: the update by a share of ``lr``: measured up to 1.67e-4 at lr 5e-3 (the
#: JAX package's own loss test's) on one element of yi-34b's ``wq``, whose
#: gradient is 5.3e-8 in JAX and 4.4e-8 in the port
STEP_TOL = 3e-4
#: gradients and Adam's moments, per leaf: the largest gap over the leaf's
#: largest magnitude, as ATOL for the same float32 sums in other orders;
#: measured up to 3.1e-6 (yi-34b's ``v`` of ``norm1``), while one moment
#: off by 1% gives 1e-2
SHARE = 1e-4
#: a train step's elements whose clipped gradient is nonzero and below
#: NEAR_EPS x Adam's ``eps`` (_near_eps_moves): mamba2's gradient norm of
#: 34.7 clips a ``w_in`` gradient of -6.48e-7 in JAX and -3.49e-7 in the
#: port to about 2 ``eps``, and the step moves that element 7.4e-4 more in
#: JAX; beyond 4 ``eps`` no element of any config is more than 0.07 of
#: STEP_TOL apart
NEAR_EPS = 4


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _close(got, want, tol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol, err_msg=what)


def _close_trees(got, want, tol=ATOL, what="", share=None):
    """Every leaf of the port's tree against the JAX tree's (numpy leaves).

    With ``share``, each leaf's largest gap must also stay within ``share``
    of that leaf's largest magnitude (as ``chip_smoke.py``'s ``tol_share``):
    leaves whose values lie far below ``tol`` — Adam's moments after the
    clip, near-zero gradients — are then held to something."""
    want = jax.tree.map(np.asarray, want)
    tree_map(lambda g, w: None, got, want)  # the same keys and lengths
    flat = dict(tree_leaves_with_path(want))
    for path, leaf in tree_leaves_with_path(got):
        _close(leaf, flat[path], tol, f"{what}{path}")
        if share is not None:
            g, w = _np(leaf).astype(np.float64), _np(flat[path]).astype(np.float64)
            gap, top = float(np.abs(g - w).max(initial=0.0)), float(np.abs(w).max(initial=0.0))
            assert gap <= share * top, f"{what}{path}: gap {gap:.3g} > {share} x {top:.3g}"


def _batch(cfg, rng):
    """A training batch for both packages: (JAX batch, port batch).  Labels
    are the next tokens, IGNORE on the last position and on a few others."""
    toks = rng.integers(1, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, -1] = -1
    labels[rng.random((B, S)) < 0.1] = -1
    arrays = {"tokens": toks[:, :-1], "labels": labels}
    if cfg.frontend == "vision":
        arrays["prefix"] = rng.standard_normal((B, cfg.num_prefix, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        arrays["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return (
        {k: jnp.asarray(v) for k, v in arrays.items()},
        {k: torch.as_tensor(v) for k, v in arrays.items()},
    )


def _model(arch):
    """An arch's configs, the JAX package's weights on both sides and
    one batch."""
    jcfg, tcfg = jconfigs.reduced_config(arch), tconfigs.reduced_config(arch)
    jparams = j_init(jax.random.PRNGKey(3), jcfg)
    jb, tb = _batch(jcfg, np.random.default_rng(3))
    return arch, jcfg, tcfg, jparams, jb, tb


#: the train step's tests hold parameters after one Adam update, which
#: divides each gradient by its own magnitude; they run on the dense,
#: recurrent and encoder-decoder configs (STEP_TOL's note)
@pytest.fixture(scope="module", params=DENSE + RECURRENT)
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module", params=DENSE + MOE + RECURRENT)
def any_model(request):
    return _model(request.param)


def _port_params(jparams, tcfg):
    return lm_params_from_arrays(jax.tree.map(np.asarray, jparams), tcfg, "cpu")


# ---------------------------------------------------------------------------
# loss and optimiser
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,ignored", [(500, 0.2), (512, 0.2), (500, 1.0)])
def test_lm_loss_matches_jax(vocab, ignored):
    """vocab 500 pads to 512, so the pad mask is exercised; all-ignored
    labels give the count's floor of 1."""
    jcfg = dataclasses.replace(jconfigs.reduced_config("llama3.2-1b"), vocab_size=vocab)
    tcfg = dataclasses.replace(tconfigs.reduced_config("llama3.2-1b"), vocab_size=vocab)
    rng = np.random.default_rng(0)
    logits = (4 * rng.standard_normal((B, S, jcfg.vocab_padded))).astype(np.float32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < ignored] = -1
    want, want_n = j_lm_loss(jnp.asarray(logits), jnp.asarray(labels), jcfg)
    got, got_n = lm_loss(torch.as_tensor(logits), torch.as_tensor(labels), tcfg)
    assert int(got_n) == int(want_n) and got_n.dtype == torch.int32
    # one logsumexp and one mean over 48 rows of float32
    _close(got, want, 1e-6)


@pytest.mark.parametrize("step", [0, 1, 50, 100, 5_000, 10_000, 20_000])
def test_lr_schedule_matches_jax(step):
    cfg_j, cfg_t = joptim.OptConfig(), toptim.OptConfig()
    want = joptim.lr_schedule(cfg_j, jnp.asarray(step, jnp.int32))
    got = toptim.lr_schedule(cfg_t, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    # float32 on both sides, the same operations in the same order (equal
    # at every step here); the frameworks' cos may differ in the last place
    _close(got, want, 1e-7 * cfg_t.lr)


def test_adamw_update_matches_jax():
    """Three steps over a tree with a bf16 leaf; the gradients are large
    enough that the global-norm clip scales every step."""
    rng = np.random.default_rng(5)
    draw = lambda scale=1.0: {
        "w": (scale * rng.standard_normal((8, 16))).astype(np.float32),
        "b": (scale * rng.standard_normal(16)).astype(np.float32),
        "layers": [{"x": (scale * rng.standard_normal((4, 4))).astype(np.float32)}
                   for _ in range(2)],
    }  # fmt: skip
    arrays = draw()
    jparams = jax.tree.map(jnp.asarray, arrays)
    jparams["b"] = jparams["b"].astype(jnp.bfloat16)
    tparams = tree_map(torch.as_tensor, arrays)
    tparams["b"] = tparams["b"].to(torch.bfloat16)
    cfg_j = joptim.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    cfg_t = toptim.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jstate, tstate = joptim.adamw_init(jparams), toptim.adamw_init(tparams)
    assert tstate.master["w"].data_ptr() != tparams["w"].data_ptr()  # no alias
    for i in range(3):
        grads = draw(10.0)
        jgrads = jax.tree.map(jnp.asarray, grads)
        jgrads["b"] = jgrads["b"].astype(jnp.bfloat16)
        tgrads = tree_map(torch.as_tensor, grads)
        tgrads["b"] = tgrads["b"].to(torch.bfloat16)
        jparams, jstate, jm = joptim.adamw_update(jgrads, jstate, jparams, cfg_j)
        tparams, tstate, tm = toptim.adamw_update(tgrads, tstate, tparams, cfg_t)
        assert float(tm["grad_norm"]) > cfg_t.clip_norm  # the clip is active
        assert int(tstate.step) == int(jstate.step) == i + 1
        assert tparams["b"].dtype == torch.bfloat16 and tstate.master["b"].dtype == torch.float32
        # float32 element-wise arithmetic in the same order: the first step
        # is bitwise; then the norm's sum, taken in another order, moves
        # the last place (measured up to 6e-8 on the master)
        what = f"step {i + 1} "
        _close(tm["grad_norm"], jm["grad_norm"], 1e-6, what + "grad_norm")
        _close(tm["lr"], jm["lr"], 1e-6, what + "lr")
        for name in ("master", "m", "v"):
            _close_trees(getattr(tstate, name), getattr(jstate, name), 1e-6, f"{what}{name}")
        _close_trees(tparams, jparams, 1e-6, what + "params")


# ---------------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "causal,window,qc,kc,seq,heads,kv_heads",
    [
        # tests/test_flash_attention.py's grid (H = KVH = 3)
        (True, None, 32, 32, 96, 3, 3),
        (True, None, 64, 16, 96, 3, 3),
        (True, 16, 32, 32, 96, 3, 3),
        (True, 24, 16, 48, 120, 3, 3),
        (False, None, 48, 24, 96, 3, 3),
        (True, None, 128, 128, 100, 3, 3),  # padding path (S not chunk multiple)
        # grouped queries: 4 query heads over 2 KV heads, padded
        (True, None, 32, 32, 90, 4, 2),
        # banded, the window overrunning a chunk: q chunks near the end see
        # clipped out-of-range KV chunks
        (True, 40, 16, 16, 80, 4, 2),
    ],
)
def test_flash_backward_matches_jax(causal, window, qc, kc, seq, heads, kv_heads):
    rng = np.random.default_rng(0)
    D = 16
    q = rng.standard_normal((B, seq, heads, D)).astype(np.float32)
    k = rng.standard_normal((B, seq, kv_heads, D)).astype(np.float32)
    v = rng.standard_normal((B, seq, kv_heads, D)).astype(np.float32)
    dout = rng.standard_normal((B, seq, heads, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc)
    want_out, vjp = jax.vjp(
        lambda *a: j_chunked_attention(*a, **kw), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )
    want = vjp(jnp.asarray(dout))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = chunked_attention(*ts, **kw)
    got = torch.autograd.grad(out, ts, torch.as_tensor(dout))
    # sums of at most ~120 products of 16-wide float32 rows
    _close(out, want_out, 1e-5, "out")
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape == w.shape
        _close(g, w, 1e-5, f"d{name}")


# ---------------------------------------------------------------------------
# loss, gradients and the train step on the reduced configs
# ---------------------------------------------------------------------------


def test_loss_and_grads_match_jax(any_model):
    arch, jcfg, tcfg, jparams, jb, tb = any_model
    (jl, jm), jg = jax.value_and_grad(j_make_loss_fn(jcfg), has_aux=True)(jparams, jb)
    (tl, tm), tg = _value_and_grad(make_loss_fn(tcfg), _port_params(jparams, tcfg), tb)
    _close(tl, jl, what="loss")
    for key in ("ce", "aux"):
        _close(tm[key], jm[key], what=key)
    if arch in MOE:  # the load-balance term is in the loss and its gradient
        assert float(jm["aux"]) > 0
    assert int(tm["tokens"]) == int(jm["tokens"])
    _close_trees(tg, jg, what=f"{arch} grad ", share=SHARE)


def _near_eps_moves(jo, to, lr):
    """After one step from zero moments: the clipped gradient is
    ``m / (1 - b1)``, and Adam moves each element by ``-lr * u(g)``,
    ``u(g) = g / (|g| + eps)``, plus weight decay.  Where JAX's clipped
    gradient is nonzero but within NEAR_EPS x ``eps``, ``u`` turns last-place
    gradient gaps (held in test_loss_and_grads_match_jax) into a share of
    ``lr``.  Returns the count of such elements and a tree (JAX's layout,
    float64) that moves JAX's update there to the port's gradient's, and
    is 0 elsewhere."""
    opt = toptim.OptConfig(**OPT)
    u = lambda g: g / (np.abs(g) + opt.eps)
    port_m = dict(tree_leaves_with_path(tree_map(lambda t: t.double().numpy(), to.m)))
    count = 0

    def moved(path, jm):
        nonlocal count
        gj = np.asarray(jm).astype(np.float64) / (1 - opt.b1)
        gt = port_m[path] / (1 - opt.b1)
        near = (gj != 0) & (np.abs(gj) < NEAR_EPS * opt.eps)
        count += int(near.sum())
        return np.where(near, -lr * (u(gt) - u(gj)), 0.0)

    jm = jax.tree.map(np.asarray, jo.m)
    tree = tree_unflatten(jm, [moved(path, m) for path, m in tree_leaves_with_path(jm)])
    return count, tree


def _step_both(model, microbatches):
    arch, jcfg, tcfg, jparams, jb, tb = model
    jstep = jax.jit(j_make_train_step(jcfg, joptim.OptConfig(**OPT), microbatches=microbatches))
    jp, jo, jm = jstep(jparams, joptim.adamw_init(jparams), jb)
    tparams = _port_params(jparams, tcfg)
    tstep = make_train_step(tcfg, toptim.OptConfig(**OPT), microbatches=microbatches)
    tp, to, tm = tstep(tparams, toptim.adamw_init(tparams), tb)
    assert sorted(tm) == sorted(jm) == ["aux", "ce", "grad_norm", "loss", "lr", "tokens"]
    for key in ("ce", "aux", "loss", "grad_norm", "lr"):
        _close(tm[key], jm[key], what=key)
    assert int(tm["tokens"]) == int(jm["tokens"])
    near, moved = _near_eps_moves(jo, to, float(tm["lr"]))
    print(f"{arch}: {near} elements with 0 < |g| < {NEAR_EPS} eps held to JAX's parameter "
          f"moved by Adam's update of the port's gradient")  # fmt: skip
    shift = lambda tree: tree_map(lambda w, d: _np(w).astype(np.float64) + d, tree, moved)
    want_p = shift(jax.tree.map(np.asarray, jp))
    _close_trees(tp, want_p, STEP_TOL, f"{arch} params ")
    assert not any(t.requires_grad for t in tree_leaves(tp))
    assert int(to.step) == int(jo.step) == 1
    want_m = shift(jax.tree.map(np.asarray, jo.master))
    _close_trees(to.master, want_m, STEP_TOL, f"{arch} master ")
    for name in ("m", "v"):
        _close_trees(getattr(to, name), getattr(jo, name), what=f"{arch} {name} ", share=SHARE)


def test_train_step_matches_jax(model):
    _step_both(model, 1)


def test_microbatches_match_jax(model):
    """Two microbatches: float32 gradient sums over the halves, the mean
    loss, and the last microbatch's ce / aux / tokens."""
    _step_both(model, 2)


# ---------------------------------------------------------------------------
# remat, the loss going down, the decode step's flag
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_policies_give_the_same_gradients(policy):
    """On the CPU the recompute repeats the same operations on the same
    inputs, so the gradients are bitwise those of ``"none"``."""
    base = tconfigs.reduced_config("llama3.2-1b")
    params = model_init(0, base, device="cpu")
    _, tb = _batch(base, np.random.default_rng(4))
    (l0, _), g0 = _value_and_grad(make_loss_fn(base), params, tb)
    cfg = dataclasses.replace(base, remat_policy=policy)
    (l1, _), g1 = _value_and_grad(make_loss_fn(cfg), params, tb)
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_remat_unknown_policy_raises_and_serving_skips_remat(monkeypatch):
    with pytest.raises(ValueError, match="unknown remat policy 'all'"):
        apply_remat(lambda x: x, "all")
    calls = []

    def body(x):
        calls.append(torch.is_grad_enabled())
        return x * x

    apply_remat(body, "nothing")(torch.ones(2, requires_grad=True)).sum().backward()
    assert calls == [True, True]  # the forward, then the recompute
    # the group bodies run under checkpoint only while autograd records
    from repro_torch.models import transformer

    wrapped = []
    monkeypatch.setattr(
        transformer, "checkpoint", lambda *a, **kw: wrapped.append(1) or checkpoint(*a, **kw)
    )
    cfg = dataclasses.replace(tconfigs.reduced_config("llama3.2-1b"), remat_policy="nothing")
    params = model_init(0, cfg, device="cpu")
    _, tb = _batch(cfg, np.random.default_rng(4))
    model_prefill(params, tb, cfg)
    assert wrapped == []
    _value_and_grad(make_loss_fn(cfg), params, tb)
    assert len(wrapped) == cfg.n_layers
    # an unknown policy raises wherever the layers run, as in the JAX package
    bogus = dataclasses.replace(cfg, remat_policy="bogus")
    with pytest.raises(ValueError, match="unknown remat policy 'bogus'"):
        model_prefill(params, tb, bogus)


@pytest.mark.parametrize("arch", DENSE + MOE + RECURRENT)
def test_train_step_decreases_loss(arch):
    """The twin of tests/test_models.py::test_train_step_decreases_loss."""
    cfg = tconfigs.reduced_config(arch)
    rng = np.random.default_rng(1)
    params = model_init(1, cfg, device="cpu")
    batch = {
        "tokens": torch.as_tensor(rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)),
        "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)),
    }
    if cfg.frontend == "vision":
        batch["prefix"] = torch.as_tensor(
            rng.standard_normal((B, cfg.num_prefix, cfg.d_model)).astype(np.float32)
        )
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.as_tensor(
            rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        )
    step = make_train_step(cfg, toptim.OptConfig(**OPT))
    opt = toptim.adamw_init(params)
    losses = []
    for _ in range(8):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], f"{arch}: loss did not decrease {losses}"


def test_decode_step_sample_flag_gives_the_same_tokens():
    cfg = tconfigs.reduced_config("llama3.2-1b")
    params = model_init(0, cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(6).integers(1, cfg.vocab_size, (B, 8)))
    logits, pre = model_prefill(params, {"tokens": toks}, cfg)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    outs = []
    for sample in (False, True):
        caches = model_caches(cfg, B, 12, device="cpu")
        tree_map(lambda got, tgt: tgt[:, :, : got.shape[2]].copy_(got), pre, caches)
        step = make_decode_step(cfg, sample=sample)
        outs.append(step(params, {"token": tok, "cache_len": 8}, caches)[0])
    assert torch.equal(outs[0], outs[1])


def test_decode_step_never_returns_a_padded_id():
    """vocab 500 pads the head to 512 columns.  Each row's padded column
    500 + b is made twice its best token's, so the argmax over every column
    is a padded id; the step returns the best id of the vocabulary."""
    cfg = dataclasses.replace(tconfigs.reduced_config("llama3.2-1b"), vocab_size=500)
    params = model_init(0, cfg, device="cpu")
    head = params["lm_head"] if "lm_head" in params else params["embed"].T
    toks = torch.as_tensor(np.random.default_rng(6).integers(1, cfg.vocab_size, (B, 8)))
    logits, pre = model_prefill(params, {"tokens": toks}, cfg)
    tok = torch.argmax(logits[:, : cfg.vocab_size], -1).to(torch.int32)[:, None]
    caches = model_caches(cfg, B, 12, device="cpu")
    tree_map(lambda got, tgt: tgt[:, :, : got.shape[2]].copy_(got), pre, caches)
    step = make_decode_step(cfg)
    best, step_logits, _ = step(params, {"token": tok, "cache_len": 8}, caches)
    assert float(step_logits[:, : cfg.vocab_size].max(-1).values.min()) > 0
    with torch.no_grad():
        for b in range(B):
            head[:, cfg.vocab_size + b] = 2 * head[:, int(best[b])]
    got, step_logits, _ = step(params, {"token": tok, "cache_len": 8}, caches)
    assert (torch.argmax(step_logits, -1) >= cfg.vocab_size).all()
    assert torch.equal(got, best) and got.dtype == torch.int32
