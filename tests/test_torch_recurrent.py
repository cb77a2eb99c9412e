"""The port's SSD, RG-LRU and encoder-decoder modules
(``repro_torch.models.{ssm,rglru,encdec}``) against the JAX package's, on
the CPU, module by module.

The same inputs, made with numpy from a seed, go through both packages; the
port gets the JAX package's weights as numpy arrays.  Covered: the causal
conv with and without a carried tail, ``ssd_apply`` over three chunks with
a padded tail (outputs, final state and gradients, with and without an
initial state), a ``dt`` large enough for ``F.softplus``'s linear branch,
``rglru_apply`` over 300 positions with an initial state (against JAX and
against a plain sequential loop), four chained ``ssd_decode`` and
``rglru_decode`` steps that write the caches in place, the SSD forward
over a 256-position chunk against its own decode recurrence and against
the JAX package's, ``encode``,
and the encoder-decoder decode step with grouped cross-attention heads
past the position table.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import encdec as j_encdec  # noqa: E402
from repro.models import rglru as j_rglru  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import encdec, rglru, ssm  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402

#: float32 on both sides, the same operations with sums in other orders
#: (tests/test_torch_lm.py's tolerance against the JAX package)
ATOL = RTOL = 1e-4
B = 2


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol, err_msg=what)


def _close_trees(got, want, tol=ATOL, what=""):
    tree_map(lambda g, w: _close(g, w, tol, what), got, jax.tree.map(np.asarray, want))


def _port(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, tree))


def _configs(arch, **change):
    jcfg, tcfg = jconfigs.reduced_config(arch), tconfigs.reduced_config(arch)
    return dataclasses.replace(jcfg, **change), dataclasses.replace(tcfg, **change)


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the causal conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("width", [1, 4])
def test_causal_conv_matches_jax(with_state, width):
    rng = np.random.default_rng(0)
    x, w = _x(rng, B, 7, 12), _x(rng, width, 12)
    state = _x(rng, B, width - 1, 12) if with_state else None
    jout, jstate = j_ssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w), state=None if state is None else jnp.asarray(state)
    )
    tout, tstate = ssm._causal_conv(
        torch.as_tensor(x), torch.as_tensor(w),
        state=None if state is None else torch.as_tensor(state),
    )  # fmt: skip
    _close(tout, jout, 1e-6, "out")
    _close(tstate, jstate, 0.0, "state")  # a slice of the same inputs


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------


def _ssd(seed, dt_bias=None):
    jcfg, tcfg = _configs("mamba2-2.7b")
    jp = j_ssm.ssd_init(jax.random.PRNGKey(seed), jcfg)
    if dt_bias is not None:
        jp["dt_bias"] = jnp.full_like(jp["dt_bias"], dt_bias)
    return jcfg, tcfg, jp, _port(jp)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_apply_matches_jax(with_state):
    """chunk 8 over 21 positions: three chunks, the last padded by 3."""
    jcfg, tcfg, jp, tp = _ssd(0)
    rng = np.random.default_rng(1)
    x = _x(rng, B, 21, jcfg.d_model)
    h0 = _x(rng, B, jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state) if with_state else None
    jout, jcache = j_ssm.ssd_apply(
        jp, jnp.asarray(x), jcfg, chunk=8, initial_state=None if h0 is None else jnp.asarray(h0)
    )
    tout, tcache = ssm.ssd_apply(
        tp, torch.as_tensor(x), tcfg, chunk=8,
        initial_state=None if h0 is None else torch.as_tensor(h0),
    )  # fmt: skip
    _close(tout, jout, what="out")
    _close_trees(tcache, jcache, what="cache")
    assert tcache["ssm"].dtype == torch.float32


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_apply_gradients_match_jax(with_state):
    """The gradients of a weighted sum of the output and the final state
    with respect to the input, every parameter and the initial state."""
    jcfg, tcfg, jp, tp = _ssd(2)
    rng = np.random.default_rng(3)
    x = _x(rng, B, 21, jcfg.d_model)
    h0 = _x(rng, B, jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state)
    wy, wh = _x(rng, B, 21, jcfg.d_model), _x(rng, *h0.shape)

    def jloss(p, x, h0):
        out, cache = j_ssm.ssd_apply(p, x, jcfg, chunk=8, initial_state=h0 if with_state else None)
        return (out * wy).sum() + (cache["ssm"] * wh).sum()

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(x), jnp.asarray(h0))
    leaves = [*tree_leaves(tp), torch.as_tensor(x), torch.as_tensor(h0)]
    for t in leaves:
        t.requires_grad_(True)
    out, cache = ssm.ssd_apply(
        tp, leaves[-2], tcfg, chunk=8, initial_state=leaves[-1] if with_state else None
    )
    tl = (out * torch.as_tensor(wy)).sum() + (cache["ssm"] * torch.as_tensor(wh)).sum()
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    _close(tl, jl, what="loss")
    want = [*jax.tree.leaves(jg[0]), jg[1], jg[2]]
    got = dict(zip(tp, grads))  # jax.tree.leaves sorts the keys
    for name, w in zip(sorted(tp), want):
        assert np.isfinite(_np(got[name])).all(), name
        _close(got[name], w, what=f"d{name}")
    _close(grads[-2], want[-2], what="dx")
    if with_state:
        _close(grads[-1], want[-1], what="dh0")
    else:
        assert grads[-1] is None


def test_ssd_large_dt_softplus_matches_jax():
    """dt_bias 30: every dt lies past ``F.softplus``'s threshold of 20,
    where it returns its input; ``jax.nn.softplus`` is ``logaddexp(x, 0)``."""
    z = np.linspace(-40.0, 60.0, 2001, dtype=np.float32)
    _close(torch.nn.functional.softplus(torch.as_tensor(z)), jax.nn.softplus(jnp.asarray(z)),
           1e-6, "softplus")  # fmt: skip
    jcfg, tcfg, jp, tp = _ssd(4, dt_bias=30.0)
    x = _x(np.random.default_rng(5), B, 21, jcfg.d_model)
    dt = _np(ssm._split_in(tp, torch.as_tensor(x), tcfg)[2]) + 30.0
    assert dt.min() > 20.0
    jout, jcache = j_ssm.ssd_apply(jp, jnp.asarray(x), jcfg, chunk=8)
    tout, tcache = ssm.ssd_apply(tp, torch.as_tensor(x), tcfg, chunk=8)
    _close(tout, jout, what="out")
    _close_trees(tcache, jcache, what="cache")


def test_ssd_forward_matches_the_recurrence_over_a_long_chunk():
    """The reduced mamba2 over 300 positions (a 256-position chunk, then a
    padded one): the forward's logits at every position against prefill
    of the first token and 299 chained decode steps, a recurrence with no
    cumulative sums.  Within the long chunk |cum| reaches ~3e3, and the
    JAX module's float32 differences ``cum_i - cum_j`` fail this (2.9e-4
    apart); the port's segment sum (``models/ssm.py``) measured 4.1e-6."""
    from repro_torch.models import model_decode, model_forward, model_init, model_prefill

    _, cfg = _configs("mamba2-2.7b")
    params = model_init(0, cfg, device="cpu")
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, (B, 300)).astype(np.int32)
    toks = torch.as_tensor(toks)
    want = model_forward(params, {"tokens": toks}, cfg)[0]
    _, caches = model_prefill(params, {"tokens": toks[:, :1]}, cfg)
    for t in range(1, toks.shape[1]):
        got, _ = model_decode(params, toks[:, t : t + 1], caches, t, cfg)
        _close(got, want[:, t], what=f"position {t}")


def test_ssd_forward_matches_jax_over_a_long_chunk():
    """The reduced mamba2 over 300 positions (a 256-position chunk, then a
    padded one), the JAX package's weights on both sides: every position's
    logits within ATOL.  Here the two forms of ``cum_i - cum_j`` part most
    (the JAX module's difference of float32 cumulative sums, the port's
    segment sum): measured 9.0e-5 of ``atol + rtol * |want|``."""
    from repro.models import model_forward as j_forward
    from repro.models import model_init as j_init

    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.models import model_forward

    jcfg, tcfg = _configs("mamba2-2.7b")
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_arrays(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(0).integers(1, jcfg.vocab_size, (B, 300)).astype(np.int32)
    want = j_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)[0]
    got = model_forward(tp, {"tokens": torch.as_tensor(toks)}, tcfg)[0]
    _close(got, want, what="logits over 300 positions")


def _f64_recurrence(tp, tcfg, toks):
    """Every position's logits from the port's own decode recurrence run in
    float64: the weights and the zero caches in float64 and every
    ``.float()`` of the model code a float64 cast, stepping from position 0
    (no chunked scan, no cumulative sums)."""
    from unittest import mock

    from repro_torch.models import model_caches, model_decode

    cfg = dataclasses.replace(tcfg, dtype=torch.float64)
    params = tree_map(lambda t: t.double(), tp)
    caches = model_caches(cfg, toks.shape[0], toks.shape[1], device="cpu")
    caches = tree_map(lambda t: t.double(), caches)
    out = []
    with mock.patch.object(torch.Tensor, "float", lambda self: self.to(torch.float64)):
        for t in range(toks.shape[1]):
            logits, _ = model_decode(params, toks[:, t : t + 1], caches, t, cfg)
            assert logits.dtype == torch.float64
            out.append(logits)
    return torch.stack(out, 1)


@pytest.mark.parametrize("length", [512, 1024])
def test_ssd_forward_holds_the_float64_recurrence_past_a_chunk(length):
    """The reduced mamba2 over 512 and 1,024 positions (two and four
    256-position chunks), the JAX package's weights: the port's forward is
    within ATOL of a float64 run of its own decode recurrence (measured
    1.5e-5 at both lengths), and the JAX package's forward is farther from
    it than the port's.  The JAX module's difference of float32 cumulative
    sums drifts with the length (1.1e-4 at 300, 1.5e-4 at 512, 2.0e-4 at
    1,024 from the float64 run), so past 300 positions the port and JAX
    part by more than ATOL (1.28 x ATOL at 512): the float64 recurrence,
    not JAX, is the reference there."""
    from repro.models import model_forward as j_forward
    from repro.models import model_init as j_init

    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.models import model_forward

    jcfg, tcfg = _configs("mamba2-2.7b")
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_arrays(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = np.random.default_rng(0).integers(1, jcfg.vocab_size, (B, length)).astype(np.int32)
    exact = _np(_f64_recurrence(tp, tcfg, torch.as_tensor(toks)))
    got = _np(model_forward(tp, {"tokens": torch.as_tensor(toks)}, tcfg)[0])
    want = np.asarray(j_forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)[0])
    _close(got, exact, what=f"the port over {length} positions against the float64 recurrence")
    port_gap, jax_gap = np.abs(got - exact).max(), np.abs(want - exact).max()
    print(f"{length} positions: port {port_gap:.3g}, JAX {jax_gap:.3g} from float64; "
          f"port - JAX {np.abs(got - want).max():.3g}")  # fmt: skip
    assert jax_gap > port_gap


def _chained_decode(j_decode, t_decode, jcache, tcache, jp, tp, jcfg, tcfg, xs):
    """Steps through both packages' decode; the port's cache tensors stay
    the same objects at the same addresses and hold JAX's new caches."""
    ptrs = [t.data_ptr() for t in tree_leaves(tcache)]
    for i, x in enumerate(xs):
        jout, jcache = j_decode(jp, jnp.asarray(x), jcache, jcfg)
        tout, returned = t_decode(tp, torch.as_tensor(x), tcache, tcfg)
        assert returned is tcache, i
        assert [t.data_ptr() for t in tree_leaves(tcache)] == ptrs, i
        _close(tout, jout, what=f"step {i} out")
        _close_trees(tcache, jcache, what=f"step {i} cache")


def test_ssd_decode_chained_in_place_matches_jax():
    jcfg, tcfg, jp, tp = _ssd(6)
    rng = np.random.default_rng(7)
    x = _x(rng, B, 9, jcfg.d_model)
    # start from the state a prefill leaves
    _, jcache = j_ssm.ssd_apply(jp, jnp.asarray(x), jcfg, chunk=4)
    tcache = tree_map(lambda a: a.clone(), ssm.ssd_apply(tp, torch.as_tensor(x), tcfg, chunk=4)[1])
    _close_trees(tcache, jcache, what="prefill")
    xs = [_x(rng, B, 1, jcfg.d_model) for _ in range(4)]
    _chained_decode(j_ssm.ssd_decode, ssm.ssd_decode, jcache, tcache, jp, tp, jcfg, tcfg, xs)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _rglru(seed):
    jcfg, tcfg = _configs("recurrentgemma-2b")
    jp = j_rglru.rglru_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, _port(jp)


def test_rglru_apply_matches_jax_and_a_sequential_loop():
    """300 positions: the doubling scan takes 9 passes."""
    jcfg, tcfg, jp, tp = _rglru(0)
    rng = np.random.default_rng(1)
    x = _x(rng, B, 300, jcfg.d_model)
    h0 = _x(rng, B, jcfg.lru_width)
    jout, jcache = j_rglru.rglru_apply(jp, jnp.asarray(x), jcfg, initial_state=jnp.asarray(h0))
    tx, th0 = torch.as_tensor(x), torch.as_tensor(h0)
    tout, tcache = rglru.rglru_apply(tp, tx, tcfg, initial_state=th0)
    _close(tout, jout, what="out")
    _close_trees(tcache, jcache, what="cache")
    # the recurrence one position at a time, on the port's own gates
    xc, _ = ssm._causal_conv(tx @ tp["w_x"], tp["conv"])
    a, b = rglru._gates(tp, xc)
    h, hs = th0, []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    seq = torch.stack(hs, 1)
    _close(rglru._scan(a, torch.cat([(b[:, 0] + a[:, 0] * th0)[:, None], b[:, 1:]], 1)), seq,
           1e-5, "scan")  # fmt: skip
    _close(tcache["h"], seq[:, -1], 1e-5, "h")


def test_rglru_apply_gradients_match_jax():
    jcfg, tcfg, jp, tp = _rglru(2)
    rng = np.random.default_rng(3)
    x, h0 = _x(rng, B, 37, jcfg.d_model), _x(rng, B, jcfg.lru_width)
    wy = _x(rng, B, 37, jcfg.d_model)

    def jloss(p, x, h0):
        out, cache = j_rglru.rglru_apply(p, x, jcfg, initial_state=h0)
        return (out * wy).sum() + cache["h"].sum()

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(x), jnp.asarray(h0))
    leaves = [*tree_leaves(tp), torch.as_tensor(x), torch.as_tensor(h0)]
    for t in leaves:
        t.requires_grad_(True)
    out, cache = rglru.rglru_apply(tp, leaves[-2], tcfg, initial_state=leaves[-1])
    tl = (out * torch.as_tensor(wy)).sum() + cache["h"].sum()
    grads = torch.autograd.grad(tl, leaves)
    _close(tl, jl, what="loss")
    want = [*jax.tree.leaves(jg[0]), jg[1], jg[2]]
    got = dict(zip(tp, grads))
    for name, w in zip(sorted(tp), want):
        _close(got[name], w, what=f"d{name}")
    _close(grads[-2], want[-2], what="dx")
    _close(grads[-1], want[-1], what="dh0")


def test_rglru_decode_chained_in_place_matches_jax():
    jcfg, tcfg, jp, tp = _rglru(4)
    rng = np.random.default_rng(5)
    x = _x(rng, B, 11, jcfg.d_model)
    _, jcache = j_rglru.rglru_apply(jp, jnp.asarray(x), jcfg)
    tcache = tree_map(lambda a: a.clone(), rglru.rglru_apply(tp, torch.as_tensor(x), tcfg)[1])
    _close_trees(tcache, jcache, what="prefill")
    xs = [_x(rng, B, 1, jcfg.d_model) for _ in range(4)]
    _chained_decode(j_rglru.rglru_decode, rglru.rglru_decode, jcache, tcache, jp, tp, jcfg, tcfg,
                    xs)  # fmt: skip


# ---------------------------------------------------------------------------
# encoder-decoder
# ---------------------------------------------------------------------------


def _whisper(seed, **change):
    jcfg, tcfg = _configs("whisper-tiny", **change)
    jp = j_encdec.encdec_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, _port(jp)


def test_encode_matches_jax():
    """More frames than the position table holds: positions wrap."""
    jcfg, tcfg, jp, tp = _whisper(0, max_pos=32)
    frames = _x(np.random.default_rng(1), B, 45, jcfg.d_model)
    want = j_encdec.encode(jp, jnp.asarray(frames), jcfg)
    _close(encdec.encode(tp, torch.as_tensor(frames), tcfg), want)


@pytest.mark.parametrize("heads,kv_heads", [(2, 2), (4, 2), (4, 1)])
def test_encdec_decode_chained_matches_jax(heads, kv_heads):
    """Prefill, then 4 decode steps, the last two past the position table
    (``dec_pos`` clamped to its last row); with grouped heads the cross K/V
    are repeated over the group.  The self caches are written in place and
    the cross caches left as they are."""
    jcfg, tcfg, jp, tp = _whisper(2, n_heads=heads, n_kv_heads=kv_heads, head_dim=16, max_pos=12)
    rng = np.random.default_rng(3)
    S, Se, steps = 10, 13, 4
    frames = _x(rng, B, Se, jcfg.d_model)
    toks = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    jl, jcache = j_encdec.encdec_prefill(jp, jnp.asarray(frames), jnp.asarray(toks), jcfg)
    tl, tpre = encdec.encdec_prefill(tp, torch.as_tensor(frames), torch.as_tensor(toks), tcfg)
    _close(tl, jl, what="prefill logits")
    _close_trees(tpre, jcache, what="prefill cache")
    jcache = jax.tree.map(
        lambda g, t: jnp.pad(g, [(0, b - a) for a, b in zip(g.shape, t.shape)]),
        jcache, j_encdec.init_decoder_caches(jcfg, B, S + steps, Se),
    )  # fmt: skip
    tcache = encdec.init_decoder_caches(tcfg, B, S + steps, Se)
    tree_map(lambda g, t: t[tuple(slice(0, n) for n in g.shape)].copy_(g), tpre, tcache)
    cross = tree_map(lambda t: t.clone(), tcache["cross"])
    ptrs = [t.data_ptr() for t in tree_leaves(tcache)]
    for i in range(steps):
        tok = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jcache = j_encdec.encdec_decode_step(jp, jnp.asarray(tok), jcache, jnp.int32(S + i),
                                                 jcfg)  # fmt: skip
        tl, returned = encdec.encdec_decode_step(tp, torch.as_tensor(tok), tcache, S + i, tcfg)
        assert returned is tcache and [t.data_ptr() for t in tree_leaves(tcache)] == ptrs
        _close(tl, jl, what=f"step {i} logits")
        _close_trees(tcache, jcache, what=f"step {i} cache")
    tree_map(lambda a, b: torch.equal(a, b) or pytest.fail("cross cache changed"),
             tcache["cross"], cross)  # fmt: skip
