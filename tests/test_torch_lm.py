"""The port's LM serving path (``repro_torch.models``, ``configs``, ``train``)
against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through both packages; the
port gets the JAX package's weights through
``repro_torch.convert.lm_params_from_arrays``.  Covered: chunked attention
on the flash grid, single-token decode against a linear and a ring cache,
forward / prefill (logits and every cache leaf) / decode for the reduced
configs of the five dense decoders (and a windowed variant), of the MoE
decoders (mixtral: sliding window + MoE; deepseek: MLA + MoE with shared
experts) and of the recurrent and encoder-decoder models (mamba2: SSD;
recurrentgemma: RG-LRU + local attention; whisper), greedy tokens,
``moe_apply`` with tokens dropped, tied router probabilities and the
virtual expert split, ``mla_decode`` at every kind of cache slot, the
decode-matches-forward equivalence inside the port, bfloat16 trees carried
across bit for bit, and every config's fields and parameter count.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import (  # noqa: E402
    model_caches as j_caches,
    model_decode as j_decode,
    model_forward as j_forward,
    model_init as j_init,
    model_prefill as j_prefill,
)
from repro.models.attention import attention_decode as j_attention_decode  # noqa: E402
from repro.models.attention import attn_init as j_attn_init  # noqa: E402
from repro.models.attention import chunked_attention as j_chunked_attention  # noqa: E402
from repro.models.mla import mla_decode as j_mla_decode  # noqa: E402
from repro.models.mla import mla_init as j_mla_init  # noqa: E402
from repro.models.moe import moe_apply as j_moe_apply  # noqa: E402
from repro.models.moe import moe_init as j_moe_init  # noqa: E402
from repro.train import make_decode_step as j_make_decode_step  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import (  # noqa: E402
    init_params_shape,
    model_caches,
    model_decode,
    model_forward,
    model_init,
    model_prefill,
)
from repro_torch.models.attention import attention_decode, chunked_attention  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.mla import mla_decode  # noqa: E402
from repro_torch.models.moe import _dispatch, _route, moe_apply  # noqa: E402
from repro_torch.models.module import DecoderLM  # noqa: E402
from repro_torch.train import make_decode_step  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

#: float32 on both sides: the two frameworks' CPU matmuls sum in other
#: orders and their exp / rsqrt may differ in the last place; the gap
#: measured on logits of magnitude ~4 is below 6e-6
ATOL = RTOL = 1e-4
#: one attention call (no stacked layers): sums of 16-wide products
ATTN_TOL = 1e-5
#: the JAX package's own decode-matches-forward tolerance
#: (tests/test_models.py::test_decode_matches_forward)
EQUIV_TOL = 2e-3

DENSE = ["llama3.2-1b", "qwen1.5-0.5b", "phi3-mini-3.8b", "yi-34b", "internvl2-1b"]
#: the MoE decoders: mixtral (sliding window + MoE), deepseek (MLA + MoE)
MOE = ["deepseek-v2-236b", "mixtral-8x22b"]
#: mamba2 (SSD), recurrentgemma (RG-LRU + local attention whose window the
#: prompt overruns) and whisper (encoder-decoder)
RECURRENT = ["mamba2-2.7b", "recurrentgemma-2b", "whisper-tiny"]
#: the dense decoders, plus llama's reduced config with windowed ('local')
#: layers whose window the prompt overruns, so the ring cache wraps, the
#: MoE decoders and the recurrent and encoder-decoder models
CASES = DENSE + ["llama3.2-1b/local"] + MOE + RECURRENT
B, S = 2, 24
#: chained decode steps after a prefill: the recurrent state and the ring
#: caches are written in place, so a step that returned fresh tensors would
#: pass one step and fail the next
STEPS = 3


def _configs(case):
    """(JAX config, port config) of a case."""
    arch, _, variant = case.partition("/")
    jcfg, tcfg = jconfigs.reduced_config(arch), tconfigs.reduced_config(arch)
    if variant == "local":
        change = dict(segments=((("local+mlp",), 2),), window=8, name=case)
        jcfg, tcfg = dataclasses.replace(jcfg, **change), dataclasses.replace(tcfg, **change)
    return jcfg, tcfg


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=ATOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol, err_msg=what)


def _batch(cfg, rng, seq=S):
    """The same batch for both packages: (JAX batch, port batch).  The
    encoder-decoder gets ``seq`` frames."""
    toks = rng.integers(1, cfg.vocab_size, (B, seq)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}
    if cfg.frontend == "vision":
        prefix = rng.standard_normal((B, cfg.num_prefix, cfg.d_model)).astype(np.float32)
        jb["prefix"], tb["prefix"] = jnp.asarray(prefix), torch.as_tensor(prefix)
    if cfg.is_encoder_decoder:
        frames = rng.standard_normal((B, seq, cfg.d_model)).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(frames), torch.as_tensor(frames)
    return jb, tb


def _prefix_len(cfg):
    return cfg.num_prefix if cfg.frontend == "vision" else 0


def _pad_jax(caches, target):
    return jax.tree.map(
        lambda got, tgt: jnp.pad(got, [(0, t - g) for g, t in zip(got.shape, tgt.shape)]),
        caches,
        target,
    )


def _pad_port(caches, target):
    def into(got, tgt):
        tgt[tuple(slice(0, n) for n in got.shape)] = got
        return tgt

    return tree_map(into, caches, target)


@pytest.fixture(scope="module", params=CASES)
def model(request):
    """A case's configs and the JAX package's weights on both sides."""
    jcfg, tcfg = _configs(request.param)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    tparams = lm_params_from_arrays(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return request.param, jcfg, tcfg, jparams, tparams


# ---------------------------------------------------------------------------
# attention
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
        # grouped queries: 6 and 4 query heads over 2 KV heads
        (True, None, 32, 32, 96, 6, 2),
        (True, 24, 16, 48, 120, 4, 2),
    ],
)
def test_chunked_attention_matches_jax(causal, window, qc, kc, seq, heads, kv_heads):
    rng = np.random.default_rng(0)
    D = 16
    q = rng.standard_normal((2, seq, heads, D)).astype(np.float32)
    k, v = (rng.standard_normal((2, seq, kv_heads, D)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc)
    want = j_chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = chunked_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), **kw)
    _close(got, want, ATTN_TOL)


@pytest.mark.parametrize(
    "window,length,pos",
    [
        (None, 12, 5),  # linear cache, part full
        (None, 12, 20),  # linear cache past its end: the last slot is rewritten
        (8, 8, 5),  # ring cache, not yet wrapped
        (8, 8, 13),  # ring cache that has wrapped
    ],
)
def test_attention_decode_matches_jax(window, length, pos):
    jcfg, tcfg = _configs("llama3.2-1b")  # 4 query heads over 2 KV heads
    rng = np.random.default_rng(1)
    jp = j_attn_init(jax.random.PRNGKey(1), jcfg)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, jp))
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    shape = (B, length, jcfg.n_kv_heads, jcfg.head_dim)
    cache = {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
    jout, jcache = j_attention_decode(
        jp, jnp.asarray(x), tree_map(jnp.asarray, cache), jnp.int32(pos), jcfg, window=window
    )
    tcache = tree_map(torch.as_tensor, cache)
    tout, tcache2 = attention_decode(tp, torch.as_tensor(x), tcache, pos, tcfg, window=window)
    assert tcache2 is tcache  # updated in place
    _close(tout, jout, ATTN_TOL)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], ATTN_TOL, name)


# ---------------------------------------------------------------------------
# MoE and MLA
# ---------------------------------------------------------------------------

#: aux is one float32 sum over E experts of (mean probability x share)
AUX_TOL = 1e-5


@pytest.mark.parametrize(
    "arch,change,zero_router",
    [
        # capacity below the load: tokens drop, and the stable dispatch
        # sort decides which
        ("deepseek-v2-236b", dict(capacity_factor=0.25), False),
        ("deepseek-v2-236b", dict(capacity_factor=1.0), False),
        ("deepseek-v2-236b", dict(capacity_factor=1.0, n_shared_experts=0), False),
        ("mixtral-8x22b", dict(capacity_factor=0.25), False),
        ("mixtral-8x22b", dict(capacity_factor=1.0), False),
        # every expert cut into 2 virtual experts, as the full config
        ("mixtral-8x22b", dict(moe_virtual_split=2), False),
        ("mixtral-8x22b", dict(moe_virtual_split=2, capacity_factor=0.25), False),
        # a zero router: every probability ties, top-k takes the lowest ids
        ("deepseek-v2-236b", dict(capacity_factor=1.0), True),
        ("mixtral-8x22b", dict(moe_virtual_split=2, capacity_factor=1.0), True),
    ],
)
def test_moe_apply_matches_jax(arch, change, zero_router):
    jcfg = dataclasses.replace(jconfigs.reduced_config(arch), **change)
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch), **change)
    jp = j_moe_init(jax.random.PRNGKey(5), jcfg)
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(5).standard_normal((B, 12, jcfg.d_model)).astype(np.float32)
    jout, jaux = j_moe_apply(jp, jnp.asarray(x), jcfg)
    tout, taux = moe_apply(tp, torch.as_tensor(x), tcfg)
    _close(tout, jout, what=f"{arch} {change}")
    _close(taux, jaux, AUX_TOL, "aux")
    # the case does what it says: drops where the capacity is short, none
    # at the reduced configs' own factor of 8
    T, E = B * 12, tcfg.n_experts * tcfg.moe_virtual_split
    idx, _, _ = _route(tp, torch.as_tensor(x).reshape(T, -1), tcfg)
    cap = int((T * idx.shape[1] / E) * tcfg.capacity_factor) + 1
    dropped = int((~_dispatch(idx, T, E, cap)[2]).sum())
    assert dropped > 0 if tcfg.capacity_factor <= 1.0 else dropped == 0, dropped
    if zero_router:
        assert (idx == torch.arange(idx.shape[1])).all()


@pytest.mark.parametrize("length,pos", [(12, 0), (12, 5), (12, 11), (12, 14)])
def test_mla_decode_matches_jax(length, pos):
    """An empty cache, a part-full one, the last slot, and past the end (the
    slot clamped to L - 1 and rewritten)."""
    jcfg, tcfg = _configs("deepseek-v2-236b")
    rng = np.random.default_rng(1)
    jp = j_mla_init(jax.random.PRNGKey(1), jcfg)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, jp))
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    width = jcfg.kv_lora_rank + jcfg.qk_rope_dim
    cache = rng.standard_normal((B, length, width)).astype(np.float32)
    jout, jcache = j_mla_decode(jp, jnp.asarray(x), {"ckv": jnp.asarray(cache)}, jnp.int32(pos),
                                jcfg)  # fmt: skip
    tcache = {"ckv": torch.as_tensor(cache)}
    tout, tcache2 = mla_decode(tp, torch.as_tensor(x), tcache, pos, tcfg)
    assert tcache2 is tcache  # updated in place
    _close(tout, jout, ATTN_TOL)
    _close(tcache["ckv"], jcache["ckv"], ATTN_TOL, "ckv")


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def test_model_matches_jax(model):
    """forward, prefill (logits and every cache leaf) and STEPS chained
    decode steps, the port's caches written in place."""
    case, jcfg, tcfg, jparams, tparams = model
    jb, tb = _batch(jcfg, np.random.default_rng(2))
    _close(model_forward(tparams, tb, tcfg)[0], j_forward(jparams, jb, jcfg)[0], what=case)

    jlogits, jcache = j_prefill(jparams, jb, jcfg)
    tlogits, tcache = model_prefill(tparams, tb, tcfg)
    _close(tlogits, jlogits, what=case)
    tree_map(lambda t, j: _close(t, j, what=f"{case} prefill cache"), tcache,
             jax.tree.map(np.asarray, jcache))  # fmt: skip

    pos = S + _prefix_len(jcfg)
    jcache = _pad_jax(jcache, j_caches(jcfg, B, pos + 4, enc_len=S))
    tcache = _pad_port(tcache, model_caches(tcfg, B, pos + 4, enc_len=S, device="cpu"))
    ptrs = [t.data_ptr() for t in tree_leaves(tcache)]
    rng = np.random.default_rng(3)
    for i in range(STEPS):
        tok = rng.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
        jlogits, jcache = j_decode(jparams, jnp.asarray(tok), jcache, jnp.int32(pos + i), jcfg)
        tlogits, returned = model_decode(tparams, torch.as_tensor(tok), tcache, pos + i, tcfg)
        assert returned is tcache and [t.data_ptr() for t in tree_leaves(tcache)] == ptrs
        _close(tlogits, jlogits, what=f"{case} step {i}")
        tree_map(lambda t, j: _close(t, j, what=f"{case} step {i} decode cache"), tcache,
                 jax.tree.map(np.asarray, jcache))  # fmt: skip


def test_greedy_tokens_match_jax(model):
    """Prefill, then greedy decode through both packages' decode steps: the
    same tokens."""
    case, jcfg, tcfg, jparams, tparams = model
    new_tokens, prompt = 6, 8
    jb, tb = _batch(jcfg, np.random.default_rng(4), seq=prompt)
    pos = prompt + _prefix_len(jcfg)
    max_len = pos + new_tokens

    jlogits, jcache = j_prefill(jparams, jb, jcfg)
    jcache = _pad_jax(jcache, j_caches(jcfg, B, max_len, enc_len=prompt))
    jstep = jax.jit(j_make_decode_step(jcfg))
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)[:, None]
    tlogits, tcache = model_prefill(tparams, tb, tcfg)
    tcache = _pad_port(tcache, model_caches(tcfg, B, max_len, enc_len=prompt, device="cpu"))
    tstep = make_decode_step(tcfg)
    ttok = torch.argmax(tlogits, -1).to(torch.int32)[:, None]
    jseq, tseq = [jtok], [ttok]
    for i in range(new_tokens - 1):
        jtok, _, jcache = jstep(jparams, {"token": jtok, "cache_len": jnp.int32(pos + i)}, jcache)
        ttok, _, tcache = tstep(tparams, {"token": ttok, "cache_len": pos + i}, tcache)
        jtok, ttok = jtok[:, None], ttok[:, None]
        jseq.append(jtok)
        tseq.append(ttok)
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(
        torch.cat(tseq, 1).numpy(), np.concatenate([np.asarray(t) for t in jseq], 1), case
    )


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_forward_in_port(case):
    """tests/test_models.py::test_decode_matches_forward on the port alone,
    with its own weights: forward's logits at each of the last STEPS
    positions equal prefill of the tokens before them followed by chained
    decode steps."""
    _, cfg = _configs(case)
    params = model_init(2, cfg, device="cpu")
    _, batch = _batch(cfg, np.random.default_rng(2))
    toks = batch["tokens"]
    want = model_forward(params, batch, cfg)[0]
    first = S - STEPS
    _, caches = model_prefill(params, dict(batch, tokens=toks[:, :first]), cfg)
    prefix = _prefix_len(cfg)
    caches = _pad_port(caches, model_caches(cfg, B, S + prefix + 4, enc_len=S, device="cpu"))
    for t in range(first, S):
        got, _ = model_decode(params, toks[:, t : t + 1], caches, t + prefix, cfg)
        _close(got, want[:, t], EQUIV_TOL, f"{case} position {t}")


@pytest.mark.parametrize(
    "arch,weight",
    [("internvl2-1b", "tree.segments.0.pos0.attn.wq"),
     ("whisper-tiny", "tree.dec_layers.cross_attn.wk")],
)  # fmt: skip
def test_decoder_module_matches_functions(arch, weight):
    _, cfg = _configs(arch)
    lm = DecoderLM.init(5, cfg, device="cpu")
    params = model_init(5, cfg, device="cpu")
    tree_map(lambda a, b: torch.equal(a, b) or pytest.fail("weights differ"), lm.params(), params)
    assert weight in lm.state_dict()
    assert sum(p.numel() for p in lm.parameters()) == cfg.param_count()
    _, batch = _batch(cfg, np.random.default_rng(6))
    assert torch.equal(lm(batch)[0], model_forward(params, batch, cfg)[0])
    logits, caches = lm.prefill(batch)
    # the encoder-decoder's cross caches hold the S frames' K/V
    caches = _pad_port(caches, lm.caches(B, S + cfg.num_prefix + 1, enc_len=S))
    want, _ = model_prefill(params, batch, cfg)
    assert torch.equal(logits, want)
    tok = torch.argmax(logits, -1)[:, None]
    got, _ = lm.decode(tok, caches, S + cfg.num_prefix)
    assert torch.isfinite(got).all() and got.shape == (B, cfg.vocab_padded)


# ---------------------------------------------------------------------------
# weights carried across, configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", *RECURRENT])  # qwen: QKV biases too
def test_bf16_tree_carried_bitwise(arch):
    jcfg, tcfg = _configs(arch)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    arrays = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(7), jcfg))
    tparams = lm_params_from_arrays(arrays, tcfg, "cpu")
    dtypes = set()

    def same_bits(t, a):
        dtypes.add(a.dtype.name)
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)

    tree_map(same_bits, tparams, arrays)
    assert dtypes == {"bfloat16", "float32"}  # weights bf16, norms f32


def test_convert_rejects_a_tree_of_another_config():
    jcfg, _ = _configs("llama3.2-1b")
    arrays = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), jcfg))
    _, qwen = _configs("qwen1.5-0.5b")  # biases llama's tree lacks
    with pytest.raises(ValueError, match="keys differ"):
        lm_params_from_arrays(arrays, qwen, "cpu")
    wide = dataclasses.replace(_configs("llama3.2-1b")[1], d_ff=256)
    with pytest.raises(ValueError, match="where the config has"):
        lm_params_from_arrays(arrays, wide, "cpu")


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    dt = out.pop("dtype")
    out["dtype"] = str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else np.dtype(dt).name
    return out


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_fields_match_jax(arch):
    for get in ("get_config", "reduced_config"):
        jcfg, tcfg = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert _fields(tcfg) == _fields(jcfg), (arch, get)
        assert tcfg.layer_kinds == jcfg.layer_kinds
        assert tcfg.vocab_padded == jcfg.vocab_padded
    # the docstring, and with it the source line, travels with the config
    assert tconfigs._MODULES[arch].__doc__ == jconfigs._MODULES[arch].__doc__


def test_config_registry_matches_jax():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()
    }
    for arch in jconfigs.ARCH_IDS:
        for shape in jconfigs.SHAPES:
            assert tconfigs.shape_applicable(tconfigs.get_config(arch), shape) == (
                jconfigs.shape_applicable(jconfigs.get_config(arch), shape)
            )
    with pytest.raises(ValueError, match="unknown arch"):
        tconfigs.get_config("gpt-2")


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_count_from_shapes_matches_jax(arch):
    """At the published widths, on the meta device: nothing is allocated."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert all(t.device.type == "meta" for t in tree_leaves(init_params_shape(tcfg)))


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a CUDA device")


def test_default_device_raises_without_gpu(no_cuda):
    cfg = tconfigs.reduced_config("llama3.2-1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_init(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_caches(cfg, B, S)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_port" / "serve_lm.py"), "--batch", "1"],
        capture_output=True, text=True, env=env, timeout=300,
    )  # fmt: skip
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr


# ---------------------------------------------------------------------------
# the example twin
# ---------------------------------------------------------------------------

#: the flags tests/test_examples.py runs examples/serve_lm.py with
TINY = ["--batch", "1", "--prompt-len", "4", "--new-tokens", "2"]


def _shape_of_output(text):
    """The printed lines with timings and token values stripped."""
    text = re.sub(r"in \d+\.\d+s", "in Ts", text)
    text = re.sub(r"\(\d+\.\d+ tok/s\)", "(R tok/s)", text)
    return re.sub(r"\[[\d, ]+\]", lambda m: f"[{len(m.group(0).split(','))} tokens]", text)


@pytest.mark.parametrize("arch", ["llama3.2-1b", *MOE, *RECURRENT])
def test_serve_lm_twin_prints_what_the_jax_example_prints(arch):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")

    def run(script, *extra):
        proc = subprocess.run(
            [sys.executable, str(REPO / script), *TINY, *extra],
            capture_output=True, text=True, env=env, timeout=600, cwd=REPO,
        )  # fmt: skip
        assert proc.returncode == 0, proc.stderr[-2000:]
        return proc.stdout

    want = run("examples/serve_lm.py", "--arch", arch)
    got = run("examples/torch_port/serve_lm.py", "--arch", arch, "--device", "cpu")
    assert _shape_of_output(got) == _shape_of_output(want)
    assert "seq 0: [2 tokens]" in _shape_of_output(got)
