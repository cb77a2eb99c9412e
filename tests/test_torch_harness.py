"""The port's LM training harness (``repro_torch.data``, ``checkpoint``,
``runtime``) against the JAX package's, on the CPU.

* the walk corpus: batches, token streams and skip-gram pairs bitwise the
  JAX package's, across a cursor resume and an epoch wrap;
* checkpoints: round trip of a bf16 + float32 + 0-d int32 tree, committed
  steps only, retention, the snapshot taken at ``save_async`` time; and
  the on-disk format shared with ``repro.checkpoint`` — the same manifest
  text and ``.npy`` bytes for the same tree, and a checkpoint written by
  either package restores bitwise in the other (float32 and bf16 trees
  with the optimiser state);
* the runtime: the straggler watchdog and the failure injector as the JAX
  ones; crash -> restart bitwise equal to an uninterrupted run; and the
  port's ``ResilientTrainer`` against the JAX one for 6 steps from the
  same weights and batches (tolerances below).
"""

import dataclasses
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro import runtime as jruntime  # noqa: E402
from repro.models import model_init as j_init  # noqa: E402
from repro.train import make_train_step as j_make_train_step  # noqa: E402

from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch import runtime as truntime  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt_mod  # noqa: E402
from repro_torch.convert import lm_params_from_arrays  # noqa: E402
from repro_torch.models import model_init  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

#: the port's trainer against the JAX one, float32 on both sides:
#: tests/test_torch_train.py's tolerances for one train step — losses
#: atol = rtol 1e-4 (the frameworks' CPU sums in other orders), parameters
#: atol = rtol 3e-4 (Adam's ``g / (|g| + eps)`` on near-zero gradients)
LOSS_TOL = 1e-4
STEP_TOL = 3e-4


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _np(x):
    """A leaf of either package as numpy, bf16 as its raw uint16 lanes (so
    comparisons are bitwise)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _bitwise(got: dict, want: dict):
    """Two ``{key: leaf}`` maps: the same keys, each leaf the same dtype,
    shape and bits."""
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = _np(got[key]), _np(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


def _jflat(tree):
    return jckpt.ckpt._flatten(tree)


def _tflat(tree):
    return tckpt_mod._flatten(tree)


def _walks(seed=0, n=40, length=9, vertices=50):
    """Walks with early terminations (-1 padding), as the engines record."""
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, vertices, (n, length + 1)).astype(np.int32)
    for i, stop in enumerate(rng.integers(1, length + 2, n)):
        walks[i, stop:] = -1
    return walks


# ---------------------------------------------------------------------------
# (a) the walk corpus
# ---------------------------------------------------------------------------


def test_data_exports_bos_offset_beyond_corpus_all():
    assert tdata.BOS_OFFSET == jdata.BOS_OFFSET == 1
    assert "BOS_OFFSET" in tdata.__all__
    assert "BOS_OFFSET" not in tdata.corpus.__all__
    assert tdata.corpus.__all__ == jdata.corpus.__all__


def _batch_list(corpus, n, **kw):
    it = corpus.batches(4, 16, **kw)
    return [next(it) for _ in range(n)]


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["cursor", "epoch", "labels", "tokens"]
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
        assert (g["cursor"], g["epoch"]) == (w["cursor"], w["epoch"])
        assert type(g["cursor"]) is type(w["cursor"])


@pytest.mark.parametrize("seed", [0, 7])
def test_corpus_batches_match_jax_across_resume_and_epoch_wrap(seed):
    walks = _walks(seed)
    tc, jc = tdata.WalkCorpus.from_walks(walks, 50), jdata.WalkCorpus.from_walks(walks, 50)
    assert tc.vocab_size == jc.vocab_size == 51 and len(tc) == len(jc) == 40
    np.testing.assert_array_equal(tc.walks, jc.walks)
    got, want = _batch_list(tc, 40, seed=seed), _batch_list(jc, 40, seed=seed)
    _same_batches(got, want)
    assert max(b["epoch"] for b in want) >= 2  # the order was redrawn twice
    # resume at a batch's cursor, mid-epoch, as the trainer does
    mid = next(b for b in want if b["epoch"] == 0 and b["cursor"] > 10)["cursor"]
    _same_batches(_batch_list(tc, 12, cursor=mid, seed=seed),
                  _batch_list(jc, 12, cursor=mid, seed=seed))  # fmt: skip
    # finite epochs end both iterators at the same batch
    _same_batches(list(tc.batches(4, 16, epochs=2, seed=seed)),
                  list(jc.batches(4, 16, epochs=2, seed=seed)))  # fmt: skip


def test_token_stream_and_skipgram_pairs_match_jax():
    walks = _walks(3)
    tc, jc = tdata.WalkCorpus.from_walks(walks, 50), jdata.WalkCorpus.from_walks(walks, 50)
    for cursor in (0, 17):
        got, want = list(tc.token_stream(cursor)), list(jc.token_stream(cursor))
        assert len(got) == len(want) == 40 - cursor
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for kw in ({}, {"window": 2, "seed": 5}, {"window": 3, "max_pairs": 100, "seed": 1}):
        for g, w in zip(tdata.skipgram_pairs(walks, **kw), jdata.skipgram_pairs(walks, **kw)):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# (b) checkpoints in the port
# ---------------------------------------------------------------------------


def _tree():
    return {
        "a": torch.arange(12.0).reshape(3, 4),
        "nested": {
            "b": torch.linspace(-2, 3, 6, dtype=torch.bfloat16).reshape(2, 3),
            "step": torch.tensor(7, dtype=torch.int32),
        },
        "seq": [torch.ones(2), torch.full((1, 2), -0.5)],
    }


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    tckpt.save_checkpoint(tmp_path, 3, t, extra={"cursor": 42})
    assert tckpt.latest_step(tmp_path) == 3
    manifest = json.loads((tmp_path / "step_000000003" / "manifest.json").read_text())
    assert {k: (v["shape"], v["dtype"]) for k, v in manifest["arrays"].items()} == {
        "a": ([3, 4], "float32"), "nested/b": ([2, 3], "bfloat16"),
        "nested/step": ([], "int32"), "seq/0": ([2], "float32"), "seq/1": ([1, 2], "float32"),
    }  # fmt: skip
    like = tree_map(torch.zeros_like, t)
    got, extra = tckpt.restore_checkpoint(tmp_path, like)
    assert extra == {"cursor": 42}
    assert isinstance(got["seq"], list)
    _bitwise(_tflat(got), _tflat(t))
    assert got["nested"]["step"].shape == ()


def test_restore_keeps_missing_keys_skips_unknown_and_takes_devices(tmp_path):
    t = _tree()
    tckpt.save_checkpoint(tmp_path, 1, {"a": t["a"], "gone": torch.ones(3)})
    like = {"a": torch.zeros(3, 4), "new": torch.full((2,), 5.0)}
    got, extra = tckpt.restore_checkpoint(
        tmp_path, like, shardings={"a": torch.device("cpu"), "new": torch.device("cpu")}
    )
    assert extra == {} and sorted(got) == ["a", "new"]
    assert got["new"] is like["new"]  # not in the checkpoint: tree_like's leaf
    _bitwise({"a": got["a"]}, {"a": t["a"]})
    # a NamedTuple comes back as itself, by field name
    state = toptim.adamw_init({"w": torch.ones(2, 2)})
    tckpt.save_checkpoint(tmp_path, 2, {"opt_state": state})
    assert "opt_state/step" in json.loads(
        (tmp_path / "step_000000002" / "manifest.json").read_text()
    )["arrays"]  # fmt: skip
    like = {"opt_state": toptim.adamw_init({"w": torch.zeros(2, 2)})}
    got, _ = tckpt.restore_checkpoint(tmp_path, like)
    assert type(got["opt_state"]) is toptim.AdamWState
    _bitwise(_tflat(got), _tflat({"opt_state": state}))
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(tmp_path / "none", like)


def test_uncommitted_checkpoint_ignored(tmp_path):
    tckpt.save_checkpoint(tmp_path, 1, _tree())
    (tmp_path / "step_000000009").mkdir()  # a crash mid-write: no manifest
    (tmp_path / ".tmp_step_000000012" / "arrays").mkdir(parents=True)
    assert tckpt.latest_step(tmp_path) == 1
    assert jckpt.latest_step(tmp_path) == 1
    assert tckpt.latest_step(tmp_path / "absent") is None


def test_manager_retention_and_async(tmp_path):
    mgr = tckpt.CheckpointManager(tmp_path, keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save_async(s, t, extra={"step": s})
    mgr.wait()
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]
    assert tckpt.restore_checkpoint(tmp_path, t)[1] == {"step": 4}


def test_manager_wait_reraises_the_writer_error(tmp_path):
    (tmp_path / "file").write_text("")
    mgr = tckpt.CheckpointManager(tmp_path / "file", keep=2)  # not a directory
    mgr.save_async(1, _tree())
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # raised once


def test_save_async_snapshot_survives_in_place_updates(tmp_path, monkeypatch):
    """The step writes the tree in place right after ``save_async``; the
    writer thread, held until then, must still write the values from
    before."""
    release = threading.Event()
    save = tckpt_mod.save_checkpoint

    def held(*a, **kw):
        release.wait(10)
        return save(*a, **kw)

    monkeypatch.setattr(tckpt_mod, "save_checkpoint", held)
    t = _tree()
    before = {k: v.clone() for k, v in _tflat(t).items()}
    mgr = tckpt.CheckpointManager(tmp_path)
    mgr.save_async(5, t)
    for leaf in _tflat(t).values():
        leaf.add_(1)
    release.set()
    mgr.wait()
    got, _ = tckpt.restore_checkpoint(tmp_path, t)
    _bitwise(_tflat(got), before)


# ---------------------------------------------------------------------------
# (c) the on-disk format, across packages
# ---------------------------------------------------------------------------

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", params=sorted(DTYPES))
def llama(request):
    """The reduced llama in float32 or bf16 (llama3.2-1b's own dtype): the
    JAX weights and state before and after one step, and the port's
    configs."""
    jdt, tdt = DTYPES[request.param]
    jcfg = dataclasses.replace(jconfigs.reduced_config("llama3.2-1b"), dtype=jdt)
    tcfg = dataclasses.replace(tconfigs.reduced_config("llama3.2-1b"), dtype=tdt)
    jp = j_init(jax.random.PRNGKey(4), jcfg)
    jo = joptim.adamw_init(jp)
    rng = np.random.default_rng(4)
    toks = rng.integers(1, jcfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = jax.jit(j_make_train_step(jcfg, joptim.OptConfig(lr=1e-3, warmup_steps=1)))
    jp1, jo1, _ = step(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, jo=jo, jp1=jp1, jo1=jo1, batch=batch)


def _port_state(llama):
    tp = lm_params_from_arrays(jax.tree.map(np.asarray, llama["jp"]), llama["tcfg"], "cpu")
    return {"params": tp, "opt_state": toptim.adamw_init(tp)}


def _files(path):
    step = next(path.glob("step_*"))
    return (step / "manifest.json").read_text(), {
        p.name: p.read_bytes() for p in sorted((step / "arrays").iterdir())
    }


def test_port_writes_the_jax_manifest_and_bytes(llama, tmp_path):
    extra = {"cursor": 5, "step": 2}
    jckpt.save_checkpoint(tmp_path / "j", 2, {"params": llama["jp"], "opt_state": llama["jo"]},
                          extra=extra)  # fmt: skip
    tckpt.save_checkpoint(tmp_path / "t", 2, _port_state(llama), extra=extra)
    jman, jarr = _files(tmp_path / "j")
    tman, tarr = _files(tmp_path / "t")
    assert tman == jman  # keys, shapes, dtypes, file names, extra: the same text
    meta = json.loads(tman)["arrays"]
    assert meta["opt_state/step"] == {"file": meta["opt_state/step"]["file"], "shape": [],
                                      "dtype": "int32"}  # fmt: skip
    want = "bfloat16" if llama["tcfg"].dtype == torch.bfloat16 else "float32"
    assert meta["params/embed"]["dtype"] == want
    assert meta["opt_state/master/embed"]["dtype"] == "float32"
    assert sorted(tarr) == sorted(jarr) and len(tarr) == len(meta)
    for name in jarr:
        assert tarr[name] == jarr[name], name


def test_jax_checkpoint_restores_bitwise_in_the_port(llama, tmp_path):
    # a fresh state: equal to the converted weights and the port's adamw_init
    jckpt.save_checkpoint(tmp_path / "0", 0, {"params": llama["jp"], "opt_state": llama["jo"]},
                          extra={"step": 0})  # fmt: skip
    like = _port_state(llama)
    zero = tree_map(torch.zeros_like, like["params"])
    tp, to, start, cursor = _resume(tmp_path / "0", zero, toptim.adamw_init(zero))
    assert (start, cursor) == (0, None)
    _bitwise(_tflat({"params": tp, "opt_state": to}), _tflat(like))
    # after one JAX step: m, v, master and step as the JAX package holds them
    jckpt.save_checkpoint(tmp_path / "1", 1, {"params": llama["jp1"], "opt_state": llama["jo1"]},
                          extra={"step": 1, "cursor": 9})  # fmt: skip
    tp, to, start, cursor = _resume(tmp_path / "1", zero, toptim.adamw_init(zero))
    assert (start, cursor) == (1, 9) and type(to) is toptim.AdamWState
    assert to.step.dtype == torch.int32 and to.step.shape == () and int(to.step) == 1
    _bitwise(_tflat({"params": tp, "opt_state": to}),
             _jflat({"params": llama["jp1"], "opt_state": llama["jo1"]}))  # fmt: skip
    # and the port writes it back byte for byte
    tckpt.save_checkpoint(tmp_path / "again", 1, {"params": tp, "opt_state": to},
                          extra={"step": 1, "cursor": 9})  # fmt: skip
    assert _files(tmp_path / "again") == _files(tmp_path / "1")


def _resume(ckpt_dir, params_like, opt_like):
    trainer = truntime.ResilientTrainer(train_step=None, ckpt_dir=ckpt_dir)
    return trainer.resume(params_like, opt_like)


def test_port_checkpoint_restores_bitwise_in_jax(llama, tmp_path):
    state = _port_state(llama)
    step = make_train_step(llama["tcfg"], toptim.OptConfig(lr=1e-3, warmup_steps=1))
    tp, to, _ = step(state["params"], state["opt_state"], llama["batch"])
    tckpt.save_checkpoint(tmp_path, 1, {"params": tp, "opt_state": to}, extra={"step": 1})
    jlike = {"params": jax.tree.map(jnp.zeros_like, llama["jp"]),
             "opt_state": jax.tree.map(jnp.zeros_like, llama["jo"])}  # fmt: skip
    got, extra = jckpt.restore_checkpoint(tmp_path, jlike)
    assert extra == {"step": 1}
    assert got["opt_state"].step.dtype == jnp.int32 and int(got["opt_state"].step) == 1
    assert got["params"]["embed"].dtype == llama["jcfg"].dtype
    _bitwise(_jflat(got), _tflat({"params": tp, "opt_state": to}))


# ---------------------------------------------------------------------------
# (d) watchdog, injector, heartbeat
# ---------------------------------------------------------------------------

STEP_TIMES = [0.1, 0.12, 0.09, 0.5, 0.1, 0.11, 0.45, 0.1, 1.2, 0.1, 0.3, 0.31, 0.1, 2.0, 0.1]


@pytest.mark.parametrize("factor,warmup", [(3.0, 3), (2.0, 0), (1.5, 5)])
def test_straggler_watchdog_flags_the_jax_steps(factor, warmup):
    got, want = (mod.StragglerWatchdog(factor, warmup=warmup) for mod in (truntime, jruntime))
    flags = [(got.observe(i, dt), want.observe(i, dt)) for i, dt in enumerate(STEP_TIMES)]
    assert [g for g, _ in flags] == [w for _, w in flags]
    assert got.stragglers == want.stragglers and got.ema == want.ema
    assert any(g for g, _ in flags)


def test_failure_injector_fires_once_per_step():
    for mod in (truntime, jruntime):
        inj = mod.FailureInjector((2, 5))
        for step in (0, 1, 3, 4, 6):
            inj.maybe_fail(step)
        for step in (2, 5):
            with pytest.raises(RuntimeError, match=f"injected failure at step {step}"):
                inj.maybe_fail(step)
            inj.maybe_fail(step)  # a restart passes the same step
        assert inj.fired == {2, 5}


def test_heartbeat_stamps_and_stops(tmp_path):
    hb = truntime.Heartbeat(tmp_path / "hb" / "beat", interval_s=0.01)
    assert hb.age() == float("inf")
    hb.start()
    try:
        assert hb.age() < 60
    finally:
        hb.stop()
    assert not hb._thread.is_alive()


# ---------------------------------------------------------------------------
# (e) crash -> restart in the port, (f) the trainer against the JAX one
# ---------------------------------------------------------------------------


def _corpus(mod):
    walks = np.random.default_rng(0).integers(0, 200, (64, 17)).astype(np.int32)
    return mod.WalkCorpus.from_walks(walks, 200)


def _port_trainer(tmp_path, fail_at=()):
    """``tests/test_checkpoint_fault.py::_setup_trainer`` in the port: fresh
    parameters each call (the step updates them in place)."""
    cfg = tconfigs.reduced_config("llama3.2-1b")
    params = model_init(0, cfg, device="cpu")
    trainer = truntime.ResilientTrainer(
        train_step=make_train_step(cfg, toptim.OptConfig(lr=1e-3, total_steps=100)),
        ckpt_dir=tmp_path / "ckpt", ckpt_every=4, injector=truntime.FailureInjector(fail_at),
    )  # fmt: skip
    return params, toptim.adamw_init(params), trainer


def test_crash_restart_resumes_bitwise(tmp_path):
    """12 steps with a crash at step 9 and a restart from the newest
    committed step equal an uninterrupted run, bit for bit."""
    corpus = _corpus(tdata)

    def batches(cursor=0):
        return corpus.batches(4, 16, cursor=cursor, epochs=None, seed=7)

    params0, opt0, trainer = _port_trainer(tmp_path / "x")
    p_ref, o_ref, info = trainer.run(params0, opt0, batches(), num_steps=12)
    assert info["step"] == 12

    params1, opt1, trainer2 = _port_trainer(tmp_path / "y", fail_at=(9,))
    with pytest.raises(RuntimeError, match="injected failure"):
        trainer2.run(params1, opt1, batches(), num_steps=12)
    params_r, opt_r, start, cursor = trainer2.resume(params1, opt1)
    assert start in (4, 8)
    trainer2.injector = None
    p_done, o_done, _ = trainer2.run(params_r, opt_r, batches(cursor), num_steps=12,
                                     start_step=start)  # fmt: skip
    _bitwise(_tflat({"params": p_done, "opt_state": o_done}),
             _tflat({"params": p_ref, "opt_state": o_ref}))  # fmt: skip
    assert tckpt.latest_step(tmp_path / "y" / "ckpt") == 12


def test_trainer_matches_jax_trainer(tmp_path):
    """Six steps of the port's ``ResilientTrainer`` against the JAX one from
    the same weights (converted) and the same batches: each step's loss
    within LOSS_TOL, the final parameters within STEP_TOL, the same steps
    and cursors in both packages' checkpoints."""
    jcfg, tcfg = jconfigs.reduced_config("llama3.2-1b"), tconfigs.reduced_config("llama3.2-1b")
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=6)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_arrays(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    runs = {}
    for name, mod, rt, params, opt_state, step in (
        ("jax", jdata, jruntime, jp, joptim.adamw_init(jp),
         jax.jit(j_make_train_step(jcfg, joptim.OptConfig(**opt)))),
        ("port", tdata, truntime, tp, toptim.adamw_init(tp),
         make_train_step(tcfg, toptim.OptConfig(**opt))),
    ):  # fmt: skip
        losses = []
        trainer = rt.ResilientTrainer(train_step=step, ckpt_dir=tmp_path / name, ckpt_every=4)
        p, _, info = trainer.run(
            params, opt_state, _corpus(mod).batches(4, 16, seed=7), num_steps=6,
            on_metrics=lambda s, m: losses.append((s, m["loss"], m["tokens"])),
        )  # fmt: skip
        runs[name] = (p, losses, info)
    (jp6, jlosses, jinfo), (tp6, tlosses, tinfo) = runs["jax"], runs["port"]
    assert [s for s, _, _ in tlosses] == [s for s, _, _ in jlosses] == list(range(6))
    assert [n for _, _, n in tlosses] == [n for _, _, n in jlosses]
    np.testing.assert_allclose([x for _, x, _ in tlosses], [x for _, x, _ in jlosses],
                               atol=LOSS_TOL, rtol=LOSS_TOL)  # fmt: skip
    assert tinfo["step"] == jinfo["step"] == 6
    flat = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jp6)))
    for path, leaf in tree_leaves_with_path(tp6):
        np.testing.assert_allclose(leaf.numpy(), flat[path], atol=STEP_TOL, rtol=STEP_TOL,
                                   err_msg=path)  # fmt: skip
    assert len(tree_leaves(tp6)) == len(flat)
    for s in (4, 6):
        jman = json.loads((tmp_path / "jax" / f"step_{s:09d}" / "manifest.json").read_text())
        tman = json.loads((tmp_path / "port" / f"step_{s:09d}" / "manifest.json").read_text())
        assert tman == jman  # the same keys, shapes, dtypes, files, cursor and step
