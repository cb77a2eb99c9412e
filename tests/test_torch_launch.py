"""The port's walk launcher prints the JAX launcher's CSV for every engine.

``python -m repro_torch.launch.walk`` (``--device cpu``)
against ``python -m repro.launch.walk`` with the same flags: the same
header byte for byte, the same engines in the same order (``biblock`` and
``sogw`` when no ``--engine`` is given), and the same deterministic
columns in every row — for all five engines, and with the disk graph
backend, where the oracle keeps the RAM graph.  Tolerance: bitwise (the
columns are compared as printed).

The train launcher (``python -m repro_torch.launch.train --device cpu``)
and the example twins (``examples/torch_port/train_lm_on_walks.py``,
``examples/torch_port/quickstart.py``) print the JAX originals' lines but
for what the wall clock or the random weights decide (losses, times), load
neither ``jax`` nor ``repro``, and the launcher resumes from its own
checkpoint and from the JAX launcher's.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")  # the port needs PyTorch; CI legs without it skip

REPO = Path(__file__).resolve().parents[1]

#: launcher CSV columns that do not depend on wall clock or thread timing
DETERMINISTIC = (
    "block_ios",
    "vertex_ios",
    "ondemand_ios",
    "ondemand_syscalls",
    "coalesced_ranges",
    "coalesce_waste_bytes",
    "walk_bytes_written",
    "peak_resident_bytes",
    "sim_io_s",
)
ARGV = ["--vertices", "240", "--blocks", "3", "--length", "6", "--p", "3", "--q", "0.5"]


def _launch(module, *extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", module, *ARGV, *extra],
        capture_output=True,
        text=True,
        env=env,
        cwd=REPO,
        timeout=300,
        check=True,
    ).stdout.strip().splitlines()
    start = next(i for i, line in enumerate(out) if line.startswith("engine,"))
    header = out[start]
    cols = header.split(",")
    rows = [line.split(",") for line in out[start + 1 :]]
    return header, [(r[0], {k: r[cols.index(k)] for k in DETERMINISTIC}) for r in rows]


PORT = ("--device", "cpu")
ALL = ("--engine", "biblock", "--engine", "pb", "--engine", "sogw", "--engine", "sgsc",
       "--engine", "oracle")  # fmt: skip


@pytest.mark.parametrize(
    "extra,engines",
    [
        ((), ["biblock", "sogw"]),
        (ALL, ["biblock", "pb", "sogw", "sgsc", "oracle"]),
        (("--graph-backend", "disk", "--engine", "oracle", "--engine", "sgsc"), ["oracle", "sgsc"]),
    ],
    ids=["default", "all", "disk"],
)
def test_launcher_csv_matches_jax_launcher(extra, engines):
    jheader, want = _launch("repro.launch.walk", *extra)
    theader, got = _launch("repro_torch.launch.walk", *PORT, *extra)
    assert theader == jheader
    assert got == want
    assert [name for name, _ in got] == engines


def test_profile_walk_covers_every_engine_of_the_run(capsys):
    """The profiler drives the launcher's default engine list (two engines)
    and sums their advance time, and prints the engines' span table."""
    from repro_torch.core import spans
    from repro_torch.launch import profile_walk

    walk = ["--vertices", "120", "--blocks", "3", "--length", "4", *PORT]
    report = profile_walk.main(["--top", "3", "--", *walk])
    out = capsys.readouterr().out.splitlines()
    rows = [line.split(",")[0] for line in out if line.startswith(("biblock,", "sogw,"))]
    # one CSV block from the span run, one from the cProfile run
    assert rows == ["biblock", "sogw"] * 2
    assert "device" not in report  # --device cpu: no device half
    assert report["host"]["exec_s"] > 0
    assert report["host"]["run_s"] >= report["host"]["exec_s"]
    # the span table: both engines' runs, advance calls and their parts
    table = report["spans"]
    assert table["task.run"]["n"] == table["engine.init"]["n"] == 2
    for name in ("advance", "advance.upload", "advance.exec", "retire", "load", "slot", "pool"):
        assert table[name]["n"] > 0 and table[name]["self_s"] >= 0, name
    assert table["advance.exec"]["n"] == table["advance"]["n"]
    assert sum(report["counts"].values()) > 0  # biblock's loader decisions
    assert set(report["counts"]) <= {
        "load.full", "load.ondemand", "pair.segment.built", "pair.segment.kept",
    }  # fmt: skip
    assert report["counts"]["pair.segment.built"] > 0
    printed = {line.split()[-1] for line in out if line.startswith("[spans] ")}
    assert printed == set(table)
    counted = {line.split()[-1] for line in out if line.startswith("[counts] ")}
    assert counted == set(report["counts"])
    assert spans.span("advance") is spans.NO_SPAN  # off again


def test_profile_walk_prints_hops_per_visit_of_a_first_order_task(capsys):
    """A DeepWalk run: the slots' steps over the ``slot.visits`` counter."""
    from repro_torch.launch import profile_walk

    walk = ["--task", "deepwalk", "--vertices", "120", "--blocks", "3", "--length", "6",
            "--engine", "biblock", *PORT]  # fmt: skip
    report = profile_walk.main(["--top", "3", "--", *walk])
    out = capsys.readouterr().out.splitlines()
    first = report["first_order"]
    assert first["visits"] == report["counts"]["slot.visits"] > 0
    assert 0 < first["steps"] and first["hops_per_visit"] == first["steps"] / first["visits"]
    line = f"{first['hops_per_visit']:.3f} hops per visit"
    assert sum(x.startswith("[first-order]") and x.endswith(line) for x in out) == 1


def test_profile_walk_prints_no_hops_per_visit_for_node2vec(capsys):
    from repro_torch.launch import profile_walk

    walk = ["--vertices", "120", "--blocks", "3", "--length", "4", "--engine", "biblock", *PORT]
    report = profile_walk.main(["--top", "3", "--", *walk])
    assert "first_order" not in report and "slot.visits" not in report["counts"]
    assert not any(x.startswith("[first-order]") for x in capsys.readouterr().out.splitlines())


# ---------------------------------------------------------------------------
# the train launcher and the example twins
# ---------------------------------------------------------------------------

#: runs a module (``-m`` style) or a script in a fresh interpreter, then
#: prints whether ``jax`` or any ``repro`` module was loaded
_RUN_PORT = r"""
import runpy, sys
target, sys.argv = sys.argv[1], sys.argv[1:]
if target.endswith(".py"):
    runpy.run_path(target, run_name="__main__")
else:
    runpy.run_module(target, run_name="__main__", alter_sys=True)
leaked = [m for m in sys.modules if m in ("jax", "repro") or m.startswith(("jax.", "repro."))]
print(f"leaked: {sorted(leaked)}")
"""
TRAIN = ["--reduced", "--graph-vertices", "200", "--batch", "2", "--seq", "8"]


def _run(argv, port=True, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-c", _RUN_PORT] if port else [sys.executable]
    out = subprocess.run(
        [*cmd, *argv], capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout,
        check=True,
    ).stdout.strip().splitlines()  # fmt: skip
    if port:
        assert out[-1] == "leaked: []"
        out = out[:-1]
    return out


def _strip(lines, *patterns):
    """The lines with what the wall clock or the weights decide taken out."""
    for pat in patterns:
        lines = [re.sub(pat, "#", line) for line in lines]
    return lines


def test_train_launcher_resumes_from_its_checkpoint(tmp_path):
    ckpt = ["--ckpt-dir", str(tmp_path / "ckpt"), "--device", "cpu"]
    first = _run(["repro_torch.launch.train", *TRAIN, "--steps", "3", *ckpt])
    assert first[0] == "arch=llama3.2-1b-reduced devices=1"
    assert first[1] == "corpus: 400 walks, vocab 201"
    assert first[-1] == f"finished at step 3; checkpoints in {tmp_path / 'ckpt'}"
    second = _run(["repro_torch.launch.train", *TRAIN, "--steps", "5", *ckpt])
    assert second[2] == "resumed at step 3"
    assert second[-1] == f"finished at step 5; checkpoints in {tmp_path / 'ckpt'}"
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("step_*")) == [
        "step_000000003", "step_000000005",
    ]  # fmt: skip


def test_train_launcher_prints_the_jax_lines_and_resumes_a_jax_checkpoint(tmp_path):
    """The JAX launcher and the port's print the same lines but for the
    loss and the step time; the port resumes from the JAX launcher's
    checkpoint (the shared on-disk format)."""
    jdir, tdir = ["--ckpt-dir", str(tmp_path / "j")], ["--ckpt-dir", str(tmp_path / "t")]
    want = _run(["-m", "repro.launch.train", *TRAIN, "--steps", "3", *jdir], port=False)
    got = _run(["repro_torch.launch.train", *TRAIN, "--steps", "3", *tdir, "--device", "cpu"])
    loss = (r"loss [0-9.]+ \([0-9]+ ms\)", r"checkpoints in .*")
    assert len(got) == 4 and _strip(got, *loss) == _strip(want, *loss)
    more = _run(["repro_torch.launch.train", *TRAIN, "--steps", "5", *jdir, "--device", "cpu"])
    assert more[2] == "resumed at step 3" and more[-1].startswith("finished at step 5")


def test_train_example_twin_matches_jax_example(tmp_path):
    tiny = ["--tiny", "--steps", "3", "--vertices", "200", "--batch", "2", "--seq", "8"]
    want = _run(["examples/train_lm_on_walks.py", *tiny, "--ckpt-dir", str(tmp_path / "j")],
                port=False, timeout=600)  # fmt: skip
    got = _run(["examples/torch_port/train_lm_on_walks.py", *tiny,
                "--ckpt-dir", str(tmp_path / "t"), "--device", "cpu"])  # fmt: skip
    clock = (r"in [0-9.]+s wall", r"loss [0-9.]+", r"[0-9]+ ms", r"\(first [0-9.]+\)")
    assert len(got) == 6 and _strip(got, *clock) == _strip(want, *clock)
    assert got[1].startswith("  800 walks x 10 steps in ") and got[1].endswith("(109 block I/Os)")
    assert "params=0.4M" in got[3]


def test_quickstart_twin_matches_jax_example():
    """Every line equal but the simulated wall times (they hold the
    measured advance time) and the speedup taken from them."""
    small = ["--vertices", "400", "--blocks", "4", "--length", "6"]
    want = _run(["examples/quickstart.py", *small], port=False, timeout=600)
    got = _run(["examples/torch_port/quickstart.py", *small, "--device", "cpu"])
    clock = (r"sim wall time : .*", r"GraSorw speedup: [0-9.]+x")
    assert len(got) == 23 and _strip(got, *clock) == _strip(want, *clock)
    assert any("top-8 vertices: [(" in line for line in got)
