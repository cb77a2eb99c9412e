"""The port's walk launcher prints the JAX launcher's CSV for every engine.

``python -m repro_torch.launch.walk`` (``--device cpu --advance torch``)
against ``python -m repro.launch.walk`` with the same flags: the same
header byte for byte, the same engines in the same order (``biblock`` and
``sogw`` when no ``--engine`` is given), and the same deterministic
columns in every row — for all five engines, and with the disk graph
backend, where the oracle keeps the RAM graph.  Tolerance: bitwise (the
columns are compared as printed).
"""

import os
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


PORT = ("--device", "cpu", "--advance", "torch")
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
    and sums their advance time."""
    from repro_torch.launch import profile_walk

    walk = ["--vertices", "120", "--blocks", "3", "--length", "4", *PORT]
    report = profile_walk.main(["--top", "3", "--", *walk])
    rows = [line.split(",")[0] for line in capsys.readouterr().out.splitlines()
            if line.startswith(("biblock,", "sogw,"))]  # fmt: skip
    assert rows == ["biblock", "sogw"]
    assert "device" not in report  # --device cpu: no device half
    assert report["host"]["exec_s"] > 0
    assert report["host"]["run_s"] >= report["host"]["exec_s"]
