"""What the benchmark imports: never JAX or the JAX package (``repro``), and
the yardstick (reference, generator, trace reduction, metric readers) never
the program either.  Names are compared as whole top-level module names:
``repro_torch`` is not ``repro``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: modules that judge or measure the program, and so import none of it
YARDSTICK = ["reference.py", "graph500.py", "devtrace.py", *sorted(
    str(p.relative_to(BENCH)) for p in (BENCH / "metrics").glob("*.py"))]  # fmt: skip


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize(
    "rel", sorted(str(p.relative_to(BENCH)) for p in BENCH.rglob("*.py"))
)
def test_no_file_imports_jax_or_the_jax_package(rel):
    assert not top_level_imports(BENCH / rel) & FORBIDDEN


@pytest.mark.parametrize("rel", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(rel):
    assert "repro_torch" not in top_level_imports(BENCH / rel)


def test_importing_the_yardstick_loads_neither_the_program_nor_jax():
    code = (
        "import sys; sys.path.insert(0, %r); "
        "import walkbench.reference, walkbench.graph500, walkbench.devtrace; "
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}))" % str(ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_run_guard_compares_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    for name in ("repro_torch", "repro_torch.core", "reproducible", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"repro", "jaxlib"} <= set(run.forbidden_modules())
