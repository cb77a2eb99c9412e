"""Shared helpers of the benchmark's CPU tests: cells cut to a few hundred
vertices and a few hops, so that a whole run takes seconds on the CPU."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = [
    "rwnv.graph500-s18-disk16",
    "rwnv.graph500-s20-ram2",
    "prnv.graph500-s18-disk16",
    "prnv.graph500-s20-ram2",
]


def small_cell(name: str, *, scale: int = 9, length: int = 8):
    """A cell of ``BENCHMARK.json`` at 2**scale vertices and walks of at
    most ``length`` hops, everything else as committed."""
    from walkbench import harness

    cell = harness.resolve_cell(name)
    blocks = min(int(cell.config["blocks"]), 4)
    cell.config = dict(cell.config, scale=scale, blocks=blocks)
    cell.traffic = dict(cell.traffic, length=min(int(cell.traffic["length"]), length))
    return cell
