"""Share of its roofline that the CUDA pair advance reaches (``torch.profiler``).

The kernel does next to no arithmetic, so its roofline is the least time
its bytes take at the card's HBM bandwidth (``peaks.json``).  The bytes are
counted here, from what the inputs need and not from what the kernel does:

* per launch, every lane's state read once (walk id, previous and current
  vertex, hop: 4 B each; alive: 1 B) and written once (previous and current
  vertex, hop: 4 B each; alive: 1 B), for each thread launched;
* per step taken, the words one step must read: the two ``indptr`` words of
  the current vertex, one candidate index, one probe of the previous
  vertex's list (4 B each), and the alias pair (8 B) on a weighted graph;
* 4 B per step recorded, when the corpus is kept.

Every step of the window is taken inside this kernel.  In practice it is
bound by the latency of its dependent loads, not by these bytes.
"""

import json
from pathlib import Path

KERNEL = "pair_advance_kernel"
LANE_BYTES = (4 * 4 + 1) + (3 * 4 + 1)
PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"


def step_bytes(weighted: bool, recorded: bool) -> int:
    return 4 * 4 + (8 if weighted else 0) + (4 if recorded else 0)


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    ks = [k for name, k in tr["kernels"].items() if KERNEL in name]
    if not ks or any(k["threads"] is None for k in ks):
        return None
    seconds = sum(k["seconds"] for k in ks)
    with open(PEAKS) as f:
        peak = json.load(f).get(rec["device_kind"], {}).get("hbm_bytes_per_s")
    if peak is None or seconds <= 0:
        return None
    steps = sum(t["steps"] for t in rec["tasks"])
    nbytes = sum(k["threads"] for k in ks) * LANE_BYTES + steps * step_bytes(
        rec["weighted"], rec["record_walks"]
    )
    return 100.0 * nbytes / peak / seconds
