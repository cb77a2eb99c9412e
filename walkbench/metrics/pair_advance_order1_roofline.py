"""Share of its roofline that the first-order CUDA pair advance reaches
(``torch.profiler``).

Only the order-1 instantiation of the kernel is read: its trace name holds
``pair_advance_kernel<1, ...>``.  The roofline, the peak and the bytes of
lane state a launched thread moves are ``pair_advance_roofline.py``'s; a
first-order step reads less than a second-order one: the two ``indptr``
words of the current vertex and one candidate index (4 B each), with no
probe of the previous vertex's list, and the alias pair (8 B) on a weighted
graph; 4 B more per step recorded, when the corpus is kept.

Every step of a first-order window is taken inside this kernel.
"""

import json

from walkbench.metrics.pair_advance_roofline import LANE_BYTES, PEAKS

KERNEL = "pair_advance_kernel<1,"


def step_bytes(weighted: bool, recorded: bool) -> int:
    return 3 * 4 + (8 if weighted else 0) + (4 if recorded else 0)


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    ks = [k for name, k in tr["kernels"].items() if KERNEL in name.replace(" ", "")]
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
