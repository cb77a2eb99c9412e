"""Storage traffic per walk step, from the program's ``IOStats``: block,
vertex and on-demand bytes loaded, and walk-pool bytes written and read,
over the steps of the window."""

FIELDS = ("block_bytes", "vertex_bytes", "ondemand_bytes", "walk_bytes_written", "walk_bytes_read")


def read(rec):
    steps = sum(t["steps"] for t in rec["tasks"])
    if steps == 0:
        return None
    return sum(t[f] for t in rec["tasks"] for f in FIELDS) / steps
