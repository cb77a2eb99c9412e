"""Share of the graph bytes loaded that the on-demand path loaded:
on-demand bytes over block, vertex and on-demand bytes (``IOStats``)."""


def read(rec):
    ondemand = sum(t["ondemand_bytes"] for t in rec["tasks"])
    total = ondemand + sum(t["block_bytes"] + t["vertex_bytes"] for t in rec["tasks"])
    return 100.0 * ondemand / total if total > 0 else None
