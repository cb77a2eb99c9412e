"""Walk-pool bytes written and read per walk step (``IOStats``)."""


def read(rec):
    steps = sum(t["steps"] for t in rec["tasks"])
    if steps == 0:
        return None
    return sum(t["walk_bytes_written"] + t["walk_bytes_read"] for t in rec["tasks"]) / steps
