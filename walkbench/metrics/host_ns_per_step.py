"""Host nanoseconds per walk step: each task's wall time less its advance
calls' time (``IOStats.exec_time``), over the window's steps."""


def read(rec):
    steps = sum(t["steps"] for t in rec["tasks"])
    if steps == 0:
        return None
    host_s = sum(t["wall_s"] - t["exec_s"] for t in rec["tasks"])
    return host_s / steps * 1e9
