"""Walk steps per second: every step of every task of the window over the
window's time, from the first task's start to the last task's end (host
clock; each task's engine construction included)."""


def read(rec):
    steps = sum(t["steps"] for t in rec["tasks"])
    return steps / rec["window_s"] if rec["window_s"] > 0 else None
