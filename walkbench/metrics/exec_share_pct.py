"""Share of the window inside the advance calls: the sum of
``IOStats.exec_time`` (packing excluded; launch, kernel and the copies back
included) over the window's time."""


def read(rec):
    if rec["window_s"] <= 0:
        return None
    return 100.0 * sum(t["exec_s"] for t in rec["tasks"]) / rec["window_s"]
