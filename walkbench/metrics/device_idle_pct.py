"""Share of the traced window in which nothing ran on the device: one less
the union of kernel, copy and memset intervals over the window
(``torch.profiler``)."""


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
