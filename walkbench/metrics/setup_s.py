"""Set-up seconds: from the process's start to the window's start (host
clock): imports, the edge list, the program's graph build, the warm-up task,
and in a traced run the profiler's start."""


def read(rec):
    return rec["setup_s"]
