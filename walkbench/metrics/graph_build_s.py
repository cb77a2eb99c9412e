"""Seconds of the program's graph build in set-up (host clock): CSR from the
edge list, partition into blocks, and the container write of a disk graph."""


def read(rec):
    return rec["graph_build_s"]
