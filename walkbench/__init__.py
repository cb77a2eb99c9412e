"""The benchmark of repro_torch's bi-block engine (see ``harness``)."""
