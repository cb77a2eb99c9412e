"""Each metric reader's arithmetic on hand-made records."""

import json

import pytest

from walkbench import harness


def task(**kw):
    base = dict(wall_s=2.0, exec_s=0.5, steps=1000, advance_calls=4, num_walks=100,
                block_bytes=8000, vertex_bytes=0, ondemand_bytes=2000,
                walk_bytes_written=1600, walk_bytes_read=1600)  # fmt: skip
    base.update(kw)
    return base


TRACE = {
    "busy_s": 0.5,
    "window_s": 5.0,
    "device_ops": [],
    "idle_gaps": [],
    "kernels": {
        "void (anonymous namespace)::pair_advance_kernel<2, false>(...)": {
            "seconds": 1e-3, "launches": 2, "threads": 2048},
        "(anonymous namespace)::slot_check_kernel(...)": {
            "seconds": 1.0, "launches": 2, "threads": 512},
    },
}  # fmt: skip


def record(trace=None, **kw):
    rec = dict(setup_s=12.5, graph_build_s=3.25, window_s=5.0,
               tasks=[task(), task(wall_s=3.0, exec_s=1.0, steps=3000, advance_calls=6,
                               ondemand_bytes=0)],
               record_walks=True, weighted=False, device_kind="NVIDIA H100 80GB HBM3",
               trace=trace)  # fmt: skip
    rec.update(kw)
    return rec


EXPECTED = {
    "walk_steps_per_s": 4000 / 5.0,
    "setup_s": 12.5,
    "graph_build_s": 3.25,
    "io_bytes_per_step": (8000 + 2000 + 3200 + 8000 + 3200) / 4000,
    "host_ns_per_step": (1.5 + 2.0) / 4000 * 1e9,
    "ondemand_byte_share_pct": 100 * 2000 / 18000,
    "walk_pool_bytes_per_step": 6400 / 4000,
    "exec_share_pct": 100 * 1.5 / 5.0,
    "steps_per_advance_call": 4000 / 10,
    # 2048 lanes x 30 B + 4000 steps x (16 + 4 recorded) B, over 1 ms at 3.35e12 B/s
    "pair_advance_roofline": 100 * (2048 * 30 + 4000 * 20) / 3.35e12 / 1e-3,
    "device_idle_pct": 100 * (1 - 0.5 / 5.0),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_arithmetic(name):
    assert harness.metric_reader(name)(record(TRACE)) == pytest.approx(EXPECTED[name], rel=1e-12)


def test_every_metric_of_the_benchmark_is_tested_here():
    spec = harness.load_spec()
    names = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    assert names == set(EXPECTED)


@pytest.mark.parametrize("name", ["pair_advance_roofline", "device_idle_pct"])
def test_trace_readers_read_nothing_without_a_trace(name):
    assert harness.metric_reader(name)(record(None)) is None


def test_readers_that_find_nothing_return_nothing():
    idle = record(TRACE, tasks=[task(steps=0, advance_calls=0, block_bytes=0, ondemand_bytes=0)])
    for name in ("io_bytes_per_step", "host_ns_per_step", "walk_pool_bytes_per_step",
                 "steps_per_advance_call", "ondemand_byte_share_pct"):  # fmt: skip
        assert harness.metric_reader(name)(idle) is None, name
    unknown_card = record(TRACE, device_kind="some other card")
    assert harness.metric_reader("pair_advance_roofline")(unknown_card) is None
    no_grid = json.loads(json.dumps(TRACE))
    for k in no_grid["kernels"].values():
        k["threads"] = None
    assert harness.metric_reader("pair_advance_roofline")(record(no_grid)) is None


def test_roofline_counts_the_alias_pair_on_a_weighted_graph_and_no_corpus():
    rec = record(TRACE, weighted=True, record_walks=False)
    want = 100 * (2048 * 30 + 4000 * 24) / 3.35e12 / 1e-3
    assert harness.metric_reader("pair_advance_roofline")(rec) == pytest.approx(want)


def test_trace_reduction_unions_device_intervals_inside_the_window():
    from walkbench.devtrace import reduce_trace

    mark = {"ph": "X", "cat": "user_annotation", "name": "walkbench.window", "ts": 1000.0, "dur": 1}
    k = "void pair_advance_kernel<2, false>(...)"
    events = [
        mark,
        # ts in microseconds; the mark is host time 10.0 s, the window 10.0-10.01 s
        {"ph": "X", "cat": "kernel", "name": k, "ts": 2000.0, "dur": 3000.0,
         "args": {"grid": [4, 1, 1], "block": [256, 1, 1]}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 4000.0, "dur": 2000.0},
        {"ph": "X", "cat": "kernel", "name": k, "ts": 9000.0, "dur": 5000.0,
         "args": {"grid": [2, 1, 1], "block": [256, 1, 1]}},  # cut at the window's end
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1500.0, "dur": 9000.0},
    ]  # fmt: skip
    samples = [(10.0005, "a.py:f"), (10.0025, "b.py:g"), (10.0075, "a.py:f"), (10.02, "c.py:h")]
    out = reduce_trace(events, mark_host_s=10.0, t_start=10.0, t_end=10.01, samples=samples,
                       interval=0.001)  # fmt: skip
    # busy: [1, 5) ms by the kernel and the copy, [8, 10) ms by the cut kernel
    assert out["busy_s"] == pytest.approx(0.006)
    assert out["window_s"] == pytest.approx(0.01)
    assert out["kernels"][k]["seconds"] == pytest.approx(0.005)
    assert out["kernels"][k]["launches"] == 2 and out["kernels"][k]["threads"] == 1536
    assert dict(out["device_ops"]) == pytest.approx({k: 0.005, "Memcpy HtoD": 0.002})
    # samples at 0.5 and 7.5 ms fall where the card idles; 2.5 ms is busy; 20 ms is outside
    assert out["idle_gaps"] == [["a.py:f", 0.002]]
