"""Host spans and counters of the port's walk engines (``repro_torch.core.spans``).

The recorder's arithmetic on hand-timed spans (nesting, parents, self time,
``take``), its disabled path, the exact attribution of device-idle time to
the innermost span, and a CPU run of the bi-block engine with spans on: the
walks and every deterministic charge equal the run with spans off, every
span nests inside the run, the advance call's spans add up to
``IOStats.exec_time``, the loader's decisions add up to the buckets, and a
first-order run's slots carry the walks they advanced and the steps those
took, as the corpus shows them.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    deepwalk_task,
    erdos_renyi,
    partition_into_n_blocks,
    rwnv_task,
    spans,
)
from repro_torch.engines import BiBlockEngine  # noqa: E402
from repro_torch.io import DiskBlockedGraph, write_block_file  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def recorder():
    """Spans on for the test, and nothing left behind for the next."""
    spans.take()
    spans.enable()
    try:
        yield spans
    finally:
        spans.disable()
        spans.take()


@pytest.fixture
def clock(monkeypatch):
    """The recorder's clock, reading the given times in turn."""
    times = []
    monkeypatch.setattr(spans, "_clock", lambda: times.pop(0))
    return times


def test_nesting_parents_self_time_and_take(recorder, clock):
    clock.extend([10, 20, 30, 45, 50, 70, 100, 104])
    with spans.span("outer", block=3) as outer:
        with spans.span("inner"):
            pass
        with spans.span("inner") as second:
            second.set(decision="full")
        spans.count("load.full")
        spans.count("load.full", 2)
    with spans.span("other"):
        pass
    got, counts = spans.take()
    assert counts == {"load.full": 3}
    by_name = {}
    for s in got:
        by_name.setdefault(s.name, []).append(s)
    (o,) = by_name["outer"]
    i1, i2 = sorted(by_name["inner"], key=lambda s: s.start)
    (other,) = by_name["other"]
    assert (o.start, o.end, o.parent, o.attrs) == (10, 70, -1, {"block": 3})
    assert (i1.start, i1.end, i1.parent) == (20, 30, o.index)
    assert (i2.start, i2.end, i2.parent, i2.attrs) == (45, 50, o.index, {"decision": "full"})
    assert other.parent == -1 and outer is o
    assert {s.thread for s in got} == {threading.get_ident()}
    assert spans.self_times(got) == {
        "outer": {"n": 1, "self_ns": 60 - 10 - 5},
        "inner": {"n": 2, "self_ns": 15},
        "other": {"n": 1, "self_ns": 4},
    }
    assert spans.take() == ([], {})  # take() clears


def test_add_records_the_given_times_inside_the_open_span(recorder, clock):
    clock.extend([0, 100])
    with spans.span("advance") as adv:
        spans.add("advance.exec", 30, 80)
    got, _ = spans.take()
    (ex,) = [s for s in got if s.name == "advance.exec"]
    assert (ex.start, ex.end, ex.parent) == (30, 80, adv.index)
    assert spans.self_times(got)["advance"]["self_ns"] == 50


def test_a_span_open_at_take_is_returned_by_the_next_take(recorder, clock):
    clock.extend([0, 5, 9, 12])
    with spans.span("task.run"):
        with spans.span("advance"):
            pass
        first, _ = spans.take()
    second, _ = spans.take()
    assert [s.name for s in first] == ["advance"]
    assert [s.name for s in second] == ["task.run"]
    assert first[0].parent == second[0].index


def test_spans_of_other_threads_keep_their_own_stack(recorder):
    def work():
        with spans.span("pool"):
            pass

    with spans.span("task.run") as run:
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    got, _ = spans.take()
    (pool,) = [s for s in got if s.name == "pool"]
    assert pool.parent == -1 and pool.thread != run.thread


def test_disabled_records_nothing_and_reads_no_clock(monkeypatch):
    spans.disable()
    spans.take()

    def no_clock():
        raise AssertionError("the clock was read with spans off")

    monkeypatch.setattr(spans, "_clock", no_clock)
    assert spans.span("advance") is spans.NO_SPAN
    assert spans.span("bucket", block=1, walks=2) is spans.NO_SPAN
    with spans.span("load") as sp:
        sp.set(decision="full", eta=0.5)
    spans.add("advance.exec", 1, 2)
    spans.count("load.full")
    assert spans.take() == ([], {})


def _hand_spans(recorder, clock):
    # A [0, 100) holds B [10, 40), which holds C [20, 30); A also holds D
    # [60, 80).  E [150, 160) is a second root.
    clock.extend([0, 10, 20, 30, 40, 60, 80, 100, 150, 160])
    with spans.span("A"):
        with spans.span("B"):
            with spans.span("C"):
                pass
        with spans.span("D"):
            pass
    with spans.span("E"):
        pass
    return spans.take()[0]


def test_idle_goes_to_the_innermost_span(recorder, clock):
    got = _hand_spans(recorder, clock)
    idle = [(0, 15), (25, 65), (90, 120), (155, 170)]
    by_name, unspanned = spans.attribute_idle(idle, got)
    assert by_name == {"A": 10 + 20 + 10, "B": 5 + 10, "C": 5, "D": 5, "E": 5}
    assert unspanned == 20 + 10
    # another thread's spans take none of it
    assert spans.attribute_idle(idle, got, thread=-1) == ({}, 15 + 40 + 30 + 15)


def test_idle_by_span_and_unspanned_add_up_to_the_idle_time(recorder, clock):
    """On a synthetic window: the device's busy intervals, their complement
    as the idle time (``window_s - busy_s``), and the spans above."""
    got = _hand_spans(recorder, clock)
    t0, t1 = -50, 200
    busy = [(-20, -5), (15, 25), (65, 90), (120, 150)]
    idle, t = [], t0
    for a, b in busy:
        if a > t:
            idle.append((t, a))
        t = b
    idle.append((t, t1))
    window_s = (t1 - t0) * 1e-9
    busy_s = sum(b - a for a, b in busy) * 1e-9
    by_name, unspanned = spans.attribute_idle(idle, got)
    assert abs((sum(by_name.values()) + unspanned) * 1e-9 - (window_s - busy_s)) < 1e-9
    assert by_name == {"A": 10 + 20 + 10, "B": 5 + 10, "C": 5, "D": 5, "E": 10}
    assert unspanned == 30 + 5 + 20 + 40


# -- a CPU run of the bi-block engine --------------------------------------------------------

#: IOStats fields that read a clock or a thread's timing, not the walks
TIMED = ("exec_time", "sim_wall_time", "writer_queue_peak")


def _engine_run(tmp_path, order, tag):
    bg = partition_into_n_blocks(erdos_renyi(240, 1200, seed=5), 4)
    path = str(tmp_path / f"graph_{tag}.grb")
    write_block_file(bg, path)
    disk = DiskBlockedGraph(path)
    if order == 2:
        task = rwnv_task(p=4.0, q=0.25, walks_per_vertex=2, length=8, seed=11)
    else:
        task = deepwalk_task(walks_per_vertex=2, length=8, seed=11)
    try:
        return BiBlockEngine(
            disk,
            task,
            loading="auto",
            record_walks=True,
            pool="disk",
            pool_flush_walks=16,
            pool_dir=str(tmp_path / f"pool_{tag}"),
            device="cpu",
        ).run()
    finally:
        disk.close()


@pytest.fixture(params=[2, 1], ids=["node2vec", "deepwalk"])
def runs(request, tmp_path):
    """The same task with spans off, then on: (off, on, spans, counts)."""
    order = request.param
    spans.disable()
    spans.take()
    off = _engine_run(tmp_path, order, "off")
    assert spans.take() == ([], {})
    spans.enable()
    try:
        on = _engine_run(tmp_path, order, "on")
    finally:
        spans.disable()
    got, counts = spans.take()
    return off, on, got, counts


def test_spans_change_nothing_the_run_computes(runs):
    off, on, _, _ = runs
    assert np.array_equal(off.corpus, on.corpus)
    assert np.array_equal(off.endpoint_counts, on.endpoint_counts)
    a, b = off.stats.as_dict(), on.stats.as_dict()
    for k in TIMED:
        a.pop(k), b.pop(k)
    assert a == b
    assert off.advance_calls == on.advance_calls


def test_every_span_nests_inside_the_run(runs):
    _, on, got, counts = runs
    names = {s.name for s in got}
    assert {"engine.init", "task.run", "init", "slot", "pool", "load", "advance"} <= names
    # the corpus is kept on the engine's device (here the CPU) and fetched
    # once: the CPU hands its tensor over, with no chunk through the ring
    assert {"advance.upload", "advance.exec", "corpus.fetch", "retire", "persist"} <= names
    assert "advance.record" not in names
    assert sum(s.name == "corpus.fetch" for s in got) == 1
    assert "corpus.fetch.chunks" not in counts
    if on.stats.supersteps and "bucket" in names:
        assert "route" in names
    by_index = {s.index: s for s in got}
    main = threading.get_ident()
    for s in got:
        assert s.thread == main and s.start <= s.end
        root = s
        while root.parent >= 0:
            parent = by_index[root.parent]
            assert parent.start <= root.start and root.end <= parent.end
            root = parent
        assert root.name in ("task.run", "engine.init"), s.name
    assert sum(s.name == "task.run" for s in got) == 1
    assert sum(s.name == "engine.init" for s in got) == 1


def test_advance_exec_adds_up_to_exec_time(runs):
    _, on, got, _ = runs
    execs = [s.end - s.start for s in got if s.name == "advance.exec"]
    assert len(execs) == on.advance_calls
    assert abs(sum(execs) * 1e-9 - on.stats.exec_time) <= 1e-6 * len(execs)
    assert sum(s.name == "advance" for s in got) == on.advance_calls


def test_loader_decisions_add_up_to_the_buckets(runs):
    _, on, got, counts = runs
    assert set(counts) <= {
        "load.full", "load.ondemand", "corpus.device", "slot.visits", "pair.segment.built",
        "pair.segment.kept",
    }  # fmt: skip
    # each call's one or two distinct views, each built or kept
    segments = counts.get("pair.segment.built", 0) + counts.get("pair.segment.kept", 0)
    assert on.advance_calls <= segments <= 2 * on.advance_calls
    n = counts.get("load.full", 0) + counts.get("load.ondemand", 0)
    assert n == on.stats.bucket_executions > 0
    decided = [s for s in got if s.name == "load" and "decision" in s.attrs]
    assert len(decided) == n
    for d in ("full", "ondemand"):
        assert sum(s.attrs["decision"] == d for s in decided) == counts.get(f"load.{d}", 0)
    assert all(s.attrs["eta"] >= 0 and s.attrs["cost"] > 0 for s in decided)


def _first_order_visits(corpus: np.ndarray, block_starts: np.ndarray):
    """Walk visits to first-order slots and the steps they took, from the
    corpus alone: the initialization advances each walk in its source block
    until it leaves it; after that, each maximal run of hops taken from one
    block is one visit."""
    visits = steps = 0
    for row in corpus:
        row = row[row >= 0]
        blocks = np.searchsorted(block_starts, row, side="right") - 1
        h = 1
        while h < len(row) and blocks[h] == blocks[0]:
            h += 1
        departures = blocks[h : len(row) - 1]  # blocks the slot hops start from
        steps += departures.size
        visits += int(departures.size and 1 + np.count_nonzero(np.diff(departures)))
    return visits, steps


def test_first_order_slots_carry_their_walks_and_steps(runs, request):
    _, on, got, counts = runs
    slots = [s for s in got if s.name == "slot"]
    assert slots
    if request.node.callspec.params["runs"] == 2:
        # the second-order path opens no new span attribute or counter
        assert "slot.visits" not in counts
        assert all(set(s.attrs) == {"block"} for s in slots)
        return
    assert all(set(s.attrs) == {"block", "walks", "steps"} for s in slots)
    walks = sum(s.attrs["walks"] for s in slots)
    steps = sum(s.attrs["steps"] for s in slots)
    assert walks == counts["slot.visits"] > 0
    bg = partition_into_n_blocks(erdos_renyi(240, 1200, seed=5), 4)
    assert (walks, steps) == _first_order_visits(on.corpus, np.asarray(bg.block_starts))
    assert 0 < steps < on.steps_sampled
