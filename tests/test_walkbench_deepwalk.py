"""The benchmark's DeepWalk cell (``deepwalk.graph500-s20-ram2``) on the CPU.

The program's first-order path (``BiBlockEngine._run_slot_first_order`` and
the order-1 advance) against the benchmark's plain reference
(``walkbench/reference.py``) on seeded Graph500 graphs at scale 10, in the
cell's placement (2 RAM blocks, the memory pool, every walk recorded,
length 80): corpus rows, endpoint counts and steps each exactly equal.  A
fault planted in the advance must make the cell's check read not correct;
the cell resolves to its configuration, traffic and metrics; and the
order-1 roofline reader counts its bytes and reads only order-1 kernels.
"""

import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from walkbench import harness, reference  # noqa: E402

CELL = "deepwalk.graph500-s20-ram2"
SCALE = 10
SEEDS = [2**31 + 11, 3434000021, 977]

torch.set_num_threads(1)


def small_cell(*, scale: int = SCALE, length: int = 80):
    """The cell at ``2**scale`` vertices and walks of at most ``length``
    hops, everything else as committed."""
    cell = harness.resolve_cell(CELL)
    cell.config = dict(cell.config, scale=scale)
    cell.traffic = dict(cell.traffic, length=min(int(cell.traffic["length"]), length))
    return cell


def test_the_cell_is_the_s20_graph_under_first_order_walks():
    cell = harness.resolve_cell(CELL)
    node2vec = harness.resolve_cell("rwnv.graph500-s20-ram2")
    graph = ("scale", "edge_factor", "A", "B", "C", "D", "graph", "blocks", "graph_storage",
             "walk_pool", "pool_flush_walks", "walks_per_vertex", "draw_precision")  # fmt: skip
    assert {k: cell.config[k] for k in graph} == {k: node2vec.config[k] for k in graph}
    assert cell.traffic["model"] == "deepwalk" and cell.traffic["starts"] == "every_vertex"
    assert (cell.traffic["length"], cell.traffic["decay"]) == (80, 1.0)
    assert cell.traffic["max_proposals"] == 16 and cell.traffic["record_walks"] is True
    assert harness.walk_params(cell.traffic)["p"] == harness.walk_params(cell.traffic)["q"] == 1.0
    assert cell.chips == 1


def test_the_cell_reports_its_metrics_and_no_others():
    cell = harness.resolve_cell(CELL)
    assert {m["name"] for m in cell.end_to_end} == {"walk_steps_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "graph_build_s",
        "host_ns_per_step",
        "io_bytes_per_step",
        "walk_pool_bytes_per_step",
        "ondemand_byte_share_pct",
        "exec_share_pct",
        "steps_per_advance_call",
        "device_idle_pct",
        "pair_advance_order1_roofline",
    }
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))


@pytest.mark.parametrize("seed", SEEDS)
def test_the_program_walks_the_reference_walks(seed):
    """One task of the cell, run by the program and by the reference: every
    corpus row, every endpoint count and the steps exactly equal."""
    from repro_torch.core import BiBlockEngine

    cell = small_cell()
    config, traffic = cell.config, cell.traffic
    edges = harness.make_edges(config, seed, "cpu")
    with tempfile.TemporaryDirectory() as work:
        bg = harness.build_graph(config, edges, Path(work))
        assert bg.num_blocks == 2
        plan = harness.task_plan(traffic, seed, 0, None)
        task = harness.program_task(traffic, config, plan)
        assert task.model.order == 1
        kw = harness.engine_kwargs(config, traffic, "cpu")
        assert kw["pool"] == "memory" and kw["record_walks"]
        res = BiBlockEngine(bg, task, **kw).run()
    src = torch.as_tensor(harness.walk_sources(traffic, config, plan))
    adj = reference.build_adjacency(edges, harness.num_vertices(config), "cpu")
    ref = reference.walk(adj, src, seed=plan["seed"], **harness.walk_params(traffic))
    assert res.num_walks == src.numel() == 2 * 2**SCALE
    assert torch.equal(torch.as_tensor(res.corpus), ref.corpus)
    assert torch.equal(torch.as_tensor(res.endpoint_counts), ref.endpoint_counts)
    assert int(res.steps_sampled) == ref.steps
    # most walks run their 80 hops and cross between the blocks on the way
    full = (ref.corpus[:, -1] >= 0).float().mean()
    assert full > 0.5
    # once few walks remain, the loader reads the current block on demand
    share = harness.metric_reader("ondemand_byte_share_pct")(
        {"tasks": [harness._task_record(res, 1.0)]}
    )
    assert 0 < share < 100
    assert int(res.stats.supersteps) > 1


def test_a_run_of_the_cell_is_correct():
    result = harness.run_cell(small_cell(), 2**32 + 5, 0.0, False, device="cpu", log=str)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 1 and result["failed"] == 0
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert set(result["metrics"]) == {"walk_steps_per_s", "setup_s"}


# -- faults planted in the first-order advance ------------------------------------------------


def _broken(fault):
    """The program's advance with ``fault`` applied to what it returns."""
    from repro_torch.kernels import pair_advance

    plain = pair_advance.fused_advance_pair

    def advance(*args, **kw):
        wid, prev, cur, hop, alive = args[9:14]
        out = list(plain(*args, **kw))
        return tuple(fault(out, wid, prev, cur, hop, alive))

    return advance


def _unchanged(out, wid, prev, cur, hop, alive):
    # the step returns its state as it came, the walks marked finished
    return [prev, cur, hop, torch.zeros_like(alive), torch.zeros_like(out[4]), out[5]]


def _lane_dropped(out, wid, prev, cur, hop, alive):
    # the first lane that moved keeps its state and ends there
    moved = torch.nonzero(out[2] > hop).flatten()
    drop = torch.arange(prev.numel()) == (moved[0] if moved.numel() else -1)
    out[0] = torch.where(drop, prev, out[0])
    out[1] = torch.where(drop, cur, out[1])
    out[2] = torch.where(drop, hop, out[2])
    out[3] = out[3] & ~drop
    out[4] = (out[2].long() - hop.long()).sum().to(out[4].dtype)
    return out


def _walk_shifted(out, wid, prev, cur, hop, alive):
    # the first lane that moved lands one vertex over
    moved = torch.nonzero(out[2] > hop).flatten()
    if moved.numel():
        out[1] = out[1].clone()
        out[1][moved[0]] += 1
    return out


@pytest.mark.parametrize("fault", [_unchanged, _lane_dropped, _walk_shifted])
def test_a_broken_first_order_advance_is_not_correct(monkeypatch, fault):
    from repro_torch.kernels import pair_advance

    monkeypatch.setattr(pair_advance, "fused_advance_pair", _broken(fault))
    cell = small_cell(scale=9, length=12)
    result = harness.run_cell(cell, 4321, 0.0, False, device="cpu", log=str)
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


def test_the_bfloat16_control_is_not_correct():
    from walkbench import control

    cell = small_cell(length=20)
    edges, outputs = control.control_outputs(cell, 17, 1, "cpu", torch.bfloat16)
    numbers, bad = harness.check(outputs, edges, cell.config, cell.traffic, "cpu")
    assert bad == 1 and numbers["walks_mismatched"] > 0 and not harness.verdict(numbers)


# -- the order-1 roofline reader --------------------------------------------------------------

ORDER1 = "void (anonymous namespace)::pair_advance_kernel<1, false>(...)"
ORDER2 = "void (anonymous namespace)::pair_advance_kernel<2, false>(...)"
SLOT_CHECK = "(anonymous namespace)::slot_check_kernel(int const*, int*, int)"
H100 = "NVIDIA H100 80GB HBM3"


def _record(kernels, *, trace=True, recorded=True, weighted=False, device_kind=H100):
    tr = None
    if trace:
        tr = {"busy_s": 0.5, "window_s": 5.0, "device_ops": [], "idle_gaps": [],
              "kernels": kernels}  # fmt: skip
    tasks = [dict(steps=3000), dict(steps=1000)]
    return dict(tasks=tasks, record_walks=recorded, weighted=weighted, device_kind=device_kind,
                trace=tr)  # fmt: skip


def _reader():
    return harness.metric_reader("pair_advance_order1_roofline")


@pytest.mark.parametrize(
    "recorded,weighted,step_bytes",
    [(True, False, 12 + 4), (False, False, 12), (True, True, 12 + 4 + 8)],
    ids=["recorded", "not-recorded", "weighted"],
)
def test_order1_roofline_byte_model(recorded, weighted, step_bytes):
    kernels = {
        ORDER1: {"seconds": 1e-3, "launches": 2, "threads": 2048},
        ORDER2: {"seconds": 9.0, "launches": 5, "threads": 10**6},
        SLOT_CHECK: {"seconds": 1.0, "launches": 2, "threads": 512},
    }
    got = _reader()(_record(kernels, recorded=recorded, weighted=weighted))
    # 2048 threads x 30 B of lane state + 4000 steps, over 1 ms at 3.35e12 B/s
    want = 100 * (2048 * 30 + 4000 * step_bytes) / 3.35e12 / 1e-3
    assert got == pytest.approx(want, rel=1e-12)


def test_order1_roofline_reads_nothing_it_cannot_count():
    only_order2 = {ORDER2: {"seconds": 1e-3, "launches": 2, "threads": 2048}}
    assert _reader()(_record(only_order2)) is None
    order1 = {ORDER1: {"seconds": 1e-3, "launches": 2, "threads": 2048}}
    assert _reader()(_record(order1, trace=False)) is None
    assert _reader()(_record(order1, device_kind="some other card")) is None
    unknown = {ORDER1: {"seconds": 1e-3, "launches": 2, "threads": None}}
    assert _reader()(_record(unknown)) is None
    assert _reader()(_record({})) is None  # a traced window with no kernel


def test_the_order2_roofline_leaves_its_count_as_it_was():
    """The order-2 reader keeps its 16 B a step; the order-1 reader differs
    from it only in the 4 B of the probe."""
    kernels = {ORDER1: {"seconds": 1e-3, "launches": 2, "threads": 2048}}
    rec = _record(kernels)
    old = harness.metric_reader("pair_advance_roofline")(rec)
    new = _reader()(rec)
    assert old - new == pytest.approx(100 * 4000 * 4 / 3.35e12 / 1e-3, rel=1e-9)

