"""The reference that decides ``correct``: Threefry's published answers, the
graph it rebuilds, exact agreement with the program on the CPU, and the
faults and the control that it must reject."""

import numpy as np
import pytest
import torch

from walkbench import control, harness, reference
from walkbench.tests.conftest import CELLS, small_cell

# Random123's known-answer vectors for Threefry-2x32, 20 rounds:
# (key0, key1, counter0, counter1) -> (out0, out1)
KAT = [
    ((0, 0, 0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
]


@pytest.mark.parametrize("args,want", KAT)
def test_threefry_known_answers(args, want):
    k0, k1, x0, x1 = (torch.tensor([v], dtype=torch.int64) for v in args)
    y0, y1 = reference.threefry2x32(k0, k1, x0, x1)
    assert (int(y0), int(y1)) == want


def test_unit_float_is_the_float32_bit_trick():
    bits = torch.tensor([0, 1 << 9, 0xFFFFFFFF, 0x80000000], dtype=torch.int64)
    trick = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    assert torch.equal(reference.unit_float(bits), trick)
    assert float(reference.unit_float(bits).max()) < 1.0


def test_adjacency_is_the_undirected_simple_graph():
    edges = np.array([[0, 1], [1, 0], [2, 2], [3, 1], [0, 1], [4, 0]])
    adj = reference.build_adjacency(edges, 6, "cpu")
    rows = {v: adj.neighbours[adj.indptr[v] : adj.indptr[v + 1]].tolist() for v in range(6)}
    assert rows == {0: [1, 4], 1: [0, 3], 2: [], 3: [1], 4: [0], 5: []}
    u = torch.tensor([0, 1, 2, 4, 5])
    v = torch.tensor([4, 3, 2, 1, 0])
    assert adj.has_edge(u, v).tolist() == [True, True, False, False, False]


@pytest.mark.parametrize("name", CELLS)
def test_a_run_on_the_cpu_is_correct(name):
    result = harness.run_cell(small_cell(name), 2**31 + 99, 0.0, False, device="cpu", log=str)
    assert result["correct"], result["checks"]
    assert result["attempted"] == 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"walk_steps_per_s", "setup_s"}
    assert list(result)[-1] == "checks"


def _reference_output(cell, seed=5):
    edges, outputs = control.control_outputs(cell, seed, 1, "cpu", torch.float32)
    return edges, outputs[0]


def test_check_rejects_a_non_edge_step_and_a_missing_walk():
    cell = small_cell("rwnv.graph500-s20-ram2")
    edges, out = _reference_output(cell)
    numbers, bad = harness.check([out], edges, cell.config, cell.traffic, "cpu")
    assert harness.verdict(numbers) and bad == 0
    adj = reference.build_adjacency(edges, harness.num_vertices(cell.config), "cpu")
    w = int(np.flatnonzero(out.corpus[:, 2] >= 0)[0])
    a, b = int(out.corpus[w, 1]), int(out.corpus[w, 2])
    row = adj.neighbours[adj.indptr[a] : adj.indptr[a + 1]].tolist()
    out.corpus[w, 2] = next(x for x in range(len(out.endpoint_counts)) if x not in row)
    assert out.corpus[w, 2] != b
    out.corpus[w + 1, 1:] = -1  # a walk that never came back from the pool
    numbers, bad = harness.check([out], edges, cell.config, cell.traffic, "cpu")
    assert numbers["walks_mismatched"] == 2 and bad == 1
    assert not harness.verdict(numbers)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = small_cell(name, scale=10, length=20)
    edges, outputs = control.control_outputs(cell, 11, 1, "cpu", torch.bfloat16)
    numbers, bad = harness.check(outputs, edges, cell.config, cell.traffic, "cpu")
    assert bad == 1 and not harness.verdict(numbers), numbers


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
    return [prev, cur, hop, torch.zeros_like(alive), torch.zeros_like(out[4]), out[5] * 0 - 1]


def _half_left_out(out, wid, prev, cur, hop, alive):
    # every other lane is dropped: it keeps its state and ends there
    drop = torch.arange(prev.numel()) % 2 == 1
    out[0] = torch.where(drop, prev, out[0])
    out[1] = torch.where(drop, cur, out[1])
    out[2] = torch.where(drop, hop, out[2])
    out[3] = out[3] & ~drop
    out[4] = (out[2].long() - hop.long()).sum().to(out[4].dtype)
    out[5] = torch.where(drop[:, None], -1, out[5]) if out[5].shape[0] == drop.numel() else out[5]
    return out


def _answer_altered(out, wid, prev, cur, hop, alive):
    # the first lane that moved lands one vertex over
    moved = torch.nonzero(out[2] > hop).flatten()
    if moved.numel():
        out[1] = out[1].clone()
        out[1][moved[0]] += 1
    return out


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _answer_altered])
@pytest.mark.parametrize("name", ["rwnv.graph500-s18-disk16", "prnv.graph500-s20-ram2"])
def test_a_broken_advance_is_not_correct(monkeypatch, name, fault):
    from repro_torch.kernels import pair_advance

    monkeypatch.setattr(pair_advance, "fused_advance_pair", _broken(fault))
    result = harness.run_cell(small_cell(name), 1234, 0.0, False, device="cpu", log=str)
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


def test_a_first_order_traffic_is_data_only():
    # a DeepWalk mix (paper section 7.8) needs no new code: the same run and check
    cell = small_cell("rwnv.graph500-s18-disk16")
    cell.traffic = dict(cell.traffic, name="deepwalk", model="deepwalk")
    result = harness.run_cell(cell, 2**31 + 3, 0.0, False, device="cpu", log=str)
    assert result["correct"], result["checks"]
