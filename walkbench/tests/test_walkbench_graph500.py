"""The benchmark's Graph500 generator: one edge list a seed, labels permuted
by a bijection, the quadrant probabilities of the specification."""

import numpy as np
import pytest
import torch

from walkbench import graph500

ABC = (0.57, 0.19, 0.19)


def test_same_seed_same_edges_and_other_seed_other_edges():
    a = graph500.kronecker_edges(10, 16, *ABC, seed=2**31 + 5)
    b = graph500.kronecker_edges(10, 16, *ABC, seed=2**31 + 5)
    c = graph500.kronecker_edges(10, 16, *ABC, seed=2**31 + 6)
    assert a.shape == (16 * 1024, 2) and a.dtype == np.int64
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    assert a.min() >= 0 and a.max() < 1024


def test_labels_are_permuted_by_a_bijection():
    ii, jj, perm = graph500.kronecker_parts(9, 16, *ABC, seed=77)
    np.testing.assert_array_equal(torch.sort(perm).values.numpy(), np.arange(512))
    edges = graph500.kronecker_edges(9, 16, *ABC, seed=77)
    np.testing.assert_array_equal(edges[:, 0], perm[ii].numpy())
    np.testing.assert_array_equal(edges[:, 1], perm[jj].numpy())
    # the permutation moves labels: the hub of the unpermuted graph is vertex 0
    assert (perm != torch.arange(512)).any()


def test_each_level_draws_the_specified_quadrants():
    scale = 10
    ii, jj, _ = graph500.kronecker_parts(scale, 16, *ABC, seed=3)
    a, b, c = ABC
    d = 1 - a - b - c
    for bit in range(scale):
        i_bit = ((ii >> bit) & 1).bool()
        j_bit = ((jj >> bit) & 1).bool()
        # P(row bit) = C + D; P(col bit | row 0) = B / (A + B); P(col bit | row 1) = D / (C + D)
        assert i_bit.float().mean().item() == pytest.approx(c + d, abs=0.015)
        assert j_bit[~i_bit].float().mean().item() == pytest.approx(b / (a + b), abs=0.015)
        assert j_bit[i_bit].float().mean().item() == pytest.approx(d / (c + d), abs=0.025)


def test_non_isolated_counts_only_edges_that_are_not_loops():
    edges = np.array([[0, 1], [2, 2], [3, 1], [4, 4], [4, 4]])
    np.testing.assert_array_equal(graph500.non_isolated(edges, 6), [0, 1, 3])


def test_task_streams_are_fixed_by_seed_and_task():
    draw = lambda s, k: int(graph500.task_rng(s, k).integers(0, 2**31))  # noqa: E731
    assert draw(2**33 + 1, 0) == draw(2**33 + 1, 0)
    assert len({draw(2**33 + 1, k) for k in (-1, 0, 1, 2)}) == 4
    assert draw(2**33 + 1, 0) != draw(2**33 + 2, 0)
