"""On the card: a small run of each cell is correct.  Skips without one."""

import pytest

from walkbench import harness
from walkbench.tests.conftest import CELLS, small_cell


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_on_the_card_is_correct(cuda, name):
    result = harness.run_cell(small_cell(name, scale=14, length=20), 7, 0.0, False,
                              device=cuda, log=str)  # fmt: skip
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
