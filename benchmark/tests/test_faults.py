"""What decides ``correct`` fails what it has to: each fault a cell can
have, planted underneath the timed path of a whole run, and the control in
the program's place.

The faults run here at the tiny sizes on the CPU, through everything a run
does but the look for a card. The control runs on the card at the cell's
own size (``-m card``), since what it reads depends on that size."""

import pytest
import torch

from benchmark import faults, harness
from benchmark.tests.tiny import tiny_cell

CASES = [("rgbnt201.train", "frozen_state"), ("rgbnt201.train", "half_batch"),
         ("rgbnt201_s12.train", "half_batch"), ("rgbnt201.eval", "altered_answer"),
         ("rgbnt201_s12.eval", "altered_answer")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_makes_the_run_incorrect(cell, fault):
    with faults.FAULTS[fault]():
        result, checks = harness.run_cell(tiny_cell(cell), 2**31 + 11, 0.3, False, "cpu", 0.0,
                                          log=lambda s: None)
    assert result["correct"] is False
    assert any(v > lim for v, lim in checks.values())


@pytest.mark.card
@pytest.mark.parametrize("cell", ["rgbnt201.train", "rgbnt201.eval", "rgbnt201_s12.train",
                                  "rgbnt201_s12.eval"])
def test_the_control_is_incorrect_at_the_cells_size(card, cell):
    c = harness.load_cell(cell)
    run = harness.Run(c, 2**31 + 13, 1.0, False, card, 0.0, log=lambda s: None)
    numbers = faults.control_numbers(run)
    torch.cuda.empty_cache()
    assert any(v > c.limits[k] for k, v in numbers.items()), numbers
