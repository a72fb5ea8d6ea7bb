"""On the card: the comparison passes the program as the configuration
states it (float64) and fails its float32 path, the control, at the cell's
own size. Skips without a card."""

import pytest
import torch

from gpu_bench import run


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["da.opt1", "da.orient16"])
def test_control_fails_and_the_program_passes(cuda_card, root, cell):
    seed = 2 ** 31 + 77
    res, _ = run.run_cell(root, cell, seed, 0.5, 0)
    assert res["correct"] is True
    ctl, _ = run.run_cell(root, cell, seed, 0.5, 0, dtype=torch.float32)
    assert ctl["correct"] is False
    fails = [k for k, c in ctl["checks"].items() if c["value"] > c["limit"]]
    assert {"energy_gap", "gradient_gap"} <= set(fails)
