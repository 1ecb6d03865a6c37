"""The control, the reference in the program's place one precision down,
and the faults read above each cell's limits (``control.py``; on the card
it runs at the cells' own sizes, on three seeds or more). TF32 exists on
the card only; the fault readings run here too."""

from __future__ import annotations

import pytest
import torch

from portbench import control
from portbench.cell import load_cell


def test_fault_readings_fail_the_checks(checkout):
    for w in ("tiny-fit", "tiny-decode"):
        cell = load_cell(w, checkout)
        got = control.reading(cell, 2 ** 31 + 7, "faults", torch.device("cpu"))
        for key, value in got.items():
            assert value > cell.config["limits"][key.split(".")[0]], key


@pytest.mark.cuda
@pytest.mark.parametrize("workload,number", [("tiny-decode", "rms_gap"),
                                             ("tiny-fit", "loss_gap")])
def test_tf32_control_fails_the_checks(checkout, workload, number):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on the card only")
    cell = load_cell(workload, checkout)
    got = control.reading(cell, 2 ** 31 + 7, "tf32", torch.device("cuda"))
    assert got[number] > cell.config["limits"][number]
