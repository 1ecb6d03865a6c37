"""A run with the timed path broken underneath reads ``correct`` false: once
for each fault the cells can have (one chip, so no exchange between chips).
The faults are ``control.planted``'s; the ``replay_*`` ones act from each
fit's second chunk on, which on the card is what the graph replays. The
runs skip only the runner's look for a card (``run.run_cell`` on the CPU)."""

from __future__ import annotations

import pytest

from portbench import control


def test_sound_runs_are_correct(checkout, run_cell):
    for w in ("tiny-fit", "tiny-decode"):
        res = run_cell(checkout, w)
        assert res["correct"] is True, res["checks"]
        assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("fault,number", [("unchanged_state", "loss_gap"),
                                          ("half_batch", "loss_gap"),
                                          ("replay_unchanged_state", "replay_loss_gap"),
                                          ("replay_half_batch", "replay_loss_gap"),
                                          ("raw_prune", "prune_miss"),
                                          ("altered_answer", "psnr_gap")])
def test_fit_faults_are_caught(checkout, run_cell, fault, number):
    with control.planted(fault):
        res = run_cell(checkout, "tiny-fit")
    assert res["correct"] is False
    c = res["checks"][number]
    assert c["value"] > c["limit"]
    if fault.startswith("replay_"):     # the start, before any replay, reads sound
        assert res["checks"]["loss_gap"]["value"] <= res["checks"]["loss_gap"]["limit"]


@pytest.mark.parametrize("fault", ["altered_image", "altered_token"])
def test_decode_faults_are_caught(checkout, run_cell, fault):
    with control.planted(fault):
        res = run_cell(checkout, "tiny-decode")
    assert res["correct"] is False
    assert res["checks"]["rms_gap"]["value"] > res["checks"]["rms_gap"]["limit"]
