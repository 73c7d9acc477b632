"""The plain reference against the port's timed paths, at sizes a CPU
holds: each tiny cell run through the harness on the CPU (the program in
float32) reads its compared numbers at round-off, and the harness calls
it correct."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("make,trace", [
    (tiny.search, 0), (tiny.search, 1),
    (lambda: tiny.retrain("synth"), 0), (lambda: tiny.retrain("jpeg"), 1),
    (tiny.serve, 0), (tiny.serve, 1)])
def test_cell_matches_reference_on_cpu(make, trace):
    cell, cfg, tr = make()
    run = harness.run_on("cpu", cell, cfg, tr, 2 ** 33 + 17, 0.5, trace)
    assert run.checks and harness.verdict(run.checks), run.checks
    assert run.rec.window_s >= 0.5 and run.rec.setup_s > 0
    assert run.rec.counts["attempted"] > 0
    if trace:
        assert run.rec.trace["window_s"] > 0


def test_search_picks_and_losses_follow_the_program():
    cell, cfg, tr = tiny.search()
    run = harness.run_on("cpu", cell, cfg, tr, 5, 0.2)
    assert run.readings["pick_mismatch"] == 0
    assert run.readings["loss_gap"] < 1e-5
