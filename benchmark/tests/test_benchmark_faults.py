"""The check comes out false where the timed path is broken underneath a
run, for each fault a cell can have, and its control (the reference in
float8 put in the program's place) fails at least one compared number.
The tiny cells on the CPU (limits for a float32 program there); the
cells' own sizes are read on the card with benchmark/sweep.py."""

import argparse
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import faults, tiny


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def run_cell(make, seed=7):
    cell, cfg, tr = make()
    return harness.run_on("cpu", cell, cfg, tr, seed, 0.2)


def failed(run):
    return not harness.verdict(run.checks)


@pytest.mark.parametrize("make,fault", [
    (tiny.search, faults.search_state_unchanged),
    (tiny.search, faults.search_half_batch),
    (tiny.search, faults.search_alphas_unchanged),
    (lambda: tiny.retrain("synth"), faults.retrain_state_unchanged),
    (lambda: tiny.retrain("synth"), faults.retrain_half_batch),
    (lambda: tiny.retrain("jpeg"), faults.pixels_altered),
    (tiny.serve, faults.logit_altered),
    (tiny.serve, faults.served_half_batch)])
def test_fault_fails_the_check(monkeypatch, make, fault):
    fault(monkeypatch)
    assert failed(run_cell(make))


@pytest.mark.parametrize("fault,number", [
    (faults.search_state_unchanged, "update_diff.weights"),
    (faults.search_alphas_unchanged, "update_gap.log_alphas")])
def test_state_unchanged_reads_one(fault, number):
    with pytest.MonkeyPatch.context() as mp:
        fault(mp)
        run = run_cell(tiny.search)
    assert run.readings[number] == pytest.approx(1.0)


@pytest.mark.parametrize("make", [
    tiny.search, lambda: tiny.retrain("synth"), tiny.serve])
def test_control_fails_a_number(make):
    cell, cfg, tr = make()
    args = argparse.Namespace(workload=cell["name"], seed=3, seconds=0.1,
                              trace=0)
    run = harness.Run(args, cell, cfg, tr, time.perf_counter(),
                      torch.device("cpu"))
    got = harness.driver(tr).control(run, "float8")
    assert any(got[k] > v for k, v in tr["limits"].items() if k in got), got
