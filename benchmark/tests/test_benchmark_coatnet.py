"""The CoAtNet retrain cell on the CPU at a tiny size (L = (2, 1, 1, 2, 1),
D = (16, 16, 32, 64, 64), 64^2, batch 4, float32, limits for a float32
program, which matches the reference to round-off): its check holds,
each planted fault of the bias and its reference-side counterparts turn
it false, the float8 control fails a number, its FLOP count matches the
port's (two thirds of it in the transformer stages), and a --trace 1 run
reports the cell's metrics (the block spans read nothing off the card).
"""

import argparse
import json
import time

import pytest
import torch

from benchmark import flops_coatnet, harness
from benchmark.harness import BENCH
from benchmark.reference import coatnet as rc
from benchmark.tests import faults_coatnet

CELL = "retrain.coatnet2.b128.synth"


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tiny():
    cfg = json.loads((BENCH / "configs" / "coatnet2_in1k.json").read_text())
    cfg.update(image_size=64, dtype="float32", num_classes=10,
               model_config=rc.model_config(
                   (2, 1, 1, 2, 1), (16, 16, 32, 64, 64), 64, 10))
    tr = json.loads((BENCH / "traffic" / f"{CELL}.json").read_text())
    tr.update(batch_size=4, synth_batches=3, trace_steps=2,
              limits={k: 1e-4 for k in tr["limits"]})
    return {"name": "tiny.coatnet", "chips": 1}, cfg, tr


def run_cell(seed=7, trace=0):
    cell, cfg, tr = tiny()
    return harness.run_on("cpu", cell, cfg, tr, seed, 0.2, trace)


def test_check_holds():
    run = run_cell()
    assert harness.verdict(run.checks), run.checks
    assert {n for n, _, _ in run.checks} == {
        "grad_gap.weights", "update_gap.weights", "bn_diff",
        "grad_diff.rel_bias"}


@pytest.mark.parametrize("fault", [faults_coatnet.bias_left_out,
                                   faults_coatnet.bias_transposed])
def test_planted_bias_fault_fails_the_check(monkeypatch, fault):
    fault(monkeypatch)
    run = run_cell()
    assert not harness.verdict(run.checks)
    assert run.readings["grad_diff.rel_bias"] > 0.3, run.readings


def _control(mode):
    cell, cfg, tr = tiny()
    args = argparse.Namespace(workload=cell["name"], seed=3, seconds=0.1,
                              trace=0)
    run = harness.Run(args, cell, cfg, tr, time.perf_counter(),
                      torch.device("cpu"))
    return tr, harness.driver(tr).control(run, mode)


@pytest.mark.parametrize("mode", ["float8", "no_bias", "transposed"])
def test_control_and_reference_faults_fail_a_number(mode):
    tr, got = _control(mode)
    assert any(got[k] > v for k, v in tr["limits"].items()), got
    if mode != "float8":
        assert got["grad_diff.rel_bias"] > 0.3, got


def test_traced_run_reports_the_cell_metrics():
    man = harness.manifest()
    run = run_cell(trace=1)
    got = harness.read_metrics(man, CELL, 1, run.rec)
    assert "idle_share.train" in got  # no peak rate and no events here
    # the block spans record device events on a card only
    assert "attn_block_ms.coatnet" not in got
    e2e = harness.read_metrics(man, CELL, 0, run.rec)
    assert set(e2e) == {"train_img_per_s", "setup_s"}


def test_flops_match_the_port_and_the_hand_count():
    from tfnas_tpu_torch.cost.flops import calculate_FLOPs_in_M
    from tfnas_tpu_torch.models.eval_net import EvalNetwork
    cfg = json.loads((BENCH / "configs" / "coatnet2_in1k.json").read_text())
    net = rc.CoAtNet(cfg["model_config"], 1000)
    macs = flops_coatnet.coatnet_macs(net, 224)
    port = EvalNetwork.from_config(1000, cfg["model_config"])
    assert macs == pytest.approx(calculate_FLOPs_in_M(port) * 1e6, rel=1e-12)
    res, attn = 224, 0.0
    for layer in [net.first_stem, net.second_stem] + net.blocks:
        f, res = flops_coatnet.layer_macs(layer, res)
        attn += f if isinstance(layer, rc.RelTransformerBlock) else 0.0
    assert macs / 1e9 == pytest.approx(15.5246, abs=1e-4)
    assert 0.66 < attn / macs < 0.67  # the hand count's 10.34 of 15.52 G
