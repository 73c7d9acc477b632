"""The benchmark's frozen FLOP rules against the port's cost/flops.py."""

import json

import pytest
import torch

from benchmark.flops import SupernetMacs, evalnet_macs
from benchmark.reference.evalnet import EvalNet
from benchmark.reference.supernet import Space, SuperNet
from benchmark.tests.tiny import ROOT
from tfnas_tpu_torch.cost.flops import calculate_FLOPs_in_M
from tfnas_tpu_torch.models.eval_net import EvalNetwork


def a_class():
    return json.loads((ROOT / "benchmark" / "configs" /
                       "tfnas_a_class.json").read_text())


def test_a_class_multiply_adds():
    cfg = a_class()
    ref = evalnet_macs(EvalNet(cfg["model_config"], 1000), 224) / 1e6
    port = calculate_FLOPs_in_M(EvalNetwork.from_config(
        1000, cfg["model_config"]), 224)
    assert ref == pytest.approx(335.301136, abs=1e-6)
    assert ref == pytest.approx(port, rel=1e-12)


@pytest.mark.parametrize("ops", [[0] * 18, [7] * 18, list(range(8)) * 2
                                 + [3, 5]])
def test_sampled_path_is_the_eval_net_of_its_picks(ops):
    """A sampled path of the search cell's supernet counts as the eval
    net of the same candidates at the same live widths."""
    from tfnas_tpu_torch.search.parser import get_mc_num_dddict
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "tfnas_search_in100.json").read_text())
    space = Space(cfg["space"], 224)
    net = SuperNet(space, 100)
    mc = space.mc_mask_dddict()
    macs = SupernetMacs(net, mc)
    parsed = {}
    for s in space.sites:
        parsed.setdefault(s.stage, {})[s.block] = ops[s.global_idx]
    port = EvalNetwork.from_parsed_arch(100, parsed, get_mc_num_dddict(mc))
    want = calculate_FLOPs_in_M(port, 224) * 1e6
    got = macs.stem + macs.sampled(torch.tensor(ops))
    assert got == pytest.approx(want, rel=1e-12)
    # a weight step: the stem once and both paths, 3x, 2 FLOPs a MAC
    idx = torch.tensor(ops)
    assert macs.weight_step(idx, idx, 2) == pytest.approx(
        2 * 3 * 2 * (2 * got - macs.stem), rel=1e-12)
