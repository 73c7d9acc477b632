"""The port's cost slice on the CPU: the latency chain (cost/measure.py),
save_lat_lookup, the table maker tfnas_tpu_torch.make_lat_lut against
make_lat_lut_tpu.py, and the port's bench on the tiny space. The measured
numbers here are host times of the CPU; the tests check the plumbing, the
schema and the analytic formulas (exact), not the values."""

import json
import math
import os
import pickle

import pytest
import torch

import make_lat_lut_tpu as jlut
from tfnas_tpu.cost import lut as jcost
from tfnas_tpu.models import search_space as jss
from tfnas_tpu_torch import bench
from tfnas_tpu_torch import make_lat_lut as tlut
from tfnas_tpu_torch.cost import lut as tcost
from tfnas_tpu_torch.cost.measure import (Chain, measure_latency_in_ms,
                                          measure_model_latency_in_ms)
from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.models.eval_net import EvalNetwork

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V5E = dict(peak_flops=tcost.ANALYTIC_PEAK_FLOPS,
           peak_bw=tcost.ANALYTIC_PEAK_BW)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: the tests run in parallel workers,
    and torch's thread pools contending for the cores slow these
    many-small-op runs by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chain_feeds_each_output_into_the_next_call():
    """x_i = x0 with its first element moved by 1e-30 * out_{i-1}[0]: with
    out = 1e30 * x the first element counts the calls; a chain whose
    output were ignored would stay at x0."""
    x0 = torch.ones(3)
    chain = Chain(lambda x: x * 1e30, (x0,), iters=4)
    chain.run()
    assert chain.x[0].item() == pytest.approx(4.0)
    assert chain.c.item() == pytest.approx(4.0)
    assert torch.equal(chain.x[1:], x0[1:]) and x0[0] == 1.0  # x0 untouched
    chain.run()
    assert chain.x[0].item() == pytest.approx(8.0)


def test_measure_latency_is_positive_and_finite():
    w = torch.randn(64, 64)
    ms = measure_latency_in_ms(lambda w, x: x @ w, (w, torch.randn(8, 64)),
                               warmup=2, iters=5, repeats=3)
    assert math.isfinite(ms) and ms > 0


def test_measure_model_latency_on_a_tiny_eval_net():
    cfg = json.load(open(os.path.join(ROOT, "configs",
                                      "tfnas_a_tpu.config")))
    net = EvalNetwork.from_config(10, cfg)
    for fold in (True, False):
        ms = measure_model_latency_in_ms(net, 2, image_size=32,
                                         dtype=torch.float32, warmup=1,
                                         iters=2, fold_bn=fold, device="cpu")
        assert math.isfinite(ms) and ms > 0


def test_save_lat_lookup_bytes_match_jax(tmp_path):
    table = tcost.build_space_analytic_lut(tss.tiny_space(32))
    jcost.save_lat_lookup(table, str(tmp_path / "j.pkl"))
    tcost.save_lat_lookup(table, str(tmp_path / "t.pkl"))
    assert (tmp_path / "t.pkl").read_bytes() == \
        (tmp_path / "j.pkl").read_bytes()
    assert tcost.load_lat_lookup(str(tmp_path / "t.pkl")) == table


def test_analytic_tables_match_jax_at_its_constants():
    """With make_lat_lut_tpu.py's v5e constants the port's make_lat_lut
    gives the JAX tables exactly; its default constants are the H100's."""
    assert pickle.dumps(tlut.build_analytic_lut(32, **V5E)) == \
        pickle.dumps(jlut.build_analytic_lut(32))
    assert pickle.dumps(tlut.build_analytic_lut(8, 1.5, **V5E)) == \
        pickle.dumps(jlut.build_analytic_lut(8, 1.5))
    assert tlut.analytic_base_ms(32, **V5E) == jlut.analytic_base_ms(32)
    for res in (16, 32):
        assert pickle.dumps(tcost.build_space_analytic_lut(
            tss.tiny_space(res))) == pickle.dumps(
            jlut.build_space_analytic_lut(jss.tiny_space(res)))
    assert [k[0] for k in tlut.site_keys()] == \
        [k for k in jlut.build_analytic_lut(32) if k != "base"]
    h100 = tlut.build_analytic_lut(32)
    assert list(h100) == list(jlut.build_analytic_lut(32))
    assert h100["base"] < jlut.build_analytic_lut(32)["base"]
    assert tlut.mc_points(192, 16) == [1] + list(range(12, 193, 12))


def test_measured_lut_schema_and_resume(tmp_path, capsys):
    out = str(tmp_path / "lut.pkl")
    args = ["--mode", "measure", "--stride_points", "2", "--batch_size",
            "1", "--warmup", "1", "--iters", "2", "--device", "cpu",
            "--output", out]
    tlut.main(args + ["--max_keys", "1"])
    lut = tcost.load_lat_lookup(out)
    first = tlut.site_keys()[0]
    assert list(lut) == ["base", first[0]]
    assert lut["base"] > 0
    assert list(lut[first[0]]) == list(range(1, first[-1] + 1))
    vals = list(lut[first[0]].values())
    assert vals == sorted(vals) and all(v > 0 for v in vals)
    assert not os.path.exists(out + ".tmp")
    capsys.readouterr()
    lut2 = tlut.main(args + ["--max_keys", "2", "--resume"])
    log = capsys.readouterr().out
    assert "base = " in log and "(resumed)" in log
    assert f"{first[0]}: resumed" in log
    assert list(lut2) == ["base"] + [k[0] for k in tlut.site_keys()[:2]]
    assert lut2[first[0]] == lut[first[0]] and lut2["base"] == lut["base"]
    # the JAX package's loader reads the port's table
    assert jcost.load_lat_lookup(out).keys() == lut2.keys()
    # --space hybrid appends the ViT candidate's 5 keys to the 66
    hyb = tlut.main(["--space", "hybrid", "--output", out + ".hybrid"])
    assert list(hyb) == (["base"] + [k[0] for k in tlut.site_keys()]
                         + [k[0] for k in tlut.vit_keys()])
    assert [k for k in hyb if k.startswith("ViTBlock")] == [
        k for k in jlut.build_analytic_lut(space="hybrid")
        if k.startswith("ViTBlock")]
    assert jcost.load_lat_lookup(out + ".hybrid").keys() == hyb.keys()


def test_bench_prints_phases_and_summary_and_keeps_its_deadline(capsys):
    args = ["--device", "cpu", "--space", "tiny", "--image_size", "32",
            "--batch_size", "4", "--num_classes", "10", "--n_timed", "2",
            "--warm", "1", "--eval_batch", "2", "--eval_iters", "2"]
    summary = bench.main(args)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [l.get("phase") for l in lines] == ["search", "search", "eval",
                                               None]
    assert lines[-1] == summary and summary["complete"]
    assert summary["metric"] == "supernet_search_weight_steps_per_sec"
    assert summary["value"] > 0 and summary["vs_baseline"] > 0
    assert set(summary["secondary"]["serving_graphs"]) == {"folded", "s2d"}
    assert all(l["finite"] for l in lines[:2])

    cut = bench.main(args + ["--deadline", "0"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines[0]["cut"] and lines[-1] == cut
    assert not cut["complete"] and cut["value"] is None


def test_new_entry_points_refuse_cuda_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = str(tmp_path / "lut.pkl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlut.main(["--mode", "measure", "--output", out])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--space", "tiny"])
    assert not os.listdir(tmp_path)
    # the analytic table needs no device
    lut = tlut.main(["--output", out])
    assert tcost.load_lat_lookup(out).keys() == lut.keys()
