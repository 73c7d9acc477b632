"""The port's counterparts of the JAX package's root tools, on the CPU.

- tools_search_report and tools_family_table against the JAX tools on the
  committed run directories (floats 1e-6);
- tools_seed_vit_alpha writes the JAX tool's bytes;
- the learnability probe's CNN (forward and Adam steps) against the JAX
  tool's, weights carried across (1e-5), and both of its modes at a tiny
  size;
- the measuring tools (occupancy, scan, hybrid, eval and loader
  throughput) run with --device cpu at a tiny size, and their JSON carries
  the JAX tools' keys.

The JAX tools build their networks' parameters only to count them; the
references here take those counts from jax.eval_shape of the same init,
which gives the same shapes without the CPU's minutes of initialisation.
Torch runs on one thread here: beside the suite's other workers, each
with its own thread pool, the full-width hybrid steps slowed a
hundredfold on the CPU's oversubscribed threads.
"""

import glob
import json
import math
import os
import pickle
import re
import sys

import jax
import numpy as np
import pytest
import torch

import tools_family_table as jft
import tools_proxy_learnability as jlearn
import tools_search_report as jsr
import tools_seed_vit_alpha as jseed
from tfnas_tpu.cost.flops import calculate_FLOPs_in_M as jflops
from tfnas_tpu.models.eval_net import EvalNetwork as JEval
from tfnas_tpu.search.parser import (get_mc_num_dddict as jmc_num,
                                     get_op_and_depth_weights as jweights,
                                     parse_architecture as jparse)
from tfnas_tpu_torch import (tools_eval_throughput, tools_family_table,
                             tools_hybrid_bench, tools_loader_throughput,
                             tools_occupancy_ab, tools_proxy_learnability,
                             tools_scan_ab, tools_search_report,
                             tools_seed_vit_alpha)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E2E = os.path.join(REPO, "checkpoints_e2e")
BOOST = os.path.join(E2E, "proxy60-ref-recipe-boost", "search-*")
HYBRID = glob.glob(os.path.join(E2E, "hybrid-e2e", "search-*"))[0]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def shapes_only_init(monkeypatch):
    """JAX's EvalNetwork.init through jax.eval_shape: the parameter
    shapes, without running the initialisers."""
    init = JEval.init
    monkeypatch.setattr(JEval, "init", lambda self, key: jax.eval_shape(
        lambda k: init(self, k), key))


def _close(a, b, path="report"):
    """a == b, numbers within 1e-6, through dicts and sequences."""
    if isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _close(u, v, f"{path}[{i}]")
    elif isinstance(b, float):
        assert abs(a - b) <= 1e-6, (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("run_dir, space", [(BOOST, "mbconv"),
                                            (HYBRID, "hybrid")])
def test_search_report_matches_jax(run_dir, space, tmp_path, capsys,
                                   shapes_only_init):
    out = tmp_path / "report.json"
    tools_search_report.main(["--run_dir", run_dir, "--space", space,
                              "--json_out", str(out), "--device", "cpu"])
    text = capsys.readouterr().out
    got = json.loads(out.read_text())
    # the JAX tool's report (its --json_out dies unpacking 5-tuples into
    # 4 names, so the JSON is assembled from its own functions)
    d = glob.glob(run_dir)[0] if "*" in run_dir else run_dir
    epochs, lats, vals = jsr.parse_log(d)
    ckpts = sorted(glob.glob(os.path.join(d, "arch_params_*.pkl")))
    stats = jsr.alpha_stats(ckpts)
    op_w, depth_w = jweights(ckpts[-1])
    parsed = jparse(op_w, depth_w)
    with open(ckpts[-1], "rb") as f:
        mc = pickle.load(f)["mc_mask_dddict"]
    net = JEval.from_parsed_arch(1000, parsed, jmc_num(mc))
    flops = jflops(net, input_size=224)
    n_params = sum(int(np.prod(v.shape)) for v in
                   jax.tree_util.tree_leaves(net.init(
                       jax.random.PRNGKey(0))[0]))
    want = {"train": epochs, "lat": lats, "val": vals,
            "alpha": [(s[0], s[1]) for s in stats],
            "final_argmax": stats[-1][2], "betas_first": stats[0][3],
            "betas_last": stats[-1][3], "flops_M": round(flops, 1),
            "params_M": round(n_params / 1e6, 2),
            "nearest_class": min(
                jsr_classes := {"TF-NAS-A": 457, "TF-NAS-B": 361,
                                "TF-NAS-C": 284, "TF-NAS-D": 219},
                key=lambda k: abs(jsr_classes[k] - flops))}
    _close(got, json.loads(json.dumps(want)))
    assert f"FLOPs: {flops:.1f}M  params: {n_params / 1e6:.2f}M" in text
    assert ("ViT candidate (op 8)" in text) == (space == "hybrid")


def _run_jax_tool(module, argv, capsys):
    old = sys.argv
    sys.argv = [module.__file__] + argv
    try:
        module.main()
    finally:
        sys.argv = old
    return capsys.readouterr().out


def test_family_table_matches_jax(capsys, shapes_only_init):
    argv = ["--root", os.path.relpath(E2E, os.getcwd()), "--json"]
    cpu = ["--device", "cpu"]
    got = tools_family_table.main(argv + cpu)
    capsys.readouterr()
    want = json.loads(_run_jax_tool(jft, argv, capsys).strip())
    assert len(want) >= 9
    _close(json.loads(json.dumps(got)), want)
    # one table for every run (the hybrid runs: its _hybrid sibling)
    tpu = os.path.join(REPO, "latency_pkl", "latency_tpu_v5e_bs32.pkl")
    rows = tools_family_table.main(argv + cpu + ["--lookup_path", tpu])
    capsys.readouterr()
    _close(rows, json.loads(json.dumps(got)))  # what the runs searched on
    h100 = os.path.join(REPO, "latency_pkl", "latency_h100.pkl")
    rows = tools_family_table.main(argv + cpu + ["--lookup_path", h100])
    capsys.readouterr()
    assert all(r["lut_lat_ms"] > 10 * w["lut_lat_ms"]
               for r, w in zip(rows, want))


def test_family_table_band_and_markdown(capsys):
    lut = os.path.join(REPO, "latency_pkl", "latency_tpu_v5e_bs32.pkl")
    assert tools_family_table.band_bounds(lut) == jft.band_bounds(lut)
    lines = _run_jax_tool(jft, ["--root", "no-runs-here", "--band", lut],
                          capsys)
    tools_family_table.main(["--root", "no-runs-here", "--band", lut,
                             "--device", "cpu"])
    assert capsys.readouterr().out == lines


@pytest.mark.parametrize("extra", [[], ["--blocks", "12", "15",
                                        "--boost", "2.5"]])
def test_seed_vit_alpha_writes_the_jax_bytes(extra, tmp_path, capsys):
    ckpt = sorted(glob.glob(os.path.join(HYBRID, "arch_params_*.pkl")))[-1]
    args = ["--ckpt", ckpt] + extra
    _run_jax_tool(jseed, args + ["--out", str(tmp_path / "jax.pkl")], capsys)
    tools_seed_vit_alpha.main(args + ["--out", str(tmp_path / "port.pkl")])
    assert ((tmp_path / "port.pkl").read_bytes()
            == (tmp_path / "jax.pkl").read_bytes())
    mbconv = sorted(glob.glob(BOOST + "/arch_params_*.pkl"))[-1]
    with pytest.raises(SystemExit, match="not a hybrid checkpoint"):
        tools_seed_vit_alpha.main(["--ckpt", mbconv, "--out",
                                   str(tmp_path / "x.pkl")])


def test_learnability_cnn_matches_jax():
    """Forward, loss, gradients and one Adam step of the probe CNN, from
    JAX's init, at an odd size (25 -> 13 -> 7 -> 4 -> 2: both SAME
    paddings)."""
    import jax.numpy as jnp
    import optax
    chs = (8, 16, 16, 32)
    jinit, jfwd = jlearn.build_tiny_cnn(jax, jnp, chs)
    jparams = jax.jit(jinit, static_argnums=1)(jax.random.PRNGKey(1), 6)
    tparams = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), jparams)
    _, tfwd = tools_proxy_learnability.build_tiny_cnn(chs)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (8, 25, 25, 3), np.uint8)
    y = rng.integers(0, 6, 8)
    np.testing.assert_allclose(
        tfwd(tparams, torch.from_numpy(x)).detach().numpy(),
        np.asarray(jax.jit(jfwd)(jparams, jnp.asarray(x))), rtol=0,
        atol=1e-5)

    @jax.jit
    def jstep(p, st):
        def loss_fn(q):
            return optax.softmax_cross_entropy_with_integer_labels(
                jfwd(q, jnp.asarray(x)), jnp.asarray(y)).mean()
        loss, grads = jax.value_and_grad(loss_fn)(p)
        upd, st = opt.update(grads, st)
        return optax.apply_updates(p, upd), loss, grads

    opt = optax.adam(2e-3)
    jparams, jloss, jgrads = jstep(jparams, opt.init(jparams))
    step = tools_proxy_learnability.make_step(tfwd, tparams, 2e-3)
    tloss = step(torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(tloss) - float(jloss)) < 1e-5
    for t, g in zip(jax.tree_util.tree_leaves(tparams),
                    jax.tree_util.tree_leaves(jgrads)):
        got = np.zeros(t.shape) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(g), rtol=0, atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(tparams),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-5)


def _write_jpegs(root, names_labels, size=40):
    from PIL import Image
    rng = np.random.default_rng(0)
    for name, _ in names_labels:
        arr = rng.integers(0, 255, (size, size + 4, 3), np.uint8)
        Image.fromarray(arr).save(root / name, quality=90)
    return "\n".join(f"{n} {l}" for n, l in names_labels) + "\n"


def test_learnability_modes_run(tmp_path):
    tiny = ["--device", "cpu", "--steps", "2", "--batch_size", "4",
            "--depth_chs", "4,8"]
    res = tools_proxy_learnability.main(tiny + [
        "--version", "3", "--num_classes", "6", "--train_per_class", "2",
        "--val_per_class", "1", "--gen_size", "36", "--crop", "32",
        "--tasks", "coarse,full", "--augs", "center,rrc"])
    assert list(res) == ["coarse/center", "coarse/rrc", "full/center",
                         "full/rrc"]
    assert res["coarse/rrc"]["chance"] == 1 / 5
    assert all(math.isfinite(r["final_loss"]) for r in res.values())
    for split, n in (("train", 8), ("val", 5)):
        (tmp_path / f"proxy_{split}.txt").write_text(_write_jpegs(
            tmp_path, [(f"{split}{i}.jpg", i % 3) for i in range(n)]))
    res = tools_proxy_learnability.main(tiny + [
        "--from_disk", str(tmp_path), "--num_classes", "3", "--image_size",
        "32", "--steps", "3"])
    assert 0.0 <= res["disk/val_top1"] <= 1.0
    assert math.isfinite(res["final_loss"]) and res["steps"] == 3


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_occupancy_tool_keys(capsys):
    out = tools_occupancy_ab.main([
        "--device", "cpu", "--space", "tiny", "--image_size", "32",
        "--batches", "2,4", "--n_timed", "2", "--warm", "1",
        "--remat_blocks"])
    assert _last_json(capsys) == json.loads(json.dumps(out))
    assert out["metric"] == "search_occupancy_ablation"
    assert out["remat_blocks"] and out["mode"] == "eager"
    assert [r["batch"] for r in out["rows"]] == [2, 4]
    for r in out["rows"]:
        assert {"batch", "steps_per_sec", "images_per_sec",
                "throughput_vs_bs32"} <= r.keys()
        assert r["images_per_sec"] == pytest.approx(
            r["steps_per_sec"] * r["batch"])
    assert out["rows"][0]["throughput_vs_bs32"] == 1.0
    assert set(out["fused_dw"]) == {"launches", "captured_nodes",
                                    "replayed_nodes"}


def test_scan_tool_keys(capsys):
    out = tools_scan_ab.main([
        "--device", "cpu", "--space", "tiny", "--size", "32", "--batch", "2",
        "--units", "1,2", "--timed_units", "2", "--rounds", "2"])
    assert _last_json(capsys) == json.loads(json.dumps(out))
    for name in ("K=1 (per-step)", "K=2 (scan)"):
        assert len(out["rounds"][name]) == 2
        assert out[name] == max(out["rounds"][name]) > 0


def test_hybrid_bench_keys(capsys):
    out = tools_hybrid_bench.main(["--device", "cpu", "--size", "32",
                                   "--batch", "2", "--iters", "1",
                                   "--warm", "0"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(out))
    for sp in ("mbconv", "hybrid"):
        assert all(math.isfinite(out[sp][k]) and out[sp][k] > 0
                   for k in ("w_ms", "a_ms"))
    assert out["hybrid_overhead"]["w_ms"] == pytest.approx(
        out["hybrid"]["w_ms"] / out["mbconv"]["w_ms"])


def test_eval_throughput_tool(capsys):
    out = tools_eval_throughput.main(["--device", "cpu", "--batches", "2,3",
                                      "--image_size", "32", "--iters", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    for line, row in zip(lines[:-1], out["rows"]):  # the JAX tool's lines
        assert re.fullmatch(
            rf"bs={row['batch']}: [\d.]+ ms/batch, [\d,]+ images/sec "
            r"\(vs TF-NAS-A Titan RTX 1775 im/s: [\d.]+x\)", line)
        assert row["images_per_sec"] == pytest.approx(
            row["batch"] / row["ms_per_batch"] * 1e3)


def test_loader_tool(tmp_path, capsys):
    (tmp_path / "list.txt").write_text(_write_jpegs(
        tmp_path, [(f"{i}.jpg", i % 3) for i in range(12)]))
    base = ["--img_root", str(tmp_path), "--list", str(tmp_path / "list.txt"),
            "--batch_size", "4", "--workers", "2", "--batches", "2",
            "--image_size", "32", "--device", "cpu"]
    for extra, native in (([], True), (["--no_native", "--val",
                                        "--chip_steps_per_sec", "5"], False)):
        out = tools_loader_throughput.main(base + extra)
        assert _last_json(capsys) == json.loads(json.dumps(out))
        assert out["native"] is native and out["training"] is native
        assert out["metric"] == "loader_images_per_sec" and out["value"] > 0
    assert out["loader_vs_demand"] == pytest.approx(
        out["value"] / out["chip_demand_images_per_sec"])
    assert out["chip_demand_images_per_sec"] == 20.0


@pytest.mark.parametrize("tool, argv", [
    (tools_family_table, ["--root", "no-runs-here"]),
    (tools_search_report, ["--run_dir", BOOST]),
    (tools_loader_throughput, ["--img_root", ".", "--list", "none.txt"])])
def test_tools_run_on_the_card_unless_told(tool, argv, monkeypatch):
    """Without --device these tools resolve the card, as every entry point
    of the port does: here, without one, they raise before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)
