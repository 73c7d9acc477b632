"""The port's entry points on the CPU, tiny space: search -> parse ->
retrain -> test in-process, writing nothing outside --save; model.config
bytes against the JAX parsing_model.py; eval checkpoints crossing between
the two packages' retrain and test drivers (metrics at 1e-4, checkpoint
bytes exact); a padded real-image validation; and --resume from a
JAX-written search checkpoint, one injected step on, at 1e-5."""

import functools
import glob
import importlib.util
import json
import math
import os
import pickle
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_lat_lut_tpu import build_space_analytic_lut as jax_analytic_lut
from tfnas_tpu.models import search_space as jss
from tfnas_tpu.models.eval_net import EvalNetwork as JEval
from tfnas_tpu.models.supernet import SuperNetwork as JSuper
from tfnas_tpu.search.bisample import (sample_gumbel_indices,
                                       sample_random_excluding)
from tfnas_tpu.search.train_step import (make_search_steps as jsteps,
                                         zeros_like_momentum)
from tfnas_tpu.utils import checkpoint as jckpt
from tfnas_tpu_torch import parsing_model as tparse
from tfnas_tpu_torch import test as ttest
from tfnas_tpu_torch import train_eval as teval
from tfnas_tpu_torch import train_search as tsearch
from tfnas_tpu_torch.convert import params_to_jax
from tfnas_tpu_torch.cost import lut as tlut
from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.models.supernet import SuperNetwork as TSuper
from tfnas_tpu_torch.search.train_step import (make_search_steps,
                                               zeros_like_tree)
from tfnas_tpu_torch.utils import checkpoint as tckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARETO = glob.glob(os.path.join(ROOT, "checkpoints_e2e", "pareto-tiny", "*",
                                "searched_model_g0_04.pkl"))[0]
EVAL = ["--synthetic", "--epochs", "1", "--steps_per_epoch", "2",
        "--image_size", "32", "--batch_size", "8", "--num_classes", "10",
        "--print_freq", "1", "--note", "t", "--workers", "1"]


def run_jax_driver(name, argv):
    """main() of one of the repository's JAX drivers, loaded by path."""
    old = sys.argv
    try:
        sys.argv = [f"{name}.py"] + argv
        spec = importlib.util.spec_from_file_location(
            f"jax_driver_{name}", os.path.join(ROOT, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.main()
    finally:
        sys.argv = old


def _jax_metrics(out):
    return {k: float(re.search(rf"Val_acc_{k}: ([0-9.]+)", out).group(1))
            for k in ("top1", "top5")}


def _repo_files():
    out = set()
    for d, dirs, files in os.walk(ROOT):
        # build/ is where the port builds its libraries
        dirs[:] = [x for x in dirs if x not in (".git", "__pycache__",
                                                "build")]
        out.update(os.path.join(d, f) for f in files
                   if not f.endswith((".so", ".tmp")))
    return out


def test_parsing_model_writes_the_jax_config_bytes(tmp_path, capsys,
                                                  monkeypatch):
    # --print_lat's chains, short: their timing is cost/measure.py's test
    monkeypatch.setattr(tparse, "measure_model_latency_in_ms",
                        functools.partial(tparse.measure_model_latency_in_ms,
                                          warmup=1, iters=2))
    jax_cfg, port_cfg = tmp_path / "jax.config", tmp_path / "port.config"
    args = ["--model_path", PARETO, "--space", "tiny", "--image_size", "32",
            "--num_classes", "10"]
    # without --print_lat: the JAX driver would also time the model
    run_jax_driver("parsing_model", args + ["--save_path", str(jax_cfg)])
    jout = capsys.readouterr().out
    model = tparse.main(args + ["--save_path", str(port_cfg), "--device",
                                "cpu", "--print_lat"])
    tout = capsys.readouterr().out
    assert port_cfg.read_bytes() == jax_cfg.read_bytes()
    for key in ("Params", "FLOPs"):
        want = re.search(rf"{key}:\s*(\S+)", jout).group(1)
        assert re.search(rf"{key}:\s*(\S+)", tout).group(1) == want
    want = JEval.from_config(10, json.load(open(jax_cfg))).get_lookup_latency(
        jax_analytic_lut(jss.tiny_space(32)), 32)
    assert re.search(r"Lat_LUT:\s*(\S+)ms", tout).group(1) == \
        "{:.4f}".format(want)
    assert model.get_lookup_latency(tlut.build_space_analytic_lut(
        tss.tiny_space(32)), 32) == want
    # the measured latency of the folded bf16 net, at batch 32 and 1
    for bs in (32, 1):
        ms = float(re.search(rf"Lat_CPU bs={bs}:\s*(\S+)ms", tout).group(1))
        assert math.isfinite(ms) and ms > 0
    # --space hybrid parses the hybrid search's arch parameters, ViT
    # candidates included, into the JAX driver's config bytes
    (hybrid,) = glob.glob(os.path.join(ROOT, "checkpoints_e2e",
                                       "hybrid-natural", "*",
                                       "arch_params_20.pkl"))
    args = ["--model_path", hybrid, "--space", "hybrid", "--num_classes",
            "10", "--save_path"]
    run_jax_driver("parsing_model", args + [str(jax_cfg)])
    hmodel = tparse.main(args + [str(port_cfg), "--device", "cpu"])
    assert port_cfg.read_bytes() == jax_cfg.read_bytes()
    assert any(b.name == "ViTBlock" for _, _, b in hmodel.iter_blocks())


def test_search_parse_retrain_test_pipeline(tmp_path, capsys):
    before = _repo_files()
    save = tmp_path / "save"
    tsearch.main(["--synthetic", "--space", "tiny", "--epochs", "2",
                  "--warmup_epochs", "1", "--steps_per_epoch", "2",
                  "--image_size", "32", "--batch_size", "4",
                  "--num_classes", "10", "--target_lat", "0.05", "--save",
                  str(save / "search"), "--print_freq", "1", "--no_bf16",
                  "--device", "cpu"])
    (ckpt,) = glob.glob(str(save / "search" / "*" / "searched_model_02.pkl"))
    cfg = save / "model.config"
    tparse.main(["--model_path", ckpt, "--save_path", str(cfg), "--space",
                 "tiny", "--image_size", "32", "--num_classes", "10",
                 "--device", "cpu"])
    jax_cfg = save / "jax_model.config"
    run_jax_driver("parsing_model", [
        "--model_path", ckpt, "--save_path", str(jax_cfg), "--space", "tiny",
        "--image_size", "32", "--num_classes", "10"])
    assert cfg.read_bytes() == jax_cfg.read_bytes()

    run = teval.main(EVAL + ["--config_path", str(cfg), "--save",
                             str(save / "eval"), "--device", "cpu"])
    assert sorted(os.listdir(run))[:2] == ["checkpoint.pkl", "log.txt"]
    # from_config lists every stage of the reference space, as JAX's does
    assert open(os.path.join(run, "model.config")).read() == json.dumps(
        JEval.from_config(10, json.load(open(cfg))).config, indent=4)
    port_ckpt = os.path.join(run, "checkpoint.pkl")
    # --snapshot resumes at the checkpoint's epoch and keeps its keys
    run2 = teval.main(EVAL + [
        "--epochs", "2", "--config_path", str(cfg), "--save",
        str(save / "eval2"), "--snapshot", port_ckpt, "--device", "cpu"])
    resumed = pickle.load(open(os.path.join(run2, "checkpoint.pkl"), "rb"))
    assert resumed["epoch"] == 2 and "Epoch: 0 " not in open(
        os.path.join(run2, "log.txt")).read()
    assert sorted(resumed) == sorted(pickle.load(open(port_ckpt, "rb")))
    got = ttest.main(["--weights", port_ckpt, "--synthetic", "--batch_size",
                      "8", "--num_classes", "10", "--image_size", "32",
                      "--device", "cpu"])
    capsys.readouterr()
    # the JAX package's test.py reads the port's checkpoint
    run_jax_driver("test", ["--weights", port_ckpt, "--synthetic",
                            "--batch_size", "8", "--num_classes", "10",
                            "--image_size", "32"])
    want = _jax_metrics(capsys.readouterr().out)
    for k in ("top1", "top5"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4)
    assert _repo_files() == before

    # and the port's test.py reads the JAX driver's checkpoint
    with capsys.disabled():  # the JAX driver registers faulthandler
        run_jax_driver("train_eval", EVAL + ["--config_path", str(cfg),
                                             "--save", str(save / "jax_eval")])
    (jax_ckpt,) = glob.glob(str(save / "jax_eval" / "*" / "checkpoint.pkl"))
    jc, tc = pickle.load(open(jax_ckpt, "rb")), pickle.load(open(port_ckpt,
                                                               "rb"))
    assert sorted(jc) == sorted(tc)
    assert jc["model_config"] == tc["model_config"]
    assert jax.tree_util.tree_map(np.shape, jc["params"]) == \
        jax.tree_util.tree_map(np.shape, tc["params"])
    capsys.readouterr()
    run_jax_driver("test", ["--weights", jax_ckpt, "--synthetic",
                            "--batch_size", "8", "--num_classes", "10",
                            "--image_size", "32"])
    want = _jax_metrics(capsys.readouterr().out)
    got = ttest.main(["--weights", jax_ckpt, "--synthetic", "--batch_size",
                      "8", "--num_classes", "10", "--image_size", "32",
                      "--device", "cpu"])
    for k in ("top1", "top5"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4)


def test_checkpoint_bytes_match_jax(tmp_path):
    """The same eval checkpoint tree pickles to the same bytes through
    either package's writer."""
    rng = np.random.default_rng(0)
    cfg = json.load(open(os.path.join(ROOT, "configs", "tfnas_a_tpu.config")))
    tree = {"epoch": 3,
            "params": {"b": {"kernel": rng.standard_normal(
                (3, 3, 2, 4)).astype(np.float32)},
                "a": {"bias": np.zeros(4, np.float32)}},
            "bn_state": {"x": {"bn": {"var": np.ones(4, np.float32),
                                      "mean": np.zeros(4, np.float32)}}},
            "momentum": {"b": {"kernel": np.ones((3, 3, 2, 4), np.float32)},
                         "a": {"bias": np.ones(4, np.float32)}},
            "best_acc_top1": np.float32(12.5), "best_acc_top5": 0.0,
            "model_config": cfg}
    jpath, tpath = str(tmp_path / "j.pkl"), str(tmp_path / "t.pkl")
    jckpt.save_checkpoint_file(tree, jpath)
    tckpt.save_checkpoint_file(tckpt.to_numpy_tree(tree), tpath)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    tckpt.save_checkpoint(
        {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in tree.items()}, True, str(tmp_path), "t2.pkl", "best.pkl")
    assert open(tmp_path / "best.pkl", "rb").read() == open(jpath,
                                                            "rb").read()


def test_padded_real_image_validation(tmp_path, capsys):
    """test.py over a JPEG list whose last batch is padded: the port's
    metrics equal the JAX test.py's on the same port-written checkpoint."""
    from PIL import Image
    rng = np.random.default_rng(0)
    lines = []
    for i in range(20):
        arr = rng.integers(0, 255, (int(rng.integers(36, 60)), 48, 3),
                           np.uint8)
        Image.fromarray(arr).save(tmp_path / f"{i}.jpg")
        lines.append(f"{i}.jpg {i % 10}")
    (tmp_path / "val.txt").write_text("\n".join(lines) + "\n")
    cfg = tmp_path / "model.config"
    tparse.main(["--model_path", PARETO, "--save_path", str(cfg), "--space",
                 "tiny", "--image_size", "32", "--num_classes", "10",
                 "--device", "cpu"])
    lists = ["--val_root", str(tmp_path), "--val_list",
             str(tmp_path / "val.txt")]
    run = teval.main([a for a in EVAL if a != "--synthetic"] + lists + [
        "--train_root", str(tmp_path), "--train_list",
        str(tmp_path / "val.txt"), "--config_path", str(cfg),
        "--save", str(tmp_path / "eval"), "--device", "cpu"])
    weights = os.path.join(run, "checkpoint.pkl")
    args = ["--weights", weights, "--batch_size", "8", "--num_classes",
            "10", "--image_size", "32", "--workers", "1"] + lists
    got = ttest.main(args + ["--device", "cpu"])
    capsys.readouterr()
    run_jax_driver("test", args)
    want = _jax_metrics(capsys.readouterr().out)
    for k in ("top1", "top5"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4)
    # exact over the 20 images: a multiple of 1/20
    assert abs(got["top1"] * 20 / 100 - round(got["top1"] * 20 / 100)) < 1e-4

    # the search driver takes the same lists (arch steps from the val list,
    # the last epoch's padded full validation)
    run = tsearch.main([
        "--space", "tiny", "--epochs", "2", "--warmup_epochs", "1",
        "--steps_per_epoch", "2", "--image_size", "32", "--batch_size", "4",
        "--num_classes", "10", "--target_lat", "0.05", "--no_bf16",
        "--workers", "1", "--img_root", str(tmp_path), "--train_list",
        str(tmp_path / "val.txt"), "--val_list", str(tmp_path / "val.txt"),
        "--save", str(tmp_path / "search"), "--device", "cpu"])
    assert os.path.exists(os.path.join(run, "searched_model_02.pkl"))
    assert "Val_acc" in open(os.path.join(run, "log.txt")).read()


def _weight_step_jax(jnet, ckpt, x, y, key, lr, kw):
    jparams = jax.tree_util.tree_map(jnp.asarray, ckpt["params"])
    jarch = jax.tree_util.tree_map(jnp.asarray, ckpt["arch_params"])
    mc = ckpt["mc_mask_dddict"]
    return jsteps(jnet, **kw).weight_step(
        jparams, jarch, zeros_like_momentum(jparams), jnet.device_masks(mc),
        jnet.update_masks(jparams, mc), jnp.asarray(x), jnp.asarray(y),
        jnp.float32(lr), key)


def _max_diff(a, b):
    return max(np.abs(np.asarray(u) - np.asarray(v)).max() for u, v in zip(
        jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


def test_resume_from_jax_search_checkpoint():
    """The port's --resume loader on the JAX Pareto run's checkpoint (tiny
    space, epoch 4, T 4.42, an extra target_lat key), then one weight step
    with the JAX step's draws, equals the JAX driver's resume and step at
    1e-5.

    The trained checkpoint makes some draws ill-conditioned: with
    PRNGKey(4) (ops [1, 1, 5] / [5, 3, 6]) the JAX step itself moves by
    1.4e-4 when the batch is only permuted, and the port lands as far from
    it. The test therefore also checks that its draw is one where the
    reference agrees with itself to well inside 1e-5."""
    params, arch, mc, epoch, T = tsearch.load_resume(PARETO, "cpu")
    assert epoch == 4 and abs(T - 4.4237) < 1e-4
    ckpt = jckpt.load_checkpoint(PARETO)
    assert "target_lat" in ckpt
    jnet, tnet = JSuper(10, space=jss.tiny_space(32)), TSuper(
        10, space=tss.tiny_space(32))
    kw = dict(num_classes=10, lambda_lat=0.1, target_lat=0.04)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    key, lr = jax.random.PRNGKey(6), 0.0125
    jp, jm, jmet = _weight_step_jax(jnet, ckpt, x, y, key, lr, kw)
    perm = np.array([3, 1, 7, 0, 2, 6, 5, 4])
    _, jm_perm, _ = _weight_step_jax(jnet, ckpt, x[perm], y[perm], key, lr,
                                     kw)
    assert _max_diff(jm, jm_perm) < 1e-6  # the reference is well-conditioned
    kg, kr = jax.random.split(key)
    g = sample_gumbel_indices(kg, ckpt["arch_params"]["log_alphas"])
    draws = [torch.from_numpy(np.array(d)).long()
             for d in (g, sample_random_excluding(kr, g, 8))]
    tp, tm, tmet = make_search_steps(tnet, **kw).weight_step(
        params, arch, zeros_like_tree(params), tnet.device_masks(mc, "cpu"),
        tnet.update_masks(params, mc), torch.from_numpy(x),
        torch.from_numpy(y).long(), lr, *draws)
    for got, want in ((params_to_jax(tp), jp), (params_to_jax(tm), jm)):
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                    rtol=1e-5, atol=1e-5),
            got, want)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-5, atol=1e-5)
