"""The port's hybrid conv/ViT space (eval side and the CLIs) against the
JAX package on the CPU: the eval network from the hybrid model.configs
(config bytes, FLOPs, parameter count, forward), its LUT latency, the BN
fold with ViT blocks, one train_dp step, and the drivers in-process:
parsing_model, make_lat_lut, train_search, train_eval and test with the
hybrid space.

Whole-network checks run at 64^2: at 32^2 the stage-5/6 blocks see 1x1
maps, where BN over N * H * W = 2 values is ill-conditioned. Tolerances:
forward logits and the updated state 1e-4 (as test_torch_eval_net.py's
eval forward; full-width sums in different orders); FLOPs, parameter
MB, LUT latency, config and table bytes exact."""

import functools
import glob
import json
import os
import pickle
import re
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import make_lat_lut_tpu as jlutb
from tfnas_tpu.cost import flops as jflops
from tfnas_tpu.cost import lut as jlut
from tfnas_tpu.models import folding as jfold
from tfnas_tpu.models import hybrid_space as jhs
from tfnas_tpu.models import search_space as jss
from tfnas_tpu.models.eval_net import EvalNetwork as JNet
from tfnas_tpu.parallel import make_mesh
from tfnas_tpu.parallel.train_dp import (EvalTrainState as JState,
                                         make_eval_steps as jmake)
from tfnas_tpu.search.parser import get_mc_num_dddict
from tfnas_tpu_torch import make_lat_lut as tlutb
from tfnas_tpu_torch import parsing_model as tparse
from tfnas_tpu_torch import test as ttest
from tfnas_tpu_torch import train_eval as teval
from tfnas_tpu_torch import train_search as tsearch
from tfnas_tpu_torch.convert import (eval_state_from_jax, params_from_jax,
                                     params_to_jax)
from tfnas_tpu_torch.cost import flops as tflops
from tfnas_tpu_torch.cost import lut as tlut
from tfnas_tpu_torch.models import folding as tfold
from tfnas_tpu_torch.models import hybrid_space as ths
from tfnas_tpu_torch.models.eval_net import EvalNetwork as TNet
from tfnas_tpu_torch.parallel import train_dp as tdp
from test_torch_eval_drivers import run_jax_driver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(
    ROOT, "checkpoints_e2e", "hybrid-*retrain", "*", "model.config")))
ARCH = os.path.join(ROOT, "checkpoints_e2e", "hybrid-natural", "*",
                    "arch_params_{:02d}.pkl")
H100 = os.path.join(ROOT, "latency_pkl", "latency_h100.pkl")
H100_HYBRID = os.path.join(ROOT, "latency_pkl", "latency_h100_hybrid.pkl")
TOL = dict(rtol=1e-4, atol=1e-4)
N, RES = 2, 64


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol=TOL):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                                **tol),
        got, want)


def jax_keep_draws(jnet, key, n):
    """The drop-connect and dropout draws of JAX's EvalNetwork.apply from
    `key` in the port's `keep` form: a ViT block's two branch draws come
    from the split of its key."""
    rngs = jax.random.split(key, 1 + jnet.block_count)
    keep = []
    blocks = [jnet.second_stem] + [b for _, _, b in jnet.iter_blocks()]

    def draw(k, rate, shape):
        u = jax.random.uniform(k, shape, jnp.float32)
        return torch.from_numpy(np.array(jnp.floor((1.0 - rate) + u))
                                .reshape(n))
    for r, b in zip(rngs, blocks):
        rate = b.drop_connect_rate
        if rate > 0.0 and b.name == "ViTBlock":
            keep.append(tuple(draw(k, rate, (n, 1, 1))
                              for k in jax.random.split(r)))
        elif rate > 0.0 and b.has_residual:
            keep.append(draw(r, rate, (n, 1, 1, 1)))
        else:
            keep.append(None)
    feats = jnet.feature_mix_layer.out_channels
    keep.append(torch.from_numpy(np.array(jax.random.bernoulli(
        rngs[-1], 1.0 - jnet.dropout_rate, (n, feats)))))
    return keep


def _vit_parsed():
    """Op 1 at every block, the ViT candidate at stage5/block1 and
    stage6/block1, every stage at full depth."""
    parsed = OrderedDict(
        (stage, OrderedDict((f"block{i + 1}", 1) for i in range(d)))
        for stage, d in jss.STAGE_DEPTHS.items())
    parsed["stage5"]["block1"] = parsed["stage6"]["block1"] = 8
    return parsed


@pytest.fixture(scope="module")
def vitnet():
    """The ViT-picking eval net in both packages, with the port's init
    (converted) and perturbed running statistics."""
    mc = get_mc_num_dddict(jhs.build_mc_mask_dddict())
    jn = JNet.from_parsed_arch(10, _vit_parsed(), mc, 0.3, 0.5)
    tn = TNet.from_parsed_arch(10, _vit_parsed(), mc, 0.3, 0.5)
    tp, ts = tn.init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    state = jax.tree_util.tree_map(
        lambda a: a + np.abs(rng.standard_normal(a.shape)).astype(
            np.float32) * 0.1, params_to_jax(ts))
    x = rng.standard_normal((N, RES, RES, 3)).astype(np.float32)
    return jn, tn, params_to_jax(tp), state, x


# -- the eval network ---------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_hybrid_config_builds_the_jax_net(path):
    cfg = json.load(open(path))
    jn, tn = JNet.from_config(10, cfg, 0.2, 0.2), TNet.from_config(
        10, cfg, 0.2, 0.2)
    assert sum(b.name == "ViTBlock" for _, _, b in tn.iter_blocks()) >= 4
    assert json.dumps(tn.config, indent=4) == json.dumps(jn.config, indent=4)
    assert [b.drop_connect_rate for _, _, b in tn.iter_blocks()] == \
        [b.drop_connect_rate for _, _, b in jn.iter_blocks()]
    assert tflops.calculate_FLOPs_in_M(tn) == jflops.calculate_FLOPs_in_M(jn)
    tp, ts = tn.init(torch.Generator().manual_seed(0))
    jp = params_to_jax(tp)
    assert tflops.count_parameters_in_MB(tp) == \
        jflops.count_parameters_in_MB(jp)
    assert jax.tree_util.tree_map(np.shape, jp) == jax.tree_util.tree_map(
        np.shape, jax.eval_shape(jn.init, jax.random.PRNGKey(0))[0])
    x = np.random.default_rng(1).standard_normal((N, RES, RES, 3)).astype(
        np.float32)
    want, _ = jax.jit(jn.apply)(jp, params_to_jax(ts), jnp.asarray(x))
    got, _ = tn.apply(tp, ts, torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    hl = tlut.load_lat_lookup(os.path.join(ROOT, "latency_pkl",
                                           "latency_tpu_hybrid.pkl"))
    assert tn.get_lookup_latency(hl) == jn.get_lookup_latency(
        jlut.load_lat_lookup(os.path.join(ROOT, "latency_pkl",
                                          "latency_tpu_hybrid.pkl")))


def test_from_parsed_arch_with_vit_and_training_forward(vitnet):
    jn, tn, params, state, x = vitnet
    assert json.dumps(tn.config, indent=4) == json.dumps(jn.config, indent=4)
    assert [b.drop_connect_rate for _, _, b in tn.iter_blocks()] == \
        [b.drop_connect_rate for _, _, b in jn.iter_blocks()]
    key = jax.random.PRNGKey(13)
    want, wst = jn.apply(params, state, jnp.asarray(x), training=True,
                         rng=key)
    keep = jax_keep_draws(jn, key, N)
    vit = [k for k, b in zip(keep[1:], [b for _, _, b in tn.iter_blocks()])
           if b.name == "ViTBlock"]
    assert len(vit) == 2 and all(len(k) == 2 for k in vit)
    got, gst = tn.apply(params_from_jax(params), params_from_jax(state),
                        torch.from_numpy(x), training=True, keep=keep)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    _close(params_to_jax(gst), _np(wst))
    # the port's own draws: a pair per ViT block
    own = tn.draw_keep(N, torch.Generator().manual_seed(0))
    assert [isinstance(k, tuple) for k in own[1:-1]] == \
        [b.name == "ViTBlock" for _, _, b in tn.iter_blocks()]


def test_fold_passes_vit_blocks_through(vitnet):
    jn, tn, params, state, x = vitnet
    tp, ts = params_from_jax(params), params_from_jax(state)
    ref, _ = tn.apply(tp, ts, torch.from_numpy(x))
    folded, fparams = tfold.fold_batchnorm(tn, tp, ts)
    got, _ = folded.apply(fparams, {}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    for (stage, block, b), (_, _, fb) in zip(tn.iter_blocks(),
                                              folded.iter_blocks()):
        if b.name == "ViTBlock":
            assert fb == b.__class__(**{**b.__dict__,
                                        "drop_connect_rate": 0.0})
            assert fparams[stage][block] == tp[stage][block]
    jf, _ = jfold.fold_batchnorm(jn, params, state)
    assert json.dumps(folded.config) == json.dumps(jf.config)


def test_train_dp_step_on_a_hybrid_net_matches_jax(vitnet):
    jn, tn, params, state, x = vitnet
    y = np.array([1, 7], np.int32)
    kw = dict(num_classes=10, label_smooth=0.1, momentum=0.9,
              weight_decay=1e-5, grad_clip=5.0)
    jtrain, _ = jmake(jn, make_mesh(1), compute_dtype=jnp.float32, **kw)
    ttrain, _ = tdp.make_eval_steps(tn, compute_dtype=torch.float32, **kw)
    rng = np.random.default_rng(4)
    mom = jax.tree_util.tree_map(
        lambda p: (0.01 * rng.standard_normal(p.shape)).astype(np.float32),
        params)
    key, lr = jax.random.PRNGKey(5), 0.2
    jst, jm = jtrain(JState(*jax.tree_util.tree_map(
        jnp.asarray, (params, state, mom)), jnp.zeros((), jnp.int32)),
        jnp.asarray(x), jnp.asarray(y), jnp.float32(lr), key)
    keep = jax_keep_draws(jn, jax.random.fold_in(key, 0), N)
    tst, tm = ttrain(eval_state_from_jax({"params": params,
                                          "bn_state": state, "momentum": mom,
                                          "epoch": 0}),
                     torch.from_numpy(x), torch.from_numpy(y).long(), lr,
                     keep)
    _close(params_to_jax(tst.params), _np(jst.params))
    _close(params_to_jax(tst.bn_state), _np(jst.bn_state))
    _close(params_to_jax(tst.momentum), _np(jst.momentum))
    for k in ("loss", "top1", "top5"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)


# -- the CLIs -----------------------------------------------------------------

@pytest.mark.parametrize("epoch", [2, 20])
def test_parsing_model_hybrid_writes_the_jax_config_bytes(epoch, tmp_path,
                                                          capsys,
                                                          monkeypatch):
    monkeypatch.setattr(tparse, "measure_model_latency_in_ms",
                        functools.partial(tparse.measure_model_latency_in_ms,
                                          warmup=1, iters=1))
    (path,) = glob.glob(ARCH.format(epoch))
    jax_cfg, port_cfg = tmp_path / "jax.config", tmp_path / "port.config"
    args = ["--model_path", path, "--space", "hybrid", "--lookup_path",
            os.path.join(ROOT, "latency_pkl", "latency_tpu_hybrid.pkl")]
    run_jax_driver("parsing_model", args + ["--save_path", str(jax_cfg)])
    jout = capsys.readouterr().out
    model = tparse.main(args + ["--save_path", str(port_cfg), "--device",
                                "cpu"] + (["--print_lat"] if epoch == 20
                                          else []))
    tout = capsys.readouterr().out
    assert port_cfg.read_bytes() == jax_cfg.read_bytes()
    for key in ("Params", "FLOPs"):
        assert re.search(rf"{key}:\s*(\S+)", tout).group(1) == \
            re.search(rf"{key}:\s*(\S+)", jout).group(1)
    n_vit = sum(b.name == "ViTBlock" for _, _, b in model.iter_blocks())
    assert n_vit == (0 if epoch == 2 else 5)
    if epoch == 20:
        assert "Lat_LUT:" in tout and "Lat_CPU bs=1:" in tout


def test_make_lat_lut_hybrid_analytic_and_resume(tmp_path, capsys):
    out = str(tmp_path / "hyb.pkl")
    lut = tlutb.main(["--space", "hybrid", "--output", out])
    conv = [k[0] for k in tlutb.site_keys()]
    vit = [k[0] for k in tlutb.vit_keys()]
    assert list(lut) == ["base"] + conv + vit
    assert len(conv) == 66 and len(vit) == 5
    assert list(jlutb.build_analytic_lut(space="hybrid")) == list(lut)
    # the roofline form is make_lat_lut_tpu.py's (same peaks, same numbers)
    for key, res, cin, cout, stride, _, max_mc in tlutb.vit_keys():
        assert list(lut[key]) == list(range(1, max_mc + 1))
        for mc in (1, max_mc // 2, max_mc):
            assert tlut.analytic_vit_ms(res, cin, cout, stride, mc) == \
                jlutb.analytic_vit_ms(res, cin, cout, stride, mc)
            assert lut[key][mc] == tlut.analytic_vit_ms(
                res, cin, cout, stride, mc,
                peak_flops=tlutb.H100_PEAK_FLOPS,
                peak_bw=tlutb.H100_PEAK_BW)
    # --resume on an mbconv table measures only the ViT keys
    part = str(tmp_path / "part.pkl")
    mb = tlutb.main(["--output", part])
    before = {k: pickle.dumps(v) for k, v in mb.items()}
    capsys.readouterr()
    got = tlutb.main(["--space", "hybrid", "--mode", "measure", "--resume",
                      "--output", part, "--device", "cpu", "--batch_size",
                      "2", "--stride_points", "1", "--warmup", "1",
                      "--iters", "1"])
    log = capsys.readouterr().out
    assert log.count(": resumed") == 66 and "(resumed)" in log
    assert list(got) == ["base"] + conv + vit
    assert all(pickle.dumps(got[k]) == before[k] for k in before)
    for key in vit:
        vals = list(got[key].values())
        assert vals == sorted(vals) and vals[-1] > 0
    assert jlut.load_lat_lookup(part).keys() == got.keys()


def test_committed_h100_hybrid_table():
    """latency_h100_hybrid.pkl: latency_h100.pkl's 'base' and 66 conv
    keys, byte for byte, and the 5 ViT keys measured on the card."""
    h100 = pickle.load(open(H100, "rb"))
    hyb = pickle.load(open(H100_HYBRID, "rb"))
    vit = [k[0] for k in tlutb.vit_keys()]
    assert list(hyb) == list(h100) + vit
    for k in h100:
        assert pickle.dumps(hyb[k]) == pickle.dumps(h100[k])
    for key, *_, max_mc in tlutb.vit_keys():
        vals = list(hyb[key].values())
        assert list(hyb[key]) == list(range(1, max_mc + 1))
        assert vals == sorted(vals) and vals[0] > 0


def test_train_search_hybrid_refuses_a_conv_table_and_runs(tmp_path):
    save = tmp_path / "search"
    for lut in (H100, os.path.join(ROOT, "latency_pkl", "latency_tpu.pkl")):
        with pytest.raises(SystemExit, match="ViT entries"):
            tsearch.main(["--synthetic", "--space", "hybrid", "--device",
                          "cpu", "--lookup_path", lut, "--save", str(save)])
    assert not save.exists()
    table = str(tmp_path / "hyb.pkl")
    tlutb.main(["--space", "hybrid", "--output", table])
    run = tsearch.main([
        "--synthetic", "--space", "hybrid", "--device", "cpu",
        "--lookup_path", table, "--image_size", "32", "--batch_size", "2",
        "--epochs", "2", "--warmup_epochs", "1", "--steps_per_epoch", "2",
        "--num_classes", "10", "--target_lat", "0.5", "--no_bf16",
        "--save", str(save)])
    ap = pickle.load(open(os.path.join(run, "arch_params_02.pkl"), "rb"))
    la = ap["arch_params"]["log_alphas"]
    valid = ths.valid_op_mask()
    assert la.shape == (18, 9) and (la[valid == 0] == -30.0).all()
    np.testing.assert_allclose(np.exp(la[valid > 0].reshape(-1)).sum(),
                               18.0, rtol=1e-5)
    assert ap["mc_mask_dddict"]["stage6"]["block1"][8].shape == (320 * 4,)
    ckpt = pickle.load(open(os.path.join(run, "searched_model_02.pkl"),
                            "rb"))
    assert set(ckpt["params"]["stage5"]["block1"]["vit"]) == {
        "ln1", "qkv", "attn_out", "ln2", "mlp_in", "mlp_out", "patch_proj"}
    # it resumes from its own checkpoint in the hybrid space
    run2 = tsearch.main([
        "--synthetic", "--space", "hybrid", "--device", "cpu",
        "--lookup_path", table, "--image_size", "32", "--batch_size", "2",
        "--epochs", "3", "--warmup_epochs", "1", "--steps_per_epoch", "2",
        "--num_classes", "10", "--target_lat", "0.5", "--no_bf16",
        "--save", str(save), "--resume",
        os.path.join(run, "searched_model_02.pkl")])
    assert os.path.exists(os.path.join(run2, "arch_params_03.pkl"))


def test_train_eval_and_test_on_a_hybrid_config(tmp_path):
    cfg = CONFIGS[-1]  # hybrid-natural-retrain: 4 ViT blocks
    run = teval.main(["--synthetic", "--epochs", "1", "--steps_per_epoch",
                      "1", "--image_size", "64", "--batch_size", "2",
                      "--num_classes", "10", "--print_freq", "1", "--note",
                      "t", "--workers", "1", "--config_path", cfg, "--save",
                      str(tmp_path), "--device", "cpu"])
    saved = json.load(open(os.path.join(run, "model.config")))
    assert [c["name"] for c in saved["stage5"]].count("ViTBlock") >= 1
    got = ttest.main(["--weights", os.path.join(run, "checkpoint.pkl"),
                      "--synthetic", "--batch_size", "2", "--num_classes",
                      "10", "--image_size", "64", "--device", "cpu"])
    assert all(np.isfinite(v) for v in got.values())
