"""CoAtNet (arXiv:2106.04803) on the port's eval network, on the CPU,
against the plain reference `benchmark/reference/coatnet.py`.

A tiny CoAtNet (L = (2, 1, 1, 2, 1), D = (16, 16, 32, 64, 64), 64^2,
batch 4, 10 classes) in float32: the training forward, the loss, every
gradient leaf and one SGD step of the port's eval step, each within
1e-5 x max(1, |ref|) of the reference (norms of the difference); the
relative-position index against a loop over (i, j); the bias gather's
backward against plain indexing; both downsampling blocks (with and
without a projection) alone; the model.config codec; fold_batchnorm's
forward against the unfolded one. At full width: CoAtNet-2's parameter
count (shapes only, no init) within 3% of the published 75 M, and
cost/flops.py's multiply-adds within 3% of the published 15.7 G.

Torch runs on one thread here: the suite's workers share the machine.
"""

import dataclasses
import json
import os

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from benchmark.reference import coatnet as rc
from benchmark.reference import steps as rsteps
from benchmark.reference.nn import Pool
from tfnas_tpu_torch.cost import flops as tflops
from tfnas_tpu_torch.models import folding as tfold
from tfnas_tpu_torch.models.eval_net import EvalNetwork
from tfnas_tpu_torch.ops import attention as tatt
from tfnas_tpu_torch.ops.layers import MBConvPreNorm, set_layer_from_config
from tfnas_tpu_torch.parallel import train_dp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(depths=(2, 1, 1, 2, 1), widths=(16, 16, 32, 64, 64),
            image_size=64, num_classes=10)
N, CLASSES = 4, 10
HP = dict(momentum=0.9, weight_decay=1e-5, grad_clip=5.0, label_smooth=0.1)
LR = 0.1


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    """|got - want| <= 1e-5 x max(1, |want|), norms over the whole leaf."""
    got, want = got.detach().double(), want.detach().double()
    err = float(torch.linalg.vector_norm(got - want))
    ref = float(torch.linalg.vector_norm(want))
    assert err <= 1e-5 * max(1.0, ref), (err, ref)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: l for k, v in tree.items()
                for p, l in _paths(v, f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tree}


def _tiny(dropout=0.2, drop_connect=0.3):
    cfg = EvalNetwork.from_config(CLASSES, rc.model_config(**TINY)).config
    net = EvalNetwork.from_config(CLASSES, cfg, dropout, drop_connect)
    ref = rc.CoAtNet(cfg, CLASSES, dropout, drop_connect)
    params, bn = ref.init(Pool(torch.Generator().manual_seed(0)))
    g = torch.Generator().manual_seed(1)
    x = torch.randn((N, 64, 64, 3), generator=g)
    y = torch.randint(0, CLASSES, (N,), generator=g)
    return net, ref, params, bn, x, y


def _port_step(net, params, bn, x, y, keep):
    train, _ = train_dp.make_eval_steps(net, num_classes=CLASSES,
                                        compute_dtype=torch.float32, **HP)
    st = train_dp.EvalTrainState(params, bn, rsteps.tree_map(
        torch.zeros_like, params), 0)
    new, m = train(st, x, y, LR, keep)
    return new, m


def _ref_step(ref, params, bn, x, y, keep):
    mom = rsteps.tree_map(torch.zeros_like, params)
    return rc.retrain_step(ref, params, bn, mom, x, y, LR, keep, hp=HP)


@pytest.mark.parametrize("what", ["forward", "loss", "gradients",
                                  "sgd_step"])
def test_tiny_coatnet_matches_reference(what):
    """The port's training forward, loss, first gradient (every leaf, as
    the momentum buffer holds it after one step) and the SGD step's
    parameters and BN state, against the reference with the same
    drop-connect and dropout draws."""
    net, ref, params, bn, x, y = _tiny()
    keep = net.draw_keep(N, torch.Generator().manual_seed(2))
    keep_ref = ref.draw_keep(N, torch.Generator().manual_seed(2))
    for a, b in zip(keep, keep_ref):
        for u, v in zip(a if isinstance(a, tuple) else [a],
                        b if isinstance(b, tuple) else [b]):
            assert (u is None) == (v is None)
            assert u is None or torch.equal(u, v)
    if what == "forward":
        got, got_bn = net.apply(params, bn, x, training=True, keep=keep)
        want, want_bn = ref.apply(params, bn, x, training=True, keep=keep)
        _close(got, want)
        wp = _paths(want_bn)
        for p, leaf in _paths(got_bn).items():
            if torch.is_tensor(leaf):
                _close(leaf, wp[p])
        return
    new, m = _port_step(net, params, bn, x, y, keep)
    p2, bn2, mom2, loss = _ref_step(ref, params, bn, x, y, keep)
    if what == "loss":
        _close(m["loss"], loss)
    elif what == "gradients":
        mp = _paths(mom2)
        assert set(_paths(new.momentum)) == set(mp)
        for p, leaf in _paths(new.momentum).items():
            _close(leaf, mp[p])
    else:
        pp, bp = _paths(p2), _paths(bn2)
        for p, leaf in _paths(new.params).items():
            _close(leaf, pp[p])
        for p, leaf in _paths(new.bn_state).items():
            if torch.is_tensor(leaf):
                _close(leaf, bp[p])


def _loop_index(h, w):
    t = h * w
    idx = torch.empty((t, t), dtype=torch.long)
    for i in range(t):
        for j in range(t):
            dh = i // w - j // w + h - 1
            dw = i % w - j % w + w - 1
            idx[i, j] = dh * (2 * w - 1) + dw
    return idx


@pytest.mark.parametrize("impl", ["port", "reference"])
@pytest.mark.parametrize("h,w", [(1, 1), (2, 2), (3, 5), (7, 7), (14, 14)])
def test_rel_index_matches_loop(h, w, impl):
    fn = tatt.rel_index if impl == "port" else rc.rel_index
    assert torch.equal(fn(h, w), _loop_index(h, w))


@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (7, 7), (14, 14)])
def test_rel_bias_backward_matches_plain_indexing(h, w):
    """The gather's diagonal-sum backward against the index-put that plain
    indexing backs up through, in float64."""
    g = torch.Generator().manual_seed(h * 31 + w)
    table = torch.randn((3, 2 * h - 1, 2 * w - 1), generator=g,
                        dtype=torch.float64, requires_grad=True)
    cot = torch.randn((3, h * w, h * w), generator=g, dtype=torch.float64)
    out = tatt.rel_bias(table, h, w)
    plain = table.reshape(3, -1)[:, _loop_index(h, w)]
    assert torch.equal(out, plain)
    got, = torch.autograd.grad(out, table, cot)
    want, = torch.autograd.grad(plain, table, cot)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind,ic,oc", [("mbconv", 16, 16),
                                        ("mbconv", 16, 32),
                                        ("transformer", 32, 32),
                                        ("transformer", 32, 64)])
def test_downsampling_block_matches_reference(kind, ic, oc):
    """A stride-2 first block alone, with a projection (ic != oc) and
    without (an MBConv block then max-pools its shortcut alone; a
    transformer block projects at any stride 2): forward with its
    drop-connect draws, and the gradients of the input and every
    parameter."""
    if kind == "mbconv":
        cfg = dict(name="MBConvPreNorm", in_channels=ic, mid_channels=4 * oc,
                   se_channels=max(1, ic // 4), out_channels=oc,
                   kernel_size=3, stride=2, use_bn=True, act_func="gelu")
        keep = torch.tensor([1.0, 0.0, 1.0])
    else:
        cfg = dict(name="RelTransformerBlock", in_channels=ic,
                   mid_channels=4 * oc, out_channels=oc, resolution=4,
                   head_dim=16, stride=2, act_func="gelu")
        keep = (torch.tensor([1.0, 0.0, 1.0]), torch.tensor([0.0, 1.0, 1.0]))
    port = dataclasses.replace(set_layer_from_config(cfg),
                               drop_connect_rate=0.25)
    ref = dataclasses.replace(rc.layer_from_config(cfg),
                              drop_connect_rate=0.25)
    params, state = ref.init(Pool(torch.Generator().manual_seed(5)))
    x = torch.randn((3, ic, 8, 8), generator=torch.Generator().manual_seed(6))
    outs = []
    for layer in (port, ref):
        xs = x.clone().requires_grad_()
        ps = rsteps.tree_map(lambda t: t.clone().requires_grad_(), params)
        y, _ = layer.apply(ps, state, xs, training=True, keep=keep)
        assert y.shape == (3, oc, 4, 4)
        leaves = [xs] + rsteps.leaves(ps)
        grads = torch.autograd.grad((y * y).sum() / 2, leaves)
        outs.append([y] + list(grads))
    for a, b in zip(*outs):
        _close(a, b)


@pytest.mark.parametrize("entry", ["network", "MBConvPreNorm",
                                   "RelTransformerBlock"])
def test_config_codec_round_trip(entry):
    """model.config -> EvalNetwork -> model.config, key for key, for the
    committed CoAtNet-2 config and for each new layer's entry."""
    with open(os.path.join(ROOT, "configs", "coatnet2.config")) as f:
        cfg = json.load(f)
    if entry == "network":
        net = EvalNetwork.from_config(1000, cfg)
        assert json.dumps(net.config) == json.dumps(cfg)
        assert "feature_mix_layer" not in cfg
        assert [len(cfg[f"stage{i}"]) for i in range(1, 7)] == \
            [2, 6, 14, 2, 0, 0]
        return
    stage = "stage2" if entry == "MBConvPreNorm" else "stage3"
    for c in cfg[stage]:
        layer = set_layer_from_config(c)
        assert layer.name == entry and layer.config == c


def test_fold_batchnorm_matches_unfolded():
    """fold_batchnorm's eval forward against the unfolded one, with drawn
    BN affines and running statistics (the pre-norm BN folded into the
    first 1x1 convolution of each MBConv block), in f32."""
    net, _, params, bn, x, _ = _tiny()
    g = torch.Generator().manual_seed(7)

    def drawn(path, t):
        u = torch.rand(t.shape, generator=g)
        return t + (0.5 * u + 0.1 if path.endswith("var")
                    or path.endswith("scale") else u - 0.5)

    def redraw(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: redraw(v, f"{prefix}/{k}") for k, v in tree.items()}
        return drawn(prefix, tree)

    params, bn = redraw(params), redraw(bn)
    want, _ = net.apply(params, bn, x)
    fnet, fparams = tfold.fold_batchnorm(net, params, bn)
    assert all(not b.use_bn for b in fnet.stages["stage1"])
    got, _ = fnet.apply(fparams, {}, x)
    _close(got, want)


def _coatnet2():
    with open(os.path.join(ROOT, "configs", "coatnet2.config")) as f:
        return EvalNetwork.from_config(1000, json.load(f))


def test_coatnet2_parameter_count():
    """75 M published; counted from the layer shapes under fake tensors
    (no values drawn)."""
    with FakeTensorMode():
        params, _ = _coatnet2().init(torch.Generator().manual_seed(0))
    n = tflops.count_parameters_in_MB(params)
    assert abs(n - 75.0) <= 0.03 * 75.0, n


def test_coatnet2_multiply_adds():
    """15.7 G published; cost/flops.py's count, with the stage split of
    the hand count (S0 1.89, S1 0.85, S2 2.44, S3 9.14, S4 1.19 G)."""
    net = _coatnet2()
    total = tflops.calculate_FLOPs_in_M(net) / 1e3
    assert abs(total - 15.7) <= 0.03 * 15.7, total
    res, split = 224, []
    f0, res = tflops.layer_flops(net.first_stem, res)
    f1, res = tflops.layer_flops(net.second_stem, res)
    split.append(f0 + f1)
    for blocks in list(net.stages.values())[:4]:
        s = 0.0
        for b in blocks:
            f, res = tflops.layer_flops(b, res)
            s += f
        split.append(s)
    want = [1.8946, 0.8543, 2.4381, 9.1440, 1.1925]
    for got, w in zip(split, want):
        assert abs(got / 1e9 - w) < 1e-3, (split, want)
    assert isinstance(net.stages["stage1"][0], MBConvPreNorm)


def test_train_eval_and_test_drivers_take_a_coatnet_config(tmp_path):
    """The normal path with no side script: train_eval retrains a tiny
    CoAtNet from its model.config (--synthetic), writes the config back
    key for key, and test.py scores the checkpoint it wrote."""
    from tfnas_tpu_torch import test as test_driver
    from tfnas_tpu_torch import train_eval
    cfg = EvalNetwork.from_config(CLASSES, rc.model_config(**TINY)).config
    path = tmp_path / "coatnet.config"
    path.write_text(json.dumps(cfg))
    common = ["--synthetic", "--device", "cpu", "--image_size", "64",
              "--num_classes", str(CLASSES), "--batch_size", "4"]
    run_dir = train_eval.main(["--config_path", str(path), "--epochs", "1",
                               "--steps_per_epoch", "2",
                               "--save", str(tmp_path / "run")] + common)
    with open(os.path.join(run_dir, "model.config")) as f:
        assert json.load(f) == cfg
    got = test_driver.main(["--config_path", str(path), "--weights",
                            os.path.join(run_dir, "checkpoint.pkl")]
                           + common)
    assert all(torch.isfinite(torch.tensor(v)) for v in got.values())
