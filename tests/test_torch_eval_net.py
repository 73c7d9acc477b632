"""The port's eval network against the JAX package's, on the CPU: the layer
codec (config, set_layer_from_config), the layers the eval net adds, the
eval forward with injected drop-connect and dropout draws, FLOPs, parameter
counts and LUT latency, and the BN and space-to-depth folds.

Tolerances: layers and the codec 1e-5; the eval forward (logits and the new
BN state) 1e-4; the folds against the unfolded forward 1e-5 in f32; config
bytes, FLOPs, parameter MB and LUT latency exact."""

import glob
import json
import os
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_lat_lut_tpu import build_space_analytic_lut as jax_analytic_lut
from tfnas_tpu.cost import flops as jflops
from tfnas_tpu.cost import lut as jlut
from tfnas_tpu.models import folding as jfold
from tfnas_tpu.models import search_space as jss
from tfnas_tpu.models.eval_net import EvalNetwork as JNet
from tfnas_tpu.ops import layers as jlayers
from tfnas_tpu.search.parser import get_mc_num_dddict
from tfnas_tpu_torch.convert import params_from_jax, params_to_jax
from tfnas_tpu_torch.cost import flops as tflops
from tfnas_tpu_torch.cost import lut as tlut
from tfnas_tpu_torch.models import folding as tfold
from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.models.eval_net import EvalNetwork as TNet
from tfnas_tpu_torch.ops import layers as tlayers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                                rtol=tol, atol=tol),
        got, want)


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _perturbed_state(state, seed):
    """Running statistics away from their init values."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape) ** 2
                   ).astype(np.float32), state)


def _parsed(space, shift):
    return OrderedDict(
        (stage, OrderedDict((b, (i + shift) % 8)
                            for i, b in enumerate(space.block_names(stage))))
        for stage in space.STAGE_NAMES)


LAYERS = [
    ("ConvLayer", dict(in_channels=4, out_channels=8, kernel_size=3,
                       stride=2, act_func="relu6")),
    ("ConvLayer", dict(in_channels=4, out_channels=8, kernel_size=1,
                       groups=2, has_shuffle=True, bias=True,
                       act_func="swish")),
    ("ConvLayer", dict(in_channels=6, out_channels=8, kernel_size=3,
                       ops_order="bn_act_weight", act_func="relu")),
    ("IdentityLayer", dict(in_channels=6, out_channels=6, use_bn=True,
                           affine=True, act_func="h-swish")),
    ("MBInvertedResBlock", dict(in_channels=8, mid_channels=24,
                                se_channels=8, out_channels=8,
                                kernel_size=5, stride=1, act_func="swish",
                                bias=True)),
    ("MBInvertedResBlock", dict(in_channels=8, mid_channels=16,
                                se_channels=0, out_channels=8,
                                kernel_size=3, stride=1, groups=2,
                                has_shuffle=True, act_func="relu")),
    ("MBInvertedResBlock", dict(in_channels=6, mid_channels=4,
                                se_channels=3, out_channels=10,
                                kernel_size=3, stride=2, act_func="relu6")),
]


@pytest.mark.parametrize("case", range(len(LAYERS)))
def test_layer_codec_matches_jax(case):
    name, kw = LAYERS[case]
    jl = getattr(jlayers, name)(**kw)
    tl = getattr(tlayers, name)(**kw)
    assert json.dumps(tl.config) == json.dumps(jl.config)
    assert tlayers.set_layer_from_config(jl.config) == tl
    assert tlayers.set_layer_from_config(tl.config).config == jl.config
    assert tlayers.set_layer_from_config(None) is None
    # the hybrid space's ViTBlock entry, against the JAX codec
    vit = {"name": "ViTBlock", "in_channels": 112, "mid_channels": 576,
           "out_channels": 192, "num_heads": 4, "stride": 2, "affine": True,
           "act_func": "swish"}
    tv, jv = tlayers.set_layer_from_config(vit), \
        jlayers.set_layer_from_config(vit)
    assert json.dumps(tv.config) == json.dumps(jv.config) == json.dumps(vit)
    assert tv.has_patch_merge == jv.has_patch_merge


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("case", range(len(LAYERS)))
def test_layer_forward_matches_jax(case, training):
    name, kw = LAYERS[case]
    jl = getattr(jlayers, name)(**kw)
    tl = getattr(tlayers, name)(**kw)
    params, state = jl.init(jax.random.PRNGKey(case))
    state = _perturbed_state(state, case)
    rng = np.random.default_rng(case)
    x = rng.standard_normal((4, 9, 9, kw["in_channels"])).astype(np.float32)
    want, wst = jl.apply(params, state, jnp.asarray(x), training=training)
    got, gst = tl.apply(params_from_jax(_np(params)),
                        params_from_jax(state), _nchw(x), training=training)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    _close(params_to_jax(gst), _np(wst), 1e-5)


def test_drop_connect_with_injected_draw():
    blk = dict(in_channels=8, mid_channels=16, se_channels=4, out_channels=8,
               kernel_size=3, stride=1, act_func="relu",
               drop_connect_rate=0.4)
    jl, tl = jlayers.MBInvertedResBlock(**blk), tlayers.MBInvertedResBlock(**blk)
    params, state = jl.init(jax.random.PRNGKey(3))
    x = np.random.default_rng(3).standard_normal((8, 6, 6, 8)).astype(
        np.float32)
    key = jax.random.PRNGKey(11)
    want, _ = jl.apply(params, state, jnp.asarray(x), training=True, rng=key)
    u = jax.random.uniform(key, (8, 1, 1, 1), jnp.float32)
    keep = np.array(jnp.floor(0.6 + u)).reshape(8)
    assert 0 < keep.sum() < 8  # both branches of the draw are exercised
    got, _ = tl.apply(params_from_jax(_np(params)), params_from_jax(state),
                      _nchw(x), training=True, keep=torch.from_numpy(keep))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    xt = torch.randn(8, 3, 2, 2)
    np.testing.assert_allclose(
        tlayers.drop_connect(xt, torch.from_numpy(keep), 0.4).numpy(),
        np.asarray(jlayers.drop_connect(jnp.asarray(xt.numpy()), key, 0.4)),
        **TOL)


def _model_configs():
    paths = [os.path.join(ROOT, "configs", "tfnas_a_tpu.config")]
    paths += sorted(glob.glob(os.path.join(
        ROOT, "checkpoints_e2e", "*retrain", "*", "model.config")))[:3]
    return paths


@pytest.mark.parametrize("path", _model_configs(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_from_config_roundtrip_flops_params(path):
    cfg = json.load(open(path))
    jn, tn = JNet.from_config(1000, cfg, 0.2, 0.2), TNet.from_config(
        1000, cfg, 0.2, 0.2)
    assert json.dumps(tn.config, indent=4) == json.dumps(jn.config, indent=4)
    assert [b.drop_connect_rate for _, _, b in tn.iter_blocks()] == \
        [b.drop_connect_rate for _, _, b in jn.iter_blocks()]
    assert tn.second_stem.drop_connect_rate == jn.second_stem.drop_connect_rate
    assert tflops.calculate_FLOPs_in_M(tn) == jflops.calculate_FLOPs_in_M(jn)
    jp, _ = jax.eval_shape(jn.init, jax.random.PRNGKey(0))  # shapes only
    tp, _ = tn.init(torch.Generator().manual_seed(0))
    assert tflops.count_parameters_in_MB(tp) == \
        jflops.count_parameters_in_MB(jp)
    assert jax.tree_util.tree_map(np.shape, params_to_jax(tp)) == \
        jax.tree_util.tree_map(np.shape, jp)


@pytest.mark.parametrize("shift", [0, 3, 5])
def test_from_parsed_arch_config_bytes_and_lut_latency(shift):
    parsed = _parsed(jss, shift)
    jmc = get_mc_num_dddict(jss.build_mc_mask_dddict())
    jn = JNet.from_parsed_arch(1000, parsed, jmc)
    tn = TNet.from_parsed_arch(1000, parsed, jmc)
    assert json.dumps(tn.config, indent=4) == json.dumps(jn.config, indent=4)
    lut = tlut.load_lat_lookup(os.path.join(ROOT, "latency_pkl",
                                            "latency_tpu.pkl"))
    assert tn.get_lookup_latency(lut) == jn.get_lookup_latency(
        jlut.load_lat_lookup(os.path.join(ROOT, "latency_pkl",
                                          "latency_tpu.pkl")))
    assert tflops.calculate_FLOPs_in_M(tn, 224) == \
        jflops.calculate_FLOPs_in_M(jn, 224)
    assert tn.get_lookup_latency({}) == 0.0
    # op 8 where the mbconv registry has no slot for it: both packages
    # fail on the width lookup
    for net in (JNet, TNet):
        with pytest.raises(KeyError):
            net.from_parsed_arch(1000, {"stage1": {"block1": 8}}, jmc)


@pytest.fixture(scope="module")
def tiny():
    """A tiny-space eval net with drop-connect and dropout, JAX params and
    perturbed running statistics."""
    jsp, tsp = jss.tiny_space(32), tss.tiny_space(32)
    parsed = _parsed(jsp, 5)
    mc = get_mc_num_dddict(jsp.build_mc_mask_dddict())
    jn = JNet.from_parsed_arch(10, parsed, mc, 0.3, 0.5, space=jsp)
    tn = TNet.from_parsed_arch(10, parsed, mc, 0.3, 0.5, space=tsp)
    params, state = jn.init(jax.random.PRNGKey(7))
    state = _perturbed_state(state, 7)
    x = np.random.default_rng(8).standard_normal((8, 32, 32, 3)).astype(
        np.float32)
    return jn, tn, _np(params), state, x


def jax_keep_draws(jnet, key, n):
    """The drop-connect and dropout draws JAX's EvalNetwork.apply makes
    from `key`, in the port's `keep` form."""
    rngs = jax.random.split(key, 1 + jnet.block_count)
    keep = []
    blocks = [jnet.second_stem] + [b for _, _, b in jnet.iter_blocks()]
    for r, b in zip(rngs, blocks):
        if b.drop_connect_rate > 0.0 and b.has_residual:
            u = jax.random.uniform(r, (n, 1, 1, 1), jnp.float32)
            keep.append(torch.from_numpy(np.array(
                jnp.floor((1.0 - b.drop_connect_rate) + u)).reshape(n)))
        else:
            keep.append(None)
    feats = jnet.feature_mix_layer.out_channels
    keep.append(torch.from_numpy(np.array(jax.random.bernoulli(
        rngs[-1], 1.0 - jnet.dropout_rate, (n, feats)))))
    return keep


@pytest.mark.parametrize("training", [False, True])
def test_eval_forward_matches_jax(tiny, training):
    jn, tn, params, state, x = tiny
    key = jax.random.PRNGKey(13)
    want, wst = jn.apply(params, state, jnp.asarray(x), training=training,
                         rng=key if training else None)
    keep = jax_keep_draws(jn, key, len(x)) if training else None
    if training:
        assert any(k is not None and 0 < k.sum() < len(x) for k in keep[:-1])
    got, gst = tn.apply(params_from_jax(params), params_from_jax(state),
                        torch.from_numpy(x), training=training, keep=keep)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    _close(params_to_jax(gst), _np(wst), 1e-4)


def test_eval_forward_rate_zero_and_own_draws(tiny):
    jn, tn, params, state, x = tiny
    tp, ts = params_from_jax(params), params_from_jax(state)
    xt = torch.from_numpy(x)
    # training without draws drops nothing: JAX's rng=None
    want, _ = jn.apply(params, state, jnp.asarray(x), training=True)
    got, _ = tn.apply(tp, ts, xt, training=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    keep = tn.draw_keep(len(x), torch.Generator().manual_seed(0))
    assert len(keep) == tn.block_count + 1
    assert keep[-1].shape == (len(x), tn.feature_mix_layer.out_channels)
    assert keep[-1].dtype == torch.bool
    logits, _ = tn.apply(tp, ts, xt, training=True, keep=keep)
    assert logits.shape == (len(x), 10) and torch.isfinite(logits).all()


def test_fold_batchnorm_matches_jax_and_unfolded(tiny):
    jn, tn, params, state, x = tiny
    tp, ts = params_from_jax(params), params_from_jax(state)
    xt = torch.from_numpy(x)
    ref, _ = tn.apply(tp, ts, xt)
    folded, fparams = tfold.fold_batchnorm(tn, tp, ts)
    got, _ = folded.apply(fparams, {}, xt)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    for _, _, block in folded.iter_blocks():
        assert not block.use_bn and block.bias
    assert json.dumps(folded.config) == json.dumps(
        jfold.fold_batchnorm(jn, params, state)[0].config)
    _, jfparams = jfold.fold_batchnorm(jn, params, state)
    _close(params_to_jax(fparams), _np(jfparams), 1e-5)

    s2d, sparams = tfold.fold_stem_space_to_depth(folded, fparams)
    got2, _ = s2d.apply(sparams, {}, xt)
    np.testing.assert_allclose(got2.numpy(), ref.numpy(), **TOL)
    assert s2d.first_stem.name == "SpaceToDepthStem"
    assert s2d.first_stem.stride == 2
    _, jsparams = jfold.fold_stem_space_to_depth(
        *jfold.fold_batchnorm(jn, params, state))
    _close(params_to_jax(sparams), _np(jsparams), 1e-5)
    with pytest.raises(ValueError, match="fold_batchnorm first"):
        tfold.fold_stem_space_to_depth(tn, tp)


def test_s2d_stem_layer_equals_reference_conv_directly():
    """The repacked stem alone equals the 3x3 stride-2 convolution, and its
    kernel is the JAX package's s2d kernel in OIHW."""
    g = torch.Generator().manual_seed(4)
    w = torch.randn((16, 3, 3, 3), generator=g)
    b = torch.randn((16,), generator=g)
    x = torch.randn((2, 3, 32, 32), generator=g)
    ref = torch.nn.functional.conv2d(x, w, b, 2, 1)
    lay = tfold.SpaceToDepthStem(in_channels=3, out_channels=16,
                                 act_func=None)
    kernel = tfold._s2d_stem_kernel(w)
    got, _ = lay.apply({"conv": {"kernel": kernel, "bias": b}}, {}, x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    want = np.asarray(jfold._s2d_stem_kernel(w.permute(2, 3, 1, 0).numpy()))
    np.testing.assert_array_equal(kernel.permute(2, 3, 1, 0).numpy(), want)


def test_tiny_analytic_lut_latency_matches_jax(tiny):
    jn, tn, _, _, _ = tiny
    assert tn.get_lookup_latency(
        tlut.build_space_analytic_lut(tss.tiny_space(32)), 32) == \
        jn.get_lookup_latency(jax_analytic_lut(jss.tiny_space(32)), 32)
    assert tflops.calculate_FLOPs_in_M(tn, 32) == \
        jflops.calculate_FLOPs_in_M(jn, 32)
