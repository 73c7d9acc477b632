"""The port's ops, layers, search space and LUT helpers against the JAX
package's, on the CPU. f32 tolerance 1e-5 unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_lat_lut_tpu import build_space_analytic_lut as jax_analytic_lut
from tfnas_tpu.cost import lut as jlut
from tfnas_tpu.models import search_space as jss
from tfnas_tpu.ops import activations as jact
from tfnas_tpu.ops import batchnorm as jbn
from tfnas_tpu.ops import layers as jlayers
from tfnas_tpu_torch.convert import params_from_jax, params_to_jax
from tfnas_tpu_torch.cost import lut as tlut
from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.ops import activations as tact
from tfnas_tpu_torch.ops import batchnorm as tbn
from tfnas_tpu_torch.ops import conv as tconv
from tfnas_tpu_torch.ops import layers as tlayers

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(jact.ACT_FNS) + [None])
def test_activations_match_jax(name):
    x = np.linspace(-8, 8, 101, dtype=np.float32)
    got = tact.apply_act(torch.from_numpy(x), name).numpy()
    np.testing.assert_allclose(got, np.asarray(jact.apply_act(
        jnp.asarray(x), name)), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tact.get_act_fn("mish")


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("training", [False, True])
def test_batch_norm_matches_jax(affine, training):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 5, 5, 6)) * 3 + 1).astype(np.float32)
    jp, js = jbn.init_bn(6, affine)
    tp, ts = tbn.init_bn(6, affine)
    if affine:
        g = rng.uniform(0.5, 2, 6).astype(np.float32)
        jp, tp = {"scale": jnp.asarray(g), "bias": jnp.ones(6)}, {
            "scale": torch.from_numpy(g), "bias": torch.ones(6)}
        js = {"mean": jnp.full(6, 0.5), "var": jnp.full(6, 2.0)}
        ts = {"mean": torch.full((6,), 0.5), "var": torch.full((6,), 2.0)}
    wy, wst = jbn.batch_norm(jnp.asarray(x), jp, js, affine=affine,
                             training=training)
    gy, gst = tbn.batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2), tp, ts,
                             affine=affine, training=training)
    np.testing.assert_allclose(gy.permute(0, 2, 3, 1).numpy(),
                               np.asarray(wy), rtol=1e-5, atol=1e-5)
    for k in wst:
        np.testing.assert_allclose(gst[k].numpy(), np.asarray(wst[k]), **TOL)
    assert tbn.stat_dtype(torch.bfloat16) == torch.float32
    assert tbn.stat_dtype(torch.float64) == torch.float64


def test_uniform_init_fan_in():
    g = torch.Generator().manual_seed(0)
    k = tconv.init_conv_kernel(3, 3, 16, 4000, g)
    bound = 1.0 / np.sqrt(3 * 3 * 16)
    assert k.shape == (4000, 16, 3, 3)
    assert k.abs().max() <= bound
    np.testing.assert_allclose(k.std().item(), bound / np.sqrt(3), rtol=0.01)
    lin = tconv.init_linear(64, 10, g)
    assert lin["kernel"].shape == (64, 10) and not lin["bias"].any()
    assert lin["kernel"].abs().max() <= 1 / 8


@pytest.mark.parametrize("layer", [
    ("ConvLayer", dict(in_channels=3, out_channels=16, kernel_size=3,
                       stride=2, act_func="relu", affine=False)),
    ("MBInvertedResBlock", dict(in_channels=16, mid_channels=16,
                                se_channels=4, out_channels=8, kernel_size=3,
                                stride=1, act_func="relu", affine=False)),
    ("MBInvertedResBlock", dict(in_channels=8, mid_channels=48,
                                se_channels=8, out_channels=8, kernel_size=5,
                                stride=1, act_func="swish", affine=True)),
])
def test_layers_match_jax(layer):
    name, cfg = layer
    jl = getattr(jlayers, name)(**cfg)
    tl = getattr(tlayers, name)(**cfg)
    jp, js = jl.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, cfg["in_channels"])).astype(np.float32)
    wy, _ = jl.apply(jp, js, jnp.asarray(x), training=True)
    ts = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), js)
    gy, _ = tl.apply(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)),
                     ts, torch.from_numpy(x).permute(0, 3, 1, 2),
                     training=True)
    np.testing.assert_allclose(gy.permute(0, 2, 3, 1).numpy(),
                               np.asarray(wy), rtol=1e-4, atol=1e-4)
    tp, _ = tl.init(torch.Generator().manual_seed(0))
    assert jax.tree_util.tree_map(np.shape, params_to_jax(tp)) == \
        jax.tree_util.tree_map(np.shape, jp)


def test_linear_layer_matches_jax():
    jl, tl = jlayers.LinearLayer(32, 5), tlayers.LinearLayer(32, 5)
    jp, _ = jl.init(jax.random.PRNGKey(2))
    x = np.random.default_rng(2).standard_normal((3, 32)).astype(np.float32)
    wy, _ = jl.apply(jp, {}, jnp.asarray(x))
    gy, _ = tl.apply(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)),
                     {}, torch.from_numpy(x))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)


@pytest.mark.parametrize("space", ["full", "tiny"])
def test_search_space_matches_jax(space):
    jsp = jss if space == "full" else jss.tiny_space(32)
    tsp = tss if space == "full" else tss.tiny_space(32)
    for attr in ("STAGE_NAMES", "STAGE_DEPTHS", "TOTAL_BLOCKS",
                 "BLOCK_INPUT_RES", "STAGE_SPECS", "PRIMITIVES"):
        assert getattr(tsp, attr) == getattr(jsp, attr), attr
    assert tsp.build_lat_lookup_key_dddict() == jsp.build_lat_lookup_key_dddict()
    jm, tm = jsp.build_mc_mask_dddict(), tsp.build_mc_mask_dddict()
    for stage in jm:
        for block in jm[stage]:
            for o in jm[stage][block]:
                np.testing.assert_array_equal(tm[stage][block][o],
                                              jm[stage][block][o])


def test_lut_matches_jax():
    path = "latency_pkl/latency_tpu.pkl"
    jt, tt = jlut.load_lat_lookup(path), tlut.load_lat_lookup(path)
    assert tt == jt
    assert min(v for k, d in tt.items() if k != "base"
               for v in d.values()) >= 0.0
    mc = jss.build_mc_mask_dddict()
    from tfnas_tpu.search.parser import get_mc_num_dddict
    mcn = get_mc_num_dddict(mc)
    np.testing.assert_array_equal(tlut.lat_vectors_for_mc(tt, mcn),
                                  jlut.lat_vectors_for_mc(jt, mcn))
    arch = {s: {b: (i % 8) for i, b in enumerate(jss.block_names(s))}
            for s in jss.STAGE_NAMES}
    assert tlut.get_lookup_latency(arch, mcn, tss.lat_lookup_key_dddict,
                                   tt) == jlut.get_lookup_latency(
        arch, mcn, jss.lat_lookup_key_dddict, jt)


def test_analytic_lut_matches_jax_builder():
    assert tlut.build_space_analytic_lut(tss.tiny_space(32)) == \
        jax_analytic_lut(jss.tiny_space(32))
