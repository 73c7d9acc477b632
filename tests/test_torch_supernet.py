"""Parity of the PyTorch supernet (tfnas_tpu_torch.models.supernet) with the
JAX one on the tiny space, on the CPU: identical parameters (converted from
the JAX tree), masks, inputs, op indices and Gumbel weights, made with numpy
from a seed. f32 throughout; tolerance 1e-4 (both sides sum in f32 in
different orders)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfnas_tpu.kernels import fused_dw as jfused
from tfnas_tpu.models import search_space as jss
from tfnas_tpu.models.supernet import SuperNetwork as JNet
from tfnas_tpu_torch.convert import (arch_from_jax, params_from_jax,
                                     params_to_jax)
from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.models.supernet import SuperNetwork as TNet

TOL = dict(rtol=1e-4, atol=1e-4)
N, RES, CLASSES = 4, 32, 10


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    # the JAX kernel runs in Pallas interpret mode on the CPU, as in
    # tests/test_kernels.py
    orig = jfused.pl.pallas_call
    monkeypatch.setattr(jfused.pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _masks(space, rng):
    """Initial masks with a few live channels switched off per op."""
    mc = space.build_mc_mask_dddict()
    for stage in mc:
        for block in mc[stage]:
            for o, m in mc[stage][block].items():
                live = np.nonzero(m)[0]
                m[rng.choice(live, size=2, replace=False)] = 0.0
    return mc


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jnet = JNet(CLASSES, space=jss.tiny_space(RES))
    tnet = TNet(CLASSES, space=tss.tiny_space(RES))
    # parameters made by the port's init, converted to the JAX layout
    params = params_to_jax(tnet.init(torch.Generator().manual_seed(0))[0])
    nblk = len(jnet.sites)
    arch = {"log_alphas": (rng.standard_normal((nblk, 8)) * 0.5
                           ).astype(np.float32),
            "betas": {s: rng.standard_normal(d).astype(np.float32)
                      for s, d in jnet.ss.STAGE_DEPTHS.items()}}
    mc = _masks(jnet.ss, rng)
    return dict(
        jnet=jnet, tnet=tnet, params=params, arch=arch, mc=mc,
        jmasks=jnet.device_masks(mc), tmasks=tnet.device_masks(mc, "cpu"),
        x=rng.standard_normal((N, RES, RES, 3)).astype(np.float32),
        y=rng.integers(0, CLASSES, N),
        idx_a=rng.integers(0, 8, nblk), idx_b=rng.integers(0, 8, nblk),
        gw=jax.nn.softmax(jnp.asarray(rng.standard_normal((nblk, 8)),
                                      jnp.float32), -1),
        lat=rng.uniform(0.0, 1.0, (nblk, 8)).astype(np.float32))


def _site_inputs(site, rng, res):
    x = rng.standard_normal((2, res, res, site.ic)).astype(np.float32)
    mask = np.zeros((8, site.width), np.float32)
    for o in range(8):
        mask[o, :site.ic * jss.OP_EXPAND[o]] = 1.0
        mask[o, rng.choice(site.ic * jss.OP_EXPAND[o], 3, replace=False)] = 0
    return x, mask


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("site_idx", [0, 2])   # stride 2 relu, stride 1 swish
def test_blocks_match_jax(setup, use_pallas, site_idx):
    """_dw_middle, _block_sampled (every op) and _block_soft against the
    JAX blocks with and without its Pallas kernel."""
    rng = np.random.default_rng(site_idx)
    jnet = JNet(CLASSES, space=jss.tiny_space(RES), use_pallas=use_pallas)
    tnet = setup["tnet"]
    site = jnet.sites[site_idx]
    p = setup["params"][site.stage][site.block]
    tp = params_from_jax(p)
    x, mask = _site_inputs(site, rng, 8)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    # _dw_middle on the e6 op 3's slice
    h = rng.standard_normal((2, 8, 8, site.width)).astype(np.float32)
    dk = p["depth"]["kernel"][3][:, :, 0, :]
    want = jax.jit(functools.partial(
        jnet._dw_middle, act=site.act, stride=site.stride))(
        jnp.asarray(h), jnp.asarray(dk), jnp.asarray(mask[3]))
    got = tnet._dw_middle(torch.from_numpy(h).permute(0, 3, 1, 2),
                          tp["depth"]["kernel"][3], torch.from_numpy(mask[3]),
                          site.act, site.stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)

    sampled = jax.jit(functools.partial(jnet._block_sampled, site,
                                        training=True))
    for op in range(8):
        want = sampled(p, jnp.asarray(mask), jnp.int32(op), jnp.asarray(x))
        got = tnet._block_sampled(site, tp, torch.from_numpy(mask),
                                  torch.tensor(op), xt, training=True)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), **TOL)

    w = rng.dirichlet(np.ones(8)).astype(np.float32)
    want = jax.jit(functools.partial(jnet._block_soft, site, training=True))(
        p, jnp.asarray(mask), jnp.asarray(w), jnp.asarray(x))
    got = tnet._block_soft(site, tp, torch.from_numpy(mask),
                           torch.from_numpy(w), xt, training=True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **TOL)


def _ce(logits, y):
    return -jnp.mean(jnp.take_along_axis(
        jax.nn.log_softmax(logits, -1), y[:, None], -1))


def _tce(logits, y):
    return torch.nn.functional.cross_entropy(logits, y)


def test_apply_sampled_pair_logits_and_grads(setup):
    s = setup
    jnet, tnet = s["jnet"], s["tnet"]

    def jloss(params, arch):
        la, lb = jnet.apply_sampled_pair(
            params, arch, s["jmasks"], jnp.asarray(s["x"]),
            jnp.asarray(s["idx_a"]), jnp.asarray(s["idx_b"]))
        y = jnp.asarray(s["y"])
        return _ce(la, y) + _ce(lb, y), (la, lb)

    (jl, (jla, jlb)), (jgp, jga) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, s["params"]),
        jax.tree_util.tree_map(jnp.asarray, s["arch"]))

    tp = params_from_jax(s["params"])
    ta = arch_from_jax(s["arch"])
    leaves = jax.tree_util.tree_leaves(tp) + jax.tree_util.tree_leaves(ta)
    for t in leaves:
        t.requires_grad_()
    la, lb = tnet.apply_sampled_pair(
        tp, ta, s["tmasks"], torch.from_numpy(s["x"]),
        torch.from_numpy(s["idx_a"]), torch.from_numpy(s["idx_b"]))
    yt = torch.from_numpy(s["y"])
    loss = _tce(la, yt) + _tce(lb, yt)
    loss.backward()

    np.testing.assert_allclose(la.detach().numpy(), np.asarray(jla), **TOL)
    np.testing.assert_allclose(lb.detach().numpy(), np.asarray(jlb), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    got_gp = params_to_jax(jax.tree_util.tree_map(lambda t: t.grad, tp))
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), **TOL),
        got_gp, jgp)
    np.testing.assert_allclose(ta["betas"]["stage1"].grad.numpy(),
                               np.asarray(jga["betas"]["stage1"]), **TOL)


def test_apply_soft_logits_latency_and_grads(setup):
    s = setup
    jnet, tnet = s["jnet"], s["tnet"]

    def jloss(params, arch, gw):
        logits, lat = jnet.apply_soft(params, arch, s["jmasks"],
                                      jnp.asarray(s["x"]), gw,
                                      jnp.asarray(s["lat"]))
        return _ce(logits, jnp.asarray(s["y"])) + lat, (logits, lat)

    (_, (jlog, jlat)), (jgp, jga, jgw) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, s["params"]),
        jax.tree_util.tree_map(jnp.asarray, s["arch"]), s["gw"])

    tp = params_from_jax(s["params"])
    ta = arch_from_jax(s["arch"])
    gw = torch.from_numpy(np.asarray(s["gw"])).requires_grad_()
    for t in jax.tree_util.tree_leaves(tp) + jax.tree_util.tree_leaves(ta):
        t.requires_grad_()
    logits, lat = tnet.apply_soft(tp, ta, s["tmasks"],
                                  torch.from_numpy(s["x"]), gw,
                                  torch.from_numpy(s["lat"]))
    (_tce(logits, torch.from_numpy(s["y"])) + lat).backward()

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlog),
                               **TOL)
    np.testing.assert_allclose(float(lat), float(jlat), **TOL)
    np.testing.assert_allclose(gw.grad.numpy(), np.asarray(jgw), **TOL)
    for stage in ta["betas"]:
        np.testing.assert_allclose(ta["betas"][stage].grad.numpy(),
                                   np.asarray(jga["betas"][stage]), **TOL)
    got_gp = params_to_jax(jax.tree_util.tree_map(lambda t: t.grad, tp))
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), **TOL),
        got_gp, jgp)


def test_masks_match_jax(setup):
    s = setup
    jnet, tnet = s["jnet"], s["tnet"]
    want = _np(jnet.update_masks(jax.tree_util.tree_map(
        jnp.asarray, s["params"]), s["mc"]))
    got = tnet.update_masks(params_from_jax(s["params"]), s["mc"])
    for site in jnet.sites:
        g = params_to_jax(got[site.stage][site.block])
        w = want[site.stage][site.block]
        for name in ("expand", "depth", "project"):
            np.testing.assert_array_equal(g[name]["kernel"],
                                          np.broadcast_to(
                                              w[name]["kernel"],
                                              g[name]["kernel"].shape))
        for k in w["se"]:
            np.testing.assert_array_equal(g["se"][k], w["se"][k])
        np.testing.assert_array_equal(
            s["tmasks"][site.stage][site.block].numpy(),
            np.asarray(s["jmasks"][site.stage][site.block]))


def test_init_matches_jax_structure(setup):
    """The port's init gives the JAX tree's keys and (converted) shapes,
    and zeros wherever JAX's update masks freeze an entry when every
    candidate is at its full width (the padding). The conv kernels are
    nonzero everywhere else."""
    s = setup
    jnet = s["jnet"]
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    flat_g = jax.tree_util.tree_flatten_with_path(s["params"])[0]
    flat_w = jax.tree_util.tree_flatten_with_path(shapes[0])[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert g.shape == w.shape, path
    full = {st: {b: {o: np.ones_like(m) for o, m in d.items()}
                 for b, d in sd.items()}
            for st, sd in jnet.ss.build_mc_mask_dddict().items()}
    um = _np(jnet.update_masks(jax.tree_util.tree_map(
        jnp.asarray, s["params"]), full))
    for site in jnet.sites:
        p, m = s["params"][site.stage][site.block], um[site.stage][site.block]
        for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
            frozen = np.broadcast_to(
                functools.reduce(lambda t, k: t[k.key], path, m) == 0,
                leaf.shape)
            assert not leaf[frozen].any(), path
            if path[0].key != "se":
                assert leaf[~frozen].all(), path
    _, ta = s["tnet"].init(torch.Generator().manual_seed(0))
    assert ta["log_alphas"].shape == (len(jnet.sites), 8)
    np.testing.assert_allclose(ta["log_alphas"].numpy(), -np.log(8.0))
    assert {k: v.shape for k, v in ta["betas"].items()} == {
        k: v.shape for k, v in shapes[1]["betas"].items()}
