"""One warmup, weight and arch step of the port (tfnas_tpu_torch.search.
train_step) against the JAX steps on identical converted state, tiny space,
f32, on the CPU. The JAX steps draw their op indices and Gumbel noise from
a PRNG key; the same draws are made here with jax.random and handed to the
port's steps, which take them as arguments. Tolerance 1e-5 (f32 sums in
different orders); masked-out channels must not move at all."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfnas_tpu.models import search_space as jss
from tfnas_tpu.models.supernet import SuperNetwork as JNet
from tfnas_tpu.search.bisample import (sample_gumbel_indices,
                                       sample_random_excluding)
from tfnas_tpu.search.train_step import (adam_init as jadam_init,
                                         make_search_steps as jsteps,
                                         zeros_like_momentum)
from tfnas_tpu_torch.convert import (arch_from_jax, params_from_jax,
                                     params_to_jax)
from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.models.supernet import SuperNetwork as TNet
from tfnas_tpu_torch.search.train_step import (adam_init, make_search_steps,
                                               zeros_like_tree)
from tfnas_tpu_torch.utils.checkpoint import to_numpy_tree

TOL = dict(rtol=1e-5, atol=1e-5)
N, RES, CLASSES = 4, 32, 10
KW = dict(num_classes=CLASSES, lambda_lat=0.5, target_lat=0.02,
          lat_under_boost=2.0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got_jax_layout, want):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, np.asarray(w), **TOL),
        got_jax_layout, want)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    jnet = JNet(CLASSES, space=jss.tiny_space(RES))
    tnet = TNet(CLASSES, space=tss.tiny_space(RES))
    params = params_to_jax(tnet.init(torch.Generator().manual_seed(1))[0])
    nblk = len(jnet.sites)
    arch = {"log_alphas": (rng.standard_normal((nblk, 8)) * 0.5
                           ).astype(np.float32),
            "betas": {s: rng.standard_normal(d).astype(np.float32)
                      for s, d in jnet.ss.STAGE_DEPTHS.items()}}
    mc = jnet.ss.build_mc_mask_dddict()
    for stage in mc:  # switch off some live channels
        for block in mc[stage]:
            for m in mc[stage][block].values():
                m[rng.choice(np.nonzero(m)[0], 3, replace=False)] = 0.0
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    return dict(
        jnet=jnet, tnet=tnet, params=params, arch=arch, mc=mc,
        jparams=jparams, jarch=jax.tree_util.tree_map(jnp.asarray, arch),
        jmasks=jnet.device_masks(mc), jum=jnet.update_masks(jparams, mc),
        tmasks=tnet.device_masks(mc, "cpu"),
        tum=tnet.update_masks(params_from_jax(params), mc),
        x=rng.standard_normal((N, RES, RES, 3)).astype(np.float32),
        y=rng.integers(0, CLASSES, N).astype(np.int32),
        lat=rng.uniform(0.0, 0.01, (nblk, 8)).astype(np.float32),
        key=jax.random.PRNGKey(3))


def _check_frozen(s, old, new):
    """Entries the update masks zero keep their exact value."""
    for site in s["jnet"].sites:
        um = s["tum"][site.stage][site.block]
        for name in ("expand", "depth", "project"):
            m = um[name]["kernel"].expand_as(
                new[site.stage][site.block][name]["kernel"]) == 0
            o = old[site.stage][site.block][name]["kernel"]
            n = new[site.stage][site.block][name]["kernel"]
            assert m.any() and torch.equal(o[m], n[m])


@pytest.mark.parametrize("kind", ["warmup", "weight"])
def test_weight_steps_match_jax(setup, kind):
    s = setup
    js = jsteps(s["jnet"], **KW)
    ts = make_search_steps(s["tnet"], **KW)
    lr = 0.025
    # the JAX steps donate params and momentum: give them fresh copies
    jparams = jax.tree_util.tree_map(jnp.asarray, s["params"])
    jargs = (jparams, s["jarch"], zeros_like_momentum(jparams), s["jmasks"], s["jum"],
             jnp.asarray(s["x"]), jnp.asarray(s["y"]), jnp.float32(lr),
             s["key"])
    la = s["jarch"]["log_alphas"]
    if kind == "warmup":
        jp, jm, jmet = js.warmup_step(*jargs)
        draws = (sample_gumbel_indices(s["key"], la),)
    else:
        jp, jm, jmet = js.weight_step(*jargs)
        kg, kr = jax.random.split(s["key"])
        g = sample_gumbel_indices(kg, la)
        draws = (g, sample_random_excluding(kr, g, 8))
    draws = [torch.from_numpy(np.asarray(d)).long() for d in draws]

    tp = params_from_jax(s["params"])
    step = ts.warmup_step if kind == "warmup" else ts.weight_step
    np_, nm, tmet = step(tp, arch_from_jax(s["arch"]), zeros_like_tree(tp),
                         s["tmasks"], s["tum"], torch.from_numpy(s["x"]),
                         torch.from_numpy(s["y"]).long(), lr, *draws)
    _close(params_to_jax(np_), jp)
    _close(params_to_jax(nm), jm)
    for k in ("loss", "top1", "top5"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)
    _check_frozen(s, tp, np_)


def test_arch_step_matches_jax(setup):
    s = setup
    js = jsteps(s["jnet"], **KW)
    ts = make_search_steps(s["tnet"], **KW)
    T, base = 5.0, 0.004
    jarch = jax.tree_util.tree_map(jnp.asarray, s["arch"])
    ja, jopt, jmet = js.arch_step(
        s["jparams"], jarch, jadam_init(jarch), s["jmasks"],
        jnp.asarray(s["x"]), jnp.asarray(s["y"]), jnp.asarray(s["lat"]),
        jnp.float32(base), jnp.float32(T), s["key"])
    u = jax.random.uniform(s["key"], s["arch"]["log_alphas"].shape,
                           jnp.float32, minval=1e-10, maxval=1.0)
    ta0 = arch_from_jax(s["arch"])
    ta, topt, tmet = ts.arch_step(
        params_from_jax(s["params"]), ta0, adam_init(ta0), s["tmasks"],
        torch.from_numpy(s["x"]), torch.from_numpy(s["y"]).long(),
        torch.from_numpy(s["lat"]), base, T,
        torch.from_numpy(np.asarray(u)))
    _close(to_numpy_tree(ta), ja)
    _close(to_numpy_tree(topt.mu), jopt.mu)
    _close(to_numpy_tree(topt.nu), jopt.nu)
    assert topt.step == int(jopt.step) == 1
    for k in ("loss_a", "loss_l", "lat"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)


def test_val_step_matches_jax(setup):
    s = setup
    js = jsteps(s["jnet"], **KW)
    ts = make_search_steps(s["tnet"], **KW)
    wmask = np.array([1, 1, 1, 0], np.float32)
    jmet = js.val_step(s["jparams"], s["jarch"], s["jmasks"],
                       jnp.asarray(s["x"]), jnp.asarray(s["y"]), s["key"],
                       jnp.asarray(wmask))
    idx = sample_gumbel_indices(s["key"], s["jarch"]["log_alphas"])
    tmet = ts.val_step(params_from_jax(s["params"]), arch_from_jax(s["arch"]),
                       s["tmasks"], torch.from_numpy(s["x"]),
                       torch.from_numpy(s["y"]).long(),
                       torch.from_numpy(np.asarray(idx)).long(),
                       torch.from_numpy(wmask))
    for k in ("loss", "top1", "top5"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4,
                                   atol=1e-4)
