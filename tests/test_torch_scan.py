"""The port's foreach optimisers, its scanned search iteration and its
driver loop against the JAX package on the CPU (tiny space, f32).

The JAX functions draw from PRNG keys; the same draws are rebuilt here with
jax.random from the keys JAX folds in, and fed to the port. Tolerances:
1e-6 for the optimisers (three steps each), 1e-5 for the search units and
for the trajectory across epoch boundaries (f32 sums in different orders);
the masks the elasticity rewrites must agree exactly."""

import collections
import glob
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from make_lat_lut_tpu import build_space_analytic_lut as jax_space_lut
from tfnas_tpu.cost.lut import lat_vectors_for_mc as jlat_vectors
from tfnas_tpu.models import search_space as jss
from tfnas_tpu.models.supernet import SuperNetwork as JNet
from tfnas_tpu.search import elasticity as jel
from tfnas_tpu.search import parser as jpa
from tfnas_tpu.search import train_step as jts
from tfnas_tpu.search.bisample import (sample_gumbel_indices,
                                       sample_random_excluding)
from tfnas_tpu_torch import train_search as tsearch
from tfnas_tpu_torch.convert import (arch_from_jax, params_from_jax,
                                     params_to_jax)
from tfnas_tpu_torch.cost.lut import build_space_analytic_lut
from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.models.supernet import SuperNetwork as TNet
from tfnas_tpu_torch.search import train_step as tts
from tfnas_tpu_torch.utils.checkpoint import to_numpy_tree

N, RES, CLASSES = 4, 32, 10
KW = dict(num_classes=CLASSES, lambda_lat=0.5, target_lat=0.02,
          lat_under_boost=2.0)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: the tests run in parallel workers,
    and torch's thread pools contending for the cores slow these
    many-small-op runs by two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got_jax_layout, want, tol=TOL):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                                **tol),
        got_jax_layout, want)


# -- the optimisers -----------------------------------------------------------

def _tree_sgd(params, grads, mom, update_masks, *, lr, momentum,
              weight_decay, grad_clip):
    """The per-leaf tree_map SGD the port had before its foreach form."""
    tm, tl = tts.tree_map, tts.tree_leaves
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in
                          tl(grads)))
    scale = torch.clamp(grad_clip / (norm + 1e-6), max=1.0)
    grads = tm(lambda g: g * scale, grads)
    d = tm(lambda g, p: g + weight_decay * p.float(), grads, params)
    mom = tm(lambda m, u: momentum * m + u, mom, d)

    def step(p, m, km):
        delta = lr * m
        return p - (delta if km is None else delta * km)
    return tm(step, params, mom, update_masks), mom


def _tree_adam(params, grads, st, *, lr, b1, b2, eps, weight_decay,
               grad_clip):
    """The per-leaf tree_map Adam the port had before (host step count)."""
    tm, tl = tts.tree_map, tts.tree_leaves
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in
                          tl(grads)))
    scale = torch.clamp(grad_clip / (norm + 1e-6), max=1.0)
    grads = tm(lambda g: g * scale, grads)
    grads = tm(lambda g, p: g + weight_decay * p.float(), grads, params)
    step = st[0] + 1
    mu = tm(lambda m, g: b1 * m + (1 - b1) * g, st[1], grads)
    nu = tm(lambda v, g: b2 * v + (1 - b2) * g * g, st[2], grads)
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    params = tm(lambda p, m, v: p - lr * (m / bc1) / (torch.sqrt(v / bc2)
                                                      + eps), params, mu, nu)
    return params, (step, mu, nu)


def _trees(seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {"a": {"k": torch.randn(8, 16, 3, 1, 1, generator=g) * scale,
                  "b": torch.randn(5, generator=g) * scale},
            "c": torch.randn(7, 3, generator=g) * scale}


SGD = dict(momentum=0.9, weight_decay=1e-5)
ADAM = dict(b1=0.5, b2=0.999, eps=1e-8, weight_decay=5e-4)


@pytest.mark.parametrize("clip", [1e9, 0.5])
def test_foreach_optimisers_match_tree_map_and_jax(clip):
    """Three SGD and three Adam steps: bit for bit against the per-leaf
    form while the clip is off; with the clip on, the global norm's
    summation order differs (one fused norm per leaf, then the norm of
    those) and they agree to 1e-6; JAX's agree to 1e-6 either way."""
    gen = torch.Generator().manual_seed(9)
    km = {"a": {"k": (torch.rand(8, 16, 1, 1, 1, generator=gen) > 0.3)
                .float(), "b": None}, "c": None}
    jkm = jax.tree_util.tree_map(
        lambda p, k: jnp.ones(p.shape, jnp.float32) if k is None
        else jnp.asarray(k.numpy()), _trees(0), km,
        is_leaf=lambda x: x is None)
    exact = clip > 1e3
    tol = dict(rtol=1e-6, atol=1e-6)

    p_new, p_old, jp = _trees(0), _trees(0), _np_tree(_trees(0))
    m_new, m_old = tts.zeros_like_tree(p_new), tts.zeros_like_tree(p_new)
    jm = jts.zeros_like_momentum(jp)
    lr = torch.tensor(0.025)
    for i in range(3):
        g = _trees(10 + i, 2.0)
        p_new, m_new = tts.sgd_momentum_update(
            p_new, g, m_new, km, lr=lr, grad_clip=clip, **SGD)
        p_old, m_old = _tree_sgd(p_old, g, m_old, km, lr=0.025,
                                 grad_clip=clip, **SGD)
        jp, jm = jts.sgd_momentum_update(jp, _np_tree(g), jm, jkm,
                                         lr=jnp.float32(0.025),
                                         grad_clip=clip, **SGD)
    _compare(p_new, p_old, exact, tol)
    _compare(m_new, m_old, exact, tol)
    _close(to_numpy_tree(p_new), jp, tol)
    _close(to_numpy_tree(m_new), jm, tol)

    p_new, p_old, jp = _trees(1), _trees(1), _np_tree(_trees(1))
    s_new = tts.adam_init(p_new)
    s_old = (0, tts.zeros_like_tree(p_old), tts.zeros_like_tree(p_old))
    js = jts.adam_init(jp)
    for i in range(3):
        g = _trees(20 + i, 2.0)
        p_new, s_new = tts.adam_update(p_new, g, s_new, lr=0.01,
                                       grad_clip=clip, **ADAM)
        p_old, s_old = _tree_adam(p_old, g, s_old, lr=0.01, grad_clip=clip,
                                  **ADAM)
        jp, js = jts.adam_update(jp, _np_tree(g), js, lr=0.01,
                                 grad_clip=clip, **ADAM)
    assert isinstance(s_new.step, torch.Tensor) and s_new.step.dim() == 0
    assert float(s_new.step) == s_old[0] == int(js.step) == 3
    for a, b in ((p_new, p_old), (s_new.mu, s_old[1]), (s_new.nu, s_old[2])):
        _compare(a, b, exact, tol)
    _close(to_numpy_tree(p_new), jp, tol)
    _close(to_numpy_tree(s_new.mu), js.mu, tol)
    _close(to_numpy_tree(s_new.nu), js.nu, tol)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


def _compare(a, b, exact, tol):
    for x, y in zip(tts.tree_leaves(a), tts.tree_leaves(b)):
        if exact:
            assert torch.equal(x, y)
        else:
            torch.testing.assert_close(x, y, **tol)


# -- the scanned search iteration ---------------------------------------------

@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    jnet = JNet(CLASSES, space=jss.tiny_space(RES))
    tnet = TNet(CLASSES, space=tss.tiny_space(RES))
    params = params_to_jax(tnet.init(torch.Generator().manual_seed(4))[0])
    nblk = len(jnet.sites)
    arch = {"log_alphas": (rng.standard_normal((nblk, 8)) * 0.5
                           ).astype(np.float32),
            "betas": {s: rng.standard_normal(d).astype(np.float32)
                      for s, d in jnet.ss.STAGE_DEPTHS.items()}}
    return dict(jnet=jnet, tnet=tnet, params=params, arch=arch, rng=rng,
                nblk=nblk)


def _jax_unit_draws(jarch_by_unit, key, k, arch_every):
    """The draws JAX's scanned iteration makes: weight step j of the run
    from fold_in(fold_in(key, 0), j) split into (gumbel, partner), arch
    step u from fold_in(fold_in(key, 1), u)."""
    wkey, akey = jax.random.fold_in(key, 0), jax.random.fold_in(key, 1)
    ig, ir, us = [], [], []
    for u in range(k):
        la = jarch_by_unit[u]["log_alphas"]
        for j in range(arch_every):
            kg, kr = jax.random.split(jax.random.fold_in(wkey,
                                                         u * arch_every + j))
            g = sample_gumbel_indices(kg, la)
            ig.append(np.asarray(g))
            ir.append(np.asarray(sample_random_excluding(kr, g, 8)))
        us.append(np.asarray(jax.random.uniform(
            jax.random.fold_in(akey, u), la.shape, jnp.float32,
            minval=1e-10, maxval=1.0)))
    n = la.shape[0]
    return (torch.from_numpy(np.stack(ig)).long().reshape(k, arch_every, n),
            torch.from_numpy(np.stack(ir)).long().reshape(k, arch_every, n),
            torch.from_numpy(np.stack(us)))


def test_scanned_search_iter_matches_jax(setup):
    """K = 2 units of (2 weight steps + 1 arch step): the port's
    make_scanned_search_iter, given the draws JAX makes inside its scan,
    lands where JAX's does (params, momentum, arch params, Adam state)."""
    s, K, AE = setup, 2, 2
    rng = np.random.default_rng(12)
    mc = s["jnet"].ss.build_mc_mask_dddict()
    xw = rng.standard_normal((K, AE, N, RES, RES, 3)).astype(np.float32)
    yw = rng.integers(0, CLASSES, (K, AE, N)).astype(np.int32)
    xa = rng.standard_normal((K, N, RES, RES, 3)).astype(np.float32)
    ya = rng.integers(0, CLASSES, (K, N)).astype(np.int32)
    lat = rng.uniform(0.0, 0.01, (s["nblk"], 8)).astype(np.float32)
    lr, T, base = 0.025, 5.0, 0.004
    key = jax.random.PRNGKey(7)

    jnet = s["jnet"]
    jp = jax.tree_util.tree_map(jnp.asarray, s["params"])
    ja = jax.tree_util.tree_map(jnp.asarray, s["arch"])
    jmasks, jum = jnet.device_masks(mc), jnet.update_masks(jp, mc)
    jargs = (jmasks, jum, jnp.asarray(xw), jnp.asarray(yw), jnp.asarray(xa),
             jnp.asarray(ya), jnp.float32(lr), jnp.float32(T),
             jnp.asarray(lat), jnp.float32(base), jnp.int32(0), key)
    run = jts.make_scanned_search_iter(jnet, arch_every=AE, **KW)

    def fresh():  # the run donates its state: give every call copies
        p = jax.tree_util.tree_map(jnp.array, jp)
        a = jax.tree_util.tree_map(jnp.array, ja)
        return p, jts.zeros_like_momentum(p), a, jts.adam_init(a)
    # the arch params each unit starts from: one unit, then two
    one = run(*fresh(), jmasks, jum, *(a[:1] for a in jargs[2:6]),
              *jargs[6:])
    want = run(*fresh(), *jargs)
    draws = _jax_unit_draws([ja, one[2]], key, K, AE)

    tnet = s["tnet"]
    tp = params_from_jax(s["params"])
    ta = arch_from_jax(s["arch"])
    trun = tts.make_scanned_search_iter(tnet, arch_every=AE, **KW)
    got = trun(tp, tts.zeros_like_tree(tp), ta, tts.adam_init(ta),
               tnet.device_masks(mc, "cpu"), tnet.update_masks(tp, mc),
               torch.from_numpy(xw), torch.from_numpy(yw).long(),
               torch.from_numpy(xa), torch.from_numpy(ya).long(),
               torch.tensor(lr), torch.tensor(T), torch.from_numpy(lat),
               torch.tensor(base), draws)
    _close(params_to_jax(got[0]), want[0])
    _close(params_to_jax(got[1]), want[1])
    _close(to_numpy_tree(got[2]), want[2])
    assert float(got[3].step) == int(want[3].step) == K
    _close(to_numpy_tree(got[3].mu), want[3].mu)
    _close(to_numpy_tree(got[3].nu), want[3].nu)
    for name in ("loss", "top1", "top5"):
        np.testing.assert_allclose(got[4][name].numpy(),
                                   np.asarray(want[4][name]), **TOL)
    for name in ("loss_a", "loss_l", "lat"):
        np.testing.assert_allclose(got[5][name].numpy(),
                                   np.asarray(want[5][name]), **TOL)
    assert torch.equal(got[4]["idx_g"], draws[0])


class UnitOrderSearch(tsearch.Search):
    """The driver's Search with one unit per call where --scan_units 1
    would take the per-step order."""

    def __init__(self, *args, scan_units, **kwargs):
        super().__init__(*args, scan_units=scan_units or 1, **kwargs)


def test_driver_scan_units_change_grouping_only(tmp_path, monkeypatch):
    """--scan_units 2 and the driver run one unit per call take the same
    steps in the same order with the same draws: every arch_params_NN.pkl
    is the same bytes (5 batches an epoch: whole groups and a tail at both
    K). At --scan_units 1 the driver takes the JAX driver's per-step order
    instead, which test_trajectory_across_epoch_boundaries holds against
    JAX."""
    runs = {}
    for k in (2, 1):
        if k == 1:
            monkeypatch.setattr(tsearch, "Search", UnitOrderSearch)
        runs[k] = tsearch.main([
            "--synthetic", "--space", "tiny", "--device", "cpu", "--epochs",
            "3", "--warmup_epochs", "1", "--steps_per_epoch", "5",
            "--image_size", "32", "--batch_size", "4", "--num_classes",
            "10", "--target_lat", "0.015", "--no_bf16", "--save_freq", "9",
            "--scan_units", str(k), "--save", str(tmp_path / f"k{k}")])
    names = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(runs[1], "arch_params_*.pkl")))
    assert names == [f"arch_params_0{e}.pkl" for e in range(4)]
    for name in names:
        a = open(os.path.join(runs[1], name), "rb").read()
        assert a == open(os.path.join(runs[2], name), "rb").read(), name
    assert "scan_units=2" in open(os.path.join(runs[2], "log.txt")).read()


# -- the trajectory across epoch boundaries -----------------------------------

class InjectedDraws:
    """Draws handed to the port's Search in the order it asks for them."""

    def __init__(self, weight, arch):
        self.weight = collections.deque(weight)  # (idx_g, idx_r or None)
        self.arch = collections.deque(arch)
        self._partner = None

    def gumbel(self, log_alphas):
        ig, self._partner = self.weight.popleft()
        return ig

    def partner(self, idx_g, num_ops):
        return self._partner

    def uniform(self, shape):
        return self.arch.popleft()

    def units(self, k):
        w = [self.weight.popleft() for _ in range(2 * k)]
        a = [self.arch.popleft() for _ in range(k)]
        return (torch.stack([g for g, _ in w]).reshape(k, 2, -1),
                torch.stack([r for _, r in w]).reshape(k, 2, -1),
                torch.stack(a))


def _arch_after(j, n, scan_units):
    """Whether the driver takes an arch step after weight step j of an
    epoch of n batches: after the second weight step of each unit in the
    full groups of 2K batches, and after every even step elsewhere (the JAX
    driver's per-step order and its scan's tail)."""
    full = n - n % (2 * scan_units) if scan_units else 0
    return j % 2 == (1 if j < full else 0)


def test_trajectory_across_epoch_boundaries(setup):
    """Three epochs of the port's driver loop (train_search.Search) against
    the JAX step functions in the JAX driver's per-step order: a warmup
    epoch, then two search epochs of 3 batches (weight, arch, weight,
    weight, arch), each closed by the T decay and shrink_or_expand +
    rewrite_masks_by_l1 on the trained weights, each opened by the momentum
    and Adam reset. Params and arch params agree to 1e-5 after every epoch;
    the rewritten masks agree exactly."""
    _trajectory(setup, None)


def test_trajectory_in_units_across_epoch_boundaries(setup):
    """The same with one scanned unit per call: a unit of 2 weight steps +
    1 arch step, then the tail step (weight, weight, arch, weight, arch)."""
    _trajectory(setup, 1)


def _trajectory(setup, scan_units):
    s = setup
    rng = np.random.default_rng(13)
    jspace, tspace = jss.tiny_space(RES), tss.tiny_space(RES)
    jlut, tlut = jax_space_lut(jspace), build_space_analytic_lut(tspace)
    target, T, decay, epochs, warmup, spe = 0.015, 5.0, 0.96, 3, 1, 3
    lr_list = tts.cosine_lr_list(0.025, epochs)
    batches = [[(rng.standard_normal((N, RES, RES, 3)).astype(np.float32),
                 rng.integers(0, CLASSES, N).astype(np.int32))
                for _ in range(spe)] for _ in range(epochs)]
    arch_batches = [(rng.standard_normal((N, RES, RES, 3)).astype(np.float32),
                     rng.integers(0, CLASSES, N).astype(np.int32))
                    for _ in range(2)]

    # JAX: the step functions in the driver's order, recording every draw
    jnet = s["jnet"]
    raw = jts.make_search_steps(jnet, **KW)
    jp = jax.tree_util.tree_map(jnp.asarray, s["params"])
    ja = jax.tree_util.tree_map(jnp.asarray, s["arch"])
    mc = jspace.build_mc_mask_dddict()
    key_dddict = jspace.build_lat_lookup_key_dddict()
    max_dddict = jpa.get_mc_num_dddict(mc, is_max=True)
    wdraws, adraws, want = [], [], []
    key = jax.random.PRNGKey(21)
    jT = T
    for epoch in range(epochs):
        masks, um = jnet.device_masks(mc), jnet.update_masks(jp, mc)
        lat = jnp.asarray(jlat_vectors(jlut, jpa.get_mc_num_dddict(mc),
                                       key_dddict, 8))
        mom, opt = jts.zeros_like_momentum(jp), jts.adam_init(ja)
        lr = jnp.float32(lr_list[epoch])
        arch_i = 0
        for j, (x, y) in enumerate(batches[epoch]):
            key, k = jax.random.split(key)
            la = ja["log_alphas"]
            if epoch < warmup:
                wdraws.append((sample_gumbel_indices(k, la), None))
                jp, mom, _ = raw.warmup_step(jp, ja, mom, masks, um, x, y, lr,
                                             k)
                continue
            kg, kr = jax.random.split(k)
            g = sample_gumbel_indices(kg, la)
            wdraws.append((g, sample_random_excluding(kr, g, 8)))
            jp, mom, _ = raw.weight_step(jp, ja, mom, masks, um, x, y, lr, k)
            if _arch_after(j, spe, scan_units):
                key, k = jax.random.split(key)
                adraws.append(jax.random.uniform(k, la.shape, jnp.float32,
                                                 minval=1e-10, maxval=1.0))
                xa, ya = arch_batches[arch_i % len(arch_batches)]
                arch_i += 1
                ja, opt, _ = raw.arch_step(jp, ja, opt, masks, xa, ya, lat,
                                           jnp.float32(jlut["base"]),
                                           jnp.float32(jT), k)
        if epoch >= warmup:
            jT *= decay
            parsed = jpa.parse_architecture(*jpa.get_op_and_depth_weights(
                {"arch_params": jax.tree_util.tree_map(np.asarray, ja)}),
                space=jspace)
            mc_num, _, _ = jel.shrink_or_expand(
                parsed, jpa.get_mc_num_dddict(mc), max_dddict, key_dddict,
                jlut, target)
            mc = jel.rewrite_masks_by_l1(parsed, mc_num, mc, jp)
        want.append((jax.tree_util.tree_map(np.asarray, jp),
                     jax.tree_util.tree_map(np.asarray, ja),
                     jax.tree_util.tree_map(np.asarray, mc)))

    # the port: train_search.Search fed the same draws
    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a)).long()
    draws = InjectedDraws([(t(g), t(r)) for g, r in wdraws],
                          [torch.from_numpy(np.asarray(u)) for u in adraws])
    tnet = s["tnet"]
    search = tsearch.Search(
        tnet, tspace, tlut, params_from_jax(s["params"]),
        arch_from_jax(s["arch"]), tspace.build_mc_mask_dddict(),
        torch.device("cpu"), step_kwargs=KW, scan_units=scan_units)
    tT = T
    for epoch in range(epochs):
        search.begin_epoch(lr_list[epoch], tT)
        search.train_epoch(
            [(torch.from_numpy(x), torch.from_numpy(y).long())
             for x, y in batches[epoch]],
            lambda: iter([(torch.from_numpy(x), torch.from_numpy(y).long())
                          for x, y in arch_batches]),
            draws, epoch < warmup, lambda x: x)
        if epoch >= warmup:
            tT *= decay
            search.end_epoch(target)
        wp, wa, wmc = want[epoch]
        _close(params_to_jax(search.params), wp)
        _close(to_numpy_tree(search.arch_params), wa)
        got_mc = jax.tree_util.tree_map(np.asarray, search.mc_mask_dddict)
        jax.tree_util.tree_map(np.testing.assert_array_equal, got_mc, wmc)
    assert not draws.weight and not draws.arch
    assert math.isclose(tT, jT)
    # the last epoch ran on masks the elasticity rewrote
    full = jspace.build_mc_mask_dddict()
    assert any(not np.array_equal(want[1][2][st][b][o], full[st][b][o])
               for st in full for b in full[st] for o in full[st][b])
