"""The port's hybrid conv/ViT space (search side) against the JAX package
on the CPU: the ViT block and its pieces, the space's tables, the masked
samplers, the hybrid supernet's blocks and forwards, one weight step and
one arch step with the validity mask, the ViT mask rewrite of the
elasticity, and the conversion of the `vit` subtree.

The JAX hybrid path runs without Pallas (its default); the port's fused
depthwise kernel runs its plain version on the CPU. The JAX functions draw
from PRNG keys; the same draws are rebuilt here with jax.random and handed
to the port. Tolerances: f32 1e-5 (rtol and atol) for the modules, the
whole network and the updated state; bf16 2e-2 relative; tables, masks and
draws exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfnas_tpu.models import hybrid_space as jhs
from tfnas_tpu.models import search_space as jss
from tfnas_tpu.models.supernet_hybrid import HybridSuperNetwork as JNet
from tfnas_tpu.ops import attention as jatt
from tfnas_tpu.search import bisample as jbs
from tfnas_tpu.search import elasticity as jel
from tfnas_tpu.search.train_step import (adam_init as jadam_init,
                                         make_search_steps as jsteps,
                                         zeros_like_momentum)
from tfnas_tpu_torch.convert import (arch_from_jax, params_from_jax,
                                     params_to_jax)
from tfnas_tpu_torch.models import hybrid_space as ths
from tfnas_tpu_torch.models.supernet_hybrid import HybridSuperNetwork as TNet
from tfnas_tpu_torch.ops import attention as tatt
from tfnas_tpu_torch.search import bisample as tbs
from tfnas_tpu_torch.search import elasticity as tel
from tfnas_tpu_torch.search.train_step import (adam_init, make_search_steps,
                                               zeros_like_tree)
from tfnas_tpu_torch.utils.checkpoint import to_numpy_tree

TOL = dict(rtol=1e-5, atol=1e-5)
# 64^2, not 32^2: at 32^2 the stage-5/6 sites are 1x1, and BN over
# N * H * W = 2 values makes the full-width net ill-conditioned (the
# unchanged MBConv path already differs by 0.5 between the packages there)
N, RES, CLASSES = 2, 64, 10
KW = dict(num_classes=CLASSES, lambda_lat=0.5, target_lat=0.02,
          lat_under_boost=2.0)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got_jax_layout, want, tol=TOL):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                                **tol),
        got_jax_layout, want)


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().float().numpy()


@pytest.fixture(scope="module")
def setup():
    """One init for the module (the port's, converted: the JAX package's
    takes 40 s on the CPU), random arch params (ViT slots favoured, invalid
    slots at the sentinel) and masks with some live channels and MLP units
    switched off."""
    rng = np.random.default_rng(7)
    jnet, tnet = JNet(CLASSES), TNet(CLASSES)
    params = params_to_jax(tnet.init(torch.Generator().manual_seed(0))[0])
    valid = jhs.valid_op_mask()
    la = (rng.standard_normal(valid.shape) * 0.5).astype(np.float32)
    la[:, 8] += 1.5
    la = np.where(valid > 0, la, -30.0).astype(np.float32)
    arch = {"log_alphas": la,
            "betas": {s: rng.standard_normal(d).astype(np.float32)
                      for s, d in jss.STAGE_DEPTHS.items()}}
    mc = jhs.build_mc_mask_dddict()
    for stage in mc:
        for block in mc[stage]:
            for m in mc[stage][block].values():
                m[rng.choice(np.nonzero(m)[0], 3, replace=False)] = 0.0
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_jax(params)
    return dict(
        jnet=jnet, tnet=tnet, params=params, arch=arch, mc=mc, valid=valid,
        jparams=jparams, jarch=jax.tree_util.tree_map(jnp.asarray, arch),
        jmasks=jnet.device_masks(mc), jum=jnet.update_masks(jparams, mc),
        tmasks=tnet.device_masks(mc, "cpu"), tum=tnet.update_masks(tp, mc),
        x=rng.standard_normal((N, RES, RES, 3)).astype(np.float32),
        y=rng.integers(0, CLASSES, N).astype(np.int32),
        lat=(rng.uniform(0.0, 0.01, valid.shape) * valid).astype(np.float32))


# -- the ViT block ----------------------------------------------------------

@pytest.mark.parametrize("affine", [False, True])
def test_layer_norm_and_attention_match_jax(affine):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 49, 112)).astype(np.float32)
    p = {} if not affine else {
        "gamma": rng.standard_normal(112).astype(np.float32),
        "beta": rng.standard_normal(112).astype(np.float32)}
    want = jatt.layer_norm(jnp.asarray(x), p, affine=affine)
    got = tatt.layer_norm(torch.from_numpy(x), params_from_jax(p),
                          affine=affine)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    lin = {n: {"kernel": (rng.standard_normal((112, o)) * 0.1).astype(
        np.float32), "bias": rng.standard_normal(o).astype(np.float32)}
        for n, o in (("qkv", 336), ("out", 112))}
    want = jatt.multi_head_attention(jnp.asarray(x), lin["qkv"], lin["out"],
                                     4)
    got = tatt.multi_head_attention(torch.from_numpy(x),
                                    params_from_jax(lin["qkv"]),
                                    params_from_jax(lin["out"]), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (stage, block) sites: patch merge 80 -> 112, stride 2 with merge, none
VIT_CASES = [("stage4", 0), ("stage5", 0), ("stage4", 1)]


def _vit_case(stage, b, rate=0.0, affine=True):
    spec = jss.STAGE_SPECS[stage]
    entry = (spec["ics"][b], spec["ocs"][b], spec["ss"][b], spec["acts"][b])
    mc = entry[1] * 4
    jb = jhs.make_vit_op(entry, mc, affine=affine)
    tb = ths.make_vit_op(entry, mc, affine=affine)
    if rate:
        jb = jb.__class__(**{**jb.__dict__, "drop_connect_rate": rate})
        tb = tb.__class__(**{**tb.__dict__, "drop_connect_rate": rate})
    params, _ = jb.init(jax.random.PRNGKey(b))
    if affine:  # LN parameters away from their init
        rng = np.random.default_rng(b)
        params = _np(params)
        for ln in ("ln1", "ln2"):
            for k in params[ln]:
                params[ln][k] = params[ln][k] + rng.standard_normal(
                    params[ln][k].shape).astype(np.float32) * 0.1
    res = jss.BLOCK_INPUT_RES[stage][b]
    x = np.random.default_rng(10 + b).standard_normal(
        (4, res, res, entry[0])).astype(np.float32)
    mask = (np.arange(mc) < 3 * entry[1]).astype(np.float32)
    mask[::7] = 0.0
    return jb, tb, _np(params), x, mask


@pytest.mark.parametrize("case", range(len(VIT_CASES)))
def test_vit_block_matches_jax(case):
    """With and without patch merge, with a width mask: f32 1e-5, and
    bf16 within 2e-2 of the output's scale."""
    jb, tb, params, x, mask = _vit_case(*VIT_CASES[case])
    assert tb.config == jb.config and tb.has_patch_merge == jb.has_patch_merge
    want, _ = jb.apply(params, {}, jnp.asarray(x), training=True,
                       channel_mask=jnp.asarray(mask))
    got, st = tb.apply(params_from_jax(params), {}, _nchw(x), training=True,
                       channel_mask=torch.from_numpy(mask))
    assert st == {}
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    jp16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                  params)
    want16, _ = jb.apply(jp16, {}, jnp.asarray(x, jnp.bfloat16),
                         channel_mask=jnp.asarray(mask))
    got16, _ = tb.apply(params_from_jax(params), {},
                        _nchw(x).to(torch.bfloat16),
                        channel_mask=torch.from_numpy(mask))
    assert got16.dtype == torch.bfloat16
    w = np.asarray(want16, np.float32)
    assert np.abs(_nhwc(got16) - w).max() <= 2e-2 * np.abs(w).max()


def test_vit_block_drop_connect_takes_two_draws():
    """Independent draws per residual branch, injected from JAX's keys."""
    jb, tb, params, x, mask = _vit_case("stage5", 1, rate=0.5)
    key = jax.random.PRNGKey(4)
    want, _ = jb.apply(params, {}, jnp.asarray(x), training=True, rng=key,
                       channel_mask=jnp.asarray(mask))
    keep = []
    for k in jax.random.split(key):
        u = jax.random.uniform(k, (4, 1, 1), jnp.float32)
        keep.append(torch.from_numpy(np.array(jnp.floor(0.5 + u)).reshape(4)))
    assert not torch.equal(keep[0], keep[1])
    got, _ = tb.apply(params_from_jax(params), {}, _nchw(x), training=True,
                      keep=keep, channel_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    # without the draws, or in eval mode, nothing is dropped
    plain, _ = tb.apply(params_from_jax(params), {}, _nchw(x), training=True,
                        channel_mask=torch.from_numpy(mask))
    ev, _ = tb.apply(params_from_jax(params), {}, _nchw(x), keep=keep,
                     channel_mask=torch.from_numpy(mask))
    assert torch.equal(plain, ev) and not torch.allclose(plain, got)


# -- the space's tables -------------------------------------------------------

def test_hybrid_tables_match_jax():
    assert (ths.NUM_OPS, ths.VIT_OP_IDX, ths.VIT_STAGES) == \
        (jhs.NUM_OPS, jhs.VIT_OP_IDX, jhs.VIT_STAGES)
    assert ths.PRIMITIVES == jhs.PRIMITIVES
    np.testing.assert_array_equal(ths.valid_op_mask(), jhs.valid_op_mask())
    tm, jm = ths.build_mc_mask_dddict(), jhs.build_mc_mask_dddict()
    assert list(tm) == list(jm)
    for st in jm:
        assert list(tm[st]) == list(jm[st])
        for b in jm[st]:
            assert list(tm[st][b]) == list(jm[st][b])
            for o in jm[st][b]:
                np.testing.assert_array_equal(tm[st][b][o], jm[st][b][o])
    assert ths.build_lat_lookup_key_dddict() == \
        jhs.build_lat_lookup_key_dddict()
    tv, jv = ths.vit_sites(), jhs.vit_sites()
    assert list(tv.items()) == list(jv.items()) and len(tv) == 9
    keys = {k[8] for b in ths.build_lat_lookup_key_dddict().values()
            for k in b.values() if 8 in k}
    assert len(keys) == 5 == len(ths.vit_lut_sites())
    for st, b, entry in jv.values():
        kw = dict(affine=False, drop_connect_rate=0.1)
        assert ths.make_vit_op(entry, 64, **kw).config == \
            jhs.make_vit_op(entry, 64, **kw).config


# -- the masked samplers ------------------------------------------------------

def _old_sample_gumbel_indices(log_alphas, generator):
    probs = torch.softmax(log_alphas.float(), dim=-1)
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return (probs / q).argmax(dim=-1)


def _old_sample_random_excluding(excluded, num_ops, generator):
    r = torch.randint(0, num_ops - 1, excluded.shape, generator=generator,
                      device=excluded.device)
    return r + (r >= excluded).to(r.dtype)


def test_unmasked_draws_are_unchanged():
    """valid=None: the same draws from the same generator state as the
    draws the port made before the validity mask (the mbconv search's
    checkpoints stay byte for byte)."""
    la = torch.randn(18, 8, generator=torch.Generator().manual_seed(0))
    ga, gb = (torch.Generator().manual_seed(5) for _ in range(2))
    for _ in range(3):
        ig = tbs.sample_gumbel_indices(la, ga)
        assert torch.equal(ig, _old_sample_gumbel_indices(la, gb))
        ir = tbs.sample_random_excluding(ig, 8, ga)
        assert torch.equal(ir, _old_sample_random_excluding(ig, 8, gb))
        assert torch.equal(tbs.gumbel_uniform((18, 8), ga),
                           tbs.gumbel_uniform((18, 8), gb))
    assert torch.equal(ga.get_state(), gb.get_state())


def test_masked_draws_respect_validity_and_are_uniform():
    """Never an invalid slot; the partner is uniform over valid \\ {g}; the
    gumbel pick follows softmax over the valid slots."""
    reps = 4000
    valid = torch.from_numpy(np.tile(jhs.valid_op_mask(), (reps, 1)))
    la = torch.zeros(valid.shape)
    la[:, 3] = 1.0
    la = torch.where(valid > 0, la, -30.0)
    gen = torch.Generator().manual_seed(1)
    g = tbs.sample_gumbel_indices(la, gen, valid)
    r = tbs.sample_random_excluding(g, 9, gen, valid)
    picked = torch.nn.functional.one_hot(g, 9) + torch.nn.functional.one_hot(
        r, 9)
    assert (picked * (1 - valid.long())).sum() == 0
    assert (g != r).all()
    # the gumbel pick: p(3) = e / (e + n - 1) over the n valid slots
    for n, rows in ((8, slice(0, 9)), (9, slice(9, 18))):
        gg = g.reshape(reps, 18)[:, rows]
        p3 = np.e / (np.e + n - 1)
        frac = (gg == 3).float().mean().item()
        assert abs(frac - p3) < 5 * np.sqrt(p3 * (1 - p3) / gg.numel())
    # the partner, given the pick: uniform over the n - 1 others
    for n, rows in ((8, slice(0, 9)), (9, slice(9, 18))):
        gg = g.reshape(reps, 18)[:, rows]
        rr = r.reshape(reps, 18)[:, rows]
        sel = rr[gg == 3]
        counts = torch.bincount(sel, minlength=9)[:n].float()
        assert counts[3] == 0
        p = 1.0 / (n - 1)
        sd = np.sqrt(p * (1 - p) * sel.numel())
        others = torch.cat([counts[:3], counts[4:]])
        assert (others - p * sel.numel()).abs().max() < 5 * sd


def test_masked_soft_weights_and_projection_match_jax(setup):
    s = setup
    key = jax.random.PRNGKey(9)
    valid = jnp.asarray(s["valid"])
    want = jbs.gumbel_softmax_weights(key, s["jarch"]["log_alphas"], 5.0,
                                      valid)
    u = jax.random.uniform(key, s["valid"].shape, jnp.float32,
                           minval=1e-10, maxval=1.0)
    got = tbs.gumbel_softmax_weights(torch.from_numpy(s["arch"]["log_alphas"]),
                                     5.0, torch.from_numpy(np.array(u)),
                                     torch.from_numpy(s["valid"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.numpy()[s["valid"] == 0] == 0).all()
    np.testing.assert_allclose(
        tbs.project_log_softmax(torch.from_numpy(s["arch"]["log_alphas"]),
                                torch.from_numpy(s["valid"])).numpy(),
        np.asarray(jbs.project_log_softmax(s["jarch"]["log_alphas"], valid)),
        **TOL)


def test_gumbel_excluding_min_max_samplers():
    rng = np.random.default_rng(3)
    la = rng.standard_normal((18, 8)).astype(np.float32)
    t = torch.from_numpy(la)
    assert torch.equal(tbs.sample_min_alphas(t), torch.from_numpy(
        np.asarray(jbs.sample_min_alphas(la))).long())
    assert torch.equal(tbs.sample_max_alphas(t), torch.from_numpy(
        np.asarray(jbs.sample_max_alphas(la))).long())
    reps = 3000
    big = torch.zeros(reps, 8)
    big[:, 5] = 1.0
    ex = torch.full((reps,), 2)
    d = tbs.sample_gumbel_excluding(big, ex, torch.Generator().manual_seed(0))
    assert (d != 2).all()
    p5 = np.e / (np.e + 6)
    frac = (d == 5).float().mean().item()
    assert abs(frac - p5) < 5 * np.sqrt(p5 * (1 - p5) / reps)


# -- the hybrid blocks --------------------------------------------------------

def _site(net, g):
    return next(s for s in net.sites if s.global_idx == g)


def test_soft_block_at_a_residual_vit_site_matches_jax(setup):
    s = setup
    site = _site(s["tnet"], 10)  # stage4/block2
    assert site.has_residual
    w = np.asarray(jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(3),
                                                    (9,))))
    x = np.random.default_rng(4).standard_normal(
        (2, 7, 7, site.ic)).astype(np.float32)
    want = s["jnet"]._soft_block_fn(_site(s["jnet"], 10), True)(
        s["jparams"][site.stage][site.block], s["jmasks"], jnp.asarray(w),
        jnp.asarray(x))
    tp = params_from_jax(s["params"][site.stage][site.block])
    got = s["tnet"]._soft_block_fn(site, True)(tp, s["tmasks"],
                                               torch.from_numpy(w), _nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)


def test_sampled_block_selects_vit_for_op8_and_conv_otherwise(setup):
    s = setup
    site = _site(s["tnet"], 17)  # stage6
    tp = params_from_jax(s["params"][site.stage][site.block])
    x = np.random.default_rng(1).standard_normal(
        (2, 7, 7, site.ic)).astype(np.float32)
    fn = s["tnet"]._sampled_block_fn(site, True)
    jfn = s["jnet"]._sampled_block_fn(_site(s["jnet"], 17), True)
    vit_mask = s["tmasks"]["vit"][site.stage][site.block]
    ref, _ = s["tnet"].vit_blocks[17].apply(tp["vit"], {}, _nchw(x),
                                            training=True,
                                            channel_mask=vit_mask)
    y8 = fn(tp, s["tmasks"], torch.tensor(8), _nchw(x))
    assert torch.equal(y8, ref)
    for op in (8, 1, 6):
        got = fn(tp, s["tmasks"], torch.tensor(op), _nchw(x))
        want = jfn(s["jparams"][site.stage][site.block], s["jmasks"],
                   jnp.int32(op), jnp.asarray(x))
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    conv = s["tnet"]._block_sampled(site, tp, s["tmasks"]["mb"][site.stage][
        site.block], torch.tensor(1), _nchw(x), True)
    assert torch.equal(fn(tp, s["tmasks"], torch.tensor(1), _nchw(x)), conv)
    assert not torch.allclose(conv, y8)


# -- the whole network and the steps ------------------------------------------

def _draws(s, key):
    """The weight step's draws JAX makes from `key` with the mask."""
    la, valid = s["jarch"]["log_alphas"], jnp.asarray(s["valid"])
    kg, kr = jax.random.split(key)
    g = jbs.sample_gumbel_indices(kg, la, valid)
    r = jbs.sample_random_excluding(kr, g, 9, valid)
    return [torch.from_numpy(np.asarray(d)).long() for d in (g, r)]


def test_apply_soft_and_sampled_pair_match_jax(setup):
    s = setup
    ig, ir = _draws(s, jax.random.PRNGKey(3))
    assert (ig == 8).any() and (ir == 8).any() and (ig[:9] != 8).all()
    tp, ta = params_from_jax(s["params"]), arch_from_jax(s["arch"])
    # jitted: the JAX package's forwards take a minute op by op
    want = jax.jit(s["jnet"].apply_sampled_pair)(
        s["jparams"], s["jarch"], s["jmasks"], jnp.asarray(s["x"]),
        jnp.asarray(ig.numpy()), jnp.asarray(ir.numpy()))
    got = s["tnet"].apply_sampled_pair(tp, ta, s["tmasks"],
                                       torch.from_numpy(s["x"]), ig, ir)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    w9 = np.asarray(jbs.gumbel_softmax_weights(
        jax.random.PRNGKey(5), s["jarch"]["log_alphas"], 5.0,
        jnp.asarray(s["valid"])))
    wl, wlat = jax.jit(s["jnet"].apply_soft)(s["jparams"], s["jarch"], s["jmasks"],
                                    jnp.asarray(s["x"]), jnp.asarray(w9),
                                    jnp.asarray(s["lat"]))
    gl, glat = s["tnet"].apply_soft(tp, ta, s["tmasks"],
                                    torch.from_numpy(s["x"]),
                                    torch.from_numpy(w9),
                                    torch.from_numpy(s["lat"]))
    np.testing.assert_allclose(gl.detach().numpy(), np.asarray(wl), **TOL)
    np.testing.assert_allclose(float(glat), float(wlat), **TOL)
    with pytest.raises(NotImplementedError, match="apply_sampled_pair"):
        s["tnet"].apply_multi_sampled()


def test_weight_step_with_vit_picks_matches_jax(setup):
    s = setup
    key = jax.random.PRNGKey(3)
    js = jsteps(s["jnet"], valid_mask=jnp.asarray(s["valid"]), **KW)
    ts = make_search_steps(s["tnet"], valid_mask=torch.from_numpy(s["valid"]),
                           **KW)
    lr = 0.025
    # the jitted JAX step donates params and momentum: fresh copies
    jparams = jax.tree_util.tree_map(jnp.asarray, s["params"])
    jp, jm, jmet = js.weight_step(
        jparams, s["jarch"], zeros_like_momentum(jparams),
        s["jmasks"], s["jum"], jnp.asarray(s["x"]), jnp.asarray(s["y"]),
        jnp.float32(lr), key)
    ig, ir = _draws(s, key)
    assert (ig == 8).any()
    tp = params_from_jax(s["params"])
    np_, nm, tmet = ts.weight_step(
        tp, arch_from_jax(s["arch"]), zeros_like_tree(tp), s["tmasks"],
        s["tum"], torch.from_numpy(s["x"]), torch.from_numpy(s["y"]).long(),
        lr, ig, ir)
    _close(params_to_jax(np_), _np(jp))
    _close(params_to_jax(nm), _np(jm))
    for k in ("loss", "top1", "top5"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)
    # masked MLP hidden units of the ViT candidate stay exactly frozen,
    # and a picked ViT block did move
    moved = False
    for stage, block, _ in ths.vit_sites().values():
        m = s["mc"][stage][block][8] == 0
        old, new = tp[stage][block]["vit"], np_[stage][block]["vit"]
        assert m.any()
        assert torch.equal(old["mlp_in"]["kernel"][:, m],
                           new["mlp_in"]["kernel"][:, m])
        assert torch.equal(old["mlp_in"]["bias"][m], new["mlp_in"]["bias"][m])
        assert torch.equal(old["mlp_out"]["kernel"][m],
                           new["mlp_out"]["kernel"][m])
        moved |= not torch.equal(old["qkv"]["kernel"], new["qkv"]["kernel"])
    assert moved


def test_arch_step_with_valid_mask_matches_jax(setup):
    s = setup
    key = jax.random.PRNGKey(6)
    js = jsteps(s["jnet"], valid_mask=jnp.asarray(s["valid"]), **KW)
    ts = make_search_steps(s["tnet"], valid_mask=torch.from_numpy(s["valid"]),
                           **KW)
    T, base = 5.0, 0.004
    ja, jopt, jmet = js.arch_step(
        s["jparams"], s["jarch"], jadam_init(s["jarch"]), s["jmasks"],
        jnp.asarray(s["x"]), jnp.asarray(s["y"]), jnp.asarray(s["lat"]),
        jnp.float32(base), jnp.float32(T), key)
    u = jax.random.uniform(key, s["valid"].shape, jnp.float32, minval=1e-10,
                           maxval=1.0)
    ta0 = arch_from_jax(s["arch"])
    ta, topt, tmet = ts.arch_step(
        params_from_jax(s["params"]), ta0, adam_init(ta0), s["tmasks"],
        torch.from_numpy(s["x"]), torch.from_numpy(s["y"]).long(),
        torch.from_numpy(s["lat"]), base, T, torch.from_numpy(np.array(u)))
    _close(to_numpy_tree(ta), _np(ja))
    assert (to_numpy_tree(ta)["log_alphas"][s["valid"] == 0] == -30.0).all()
    _close(to_numpy_tree(topt.mu), _np(jopt.mu))
    _close(to_numpy_tree(topt.nu), _np(jopt.nu))
    for k in ("loss_a", "loss_l", "lat"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **TOL)


# -- masks, elasticity, conversion ---------------------------------------------

def test_device_and_update_masks_match_jax(setup):
    s = setup
    for stage, block, _ in ths.vit_sites().values():
        np.testing.assert_array_equal(
            s["tmasks"]["vit"][stage][block].numpy(),
            np.asarray(s["jmasks"]["vit"][stage][block]))
        tu, ju = s["tum"][stage][block]["vit"], s["jum"][stage][block]["vit"]
        for name, leaf in (("mlp_in", "kernel"), ("mlp_in", "bias"),
                           ("mlp_out", "kernel")):
            np.testing.assert_array_equal(tu[name][leaf].numpy(),
                                          np.asarray(ju[name][leaf]))
        assert tu["qkv"] == {"kernel": None, "bias": None}
        assert tu["mlp_out"]["bias"] is None and tu["ln1"] == {}
    np.testing.assert_array_equal(
        s["tmasks"]["mb"]["stage2"]["block1"].numpy(),
        np.asarray(s["jmasks"]["mb"]["stage2"]["block1"]))


def test_rewrite_masks_by_l1_vit_branch_matches_jax(setup):
    s = setup
    parsed = {st: {b: (8 if st in jhs.VIT_STAGES and b != "block2" else 1)
                   for b in s["mc"][st]} for st in s["mc"]}
    mc_num = {st: {b: {o: int(m.sum()) for o, m in d.items()}
                   for b, d in bd.items()} for st, bd in s["mc"].items()}
    for st, bd in mc_num.items():
        for b in bd:
            bd[b][parsed[st][b]] += 5
    copy = lambda: {st: {b: {o: m.copy() for o, m in d.items()}  # noqa: E731
                         for b, d in bd.items()}
                    for st, bd in s["mc"].items()}
    want = jel.rewrite_masks_by_l1(parsed, mc_num, copy(), s["params"])
    got = tel.rewrite_masks_by_l1(parsed, mc_num, copy(),
                                  params_from_jax(s["params"]))
    changed = 0
    for st in want:
        for b in want[st]:
            for o in want[st][b]:
                np.testing.assert_array_equal(got[st][b][o], want[st][b][o])
            changed += int(not np.array_equal(want[st][b][8], s["mc"][st][b][
                8])) if 8 in want[st][b] else 0
    assert changed == 7


def test_convert_roundtrips_the_vit_subtree(setup):
    s = setup
    for stage, block, _ in ths.vit_sites().values():
        jv = s["params"][stage][block]["vit"]
        tv = params_from_jax(jv)
        back = params_to_jax(tv)
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(jv)
        jax.tree_util.tree_map(np.testing.assert_array_equal, back, jv)
        # dense kernels keep the [in, out] layout in both packages
        assert tuple(tv["mlp_in"]["kernel"].shape) == \
            jv["mlp_in"]["kernel"].shape
    tp = s["tnet"].init(torch.Generator().manual_seed(0))[0]
    assert jax.tree_util.tree_map(np.shape, params_to_jax(tp)) == \
        jax.tree_util.tree_map(np.shape, s["params"])
