"""The port's parser, elasticity, samplers, checkpoint format and converter
against the JAX package's, on the CPU."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfnas_tpu.cost.lut import load_lat_lookup as jload_lut
from tfnas_tpu.models import search_space as jss
from tfnas_tpu.search import bisample as jbs
from tfnas_tpu.search import elasticity as jel
from tfnas_tpu.search import parser as jpa
from tfnas_tpu.utils.checkpoint import to_numpy_tree as jto_numpy
from tfnas_tpu_torch.convert import (arch_from_jax, params_from_jax,
                                     params_to_jax)
from tfnas_tpu_torch.cost.lut import load_lat_lookup as tload_lut
from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.models.supernet import SuperNetwork as TNet
from tfnas_tpu_torch.search import bisample as tbs
from tfnas_tpu_torch.search import elasticity as tel
from tfnas_tpu_torch.search import parser as tpa
from tfnas_tpu_torch.utils.checkpoint import to_numpy_tree

FIXTURE = ("checkpoints_e2e/proxy60-ref-recipe-boost/search-20260820-202242-"
           "proxy60-ref-recipe-boost/arch_params_90.pkl")
# the run that wrote FIXTURE searched with this table and target
LUT, TARGET = "latency_pkl/latency_tpu_v5e_bs32.pkl", 0.25


def _assert_tree_equal(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("target", [TARGET, 0.35])
def test_parser_and_elasticity_on_committed_fixture(target):
    """parse_architecture, shrink_or_expand and rewrite_masks_by_l1 on the
    committed 90-epoch arch params equal JAX's: at the run's own target
    (shrink, its widths already pinned at the lower bound) and at a higher
    one (expand, every parsed width changes)."""
    ow_t, dw_t = tpa.get_op_and_depth_weights(FIXTURE)
    ow_j, dw_j = jpa.get_op_and_depth_weights(FIXTURE)
    _assert_tree_equal(ow_t, ow_j)
    _assert_tree_equal(dw_t, dw_j)
    arch_t, arch_j = (tpa.parse_architecture(ow_t, dw_t),
                      jpa.parse_architecture(ow_j, dw_j))
    assert arch_t == arch_j

    ckpt = pickle.load(open(FIXTURE, "rb"))
    masks = ckpt["mc_mask_dddict"]
    lut_t, lut_j = tload_lut(LUT), jload_lut(LUT)
    mcmax = tpa.get_mc_num_dddict(masks, is_max=True)
    assert mcmax == jpa.get_mc_num_dddict(masks, is_max=True)
    got = tel.shrink_or_expand(arch_t, tpa.get_mc_num_dddict(masks), mcmax,
                               tss.lat_lookup_key_dddict, lut_t, target)
    want = jel.shrink_or_expand(arch_j, jpa.get_mc_num_dddict(masks), mcmax,
                                jss.lat_lookup_key_dddict, lut_j, target)
    assert got == want
    mc_num = got[0]

    # depthwise kernels to rank channels by (only their L1 norms matter)
    tnet = TNet(60)
    gen = torch.Generator().manual_seed(0)
    tparams = {site.stage: {} for site in tnet.sites}
    for site in tnet.sites:
        tparams[site.stage][site.block] = {"depth": {"kernel": torch.randn(
            (8, site.width, 1, 5, 5), generator=gen)}}
    jparams = params_to_jax(tparams)
    copy_masks = pickle.loads(pickle.dumps(masks))
    got = tel.rewrite_masks_by_l1(arch_t, mc_num, copy_masks, tparams)
    before = pickle.loads(pickle.dumps(masks))
    want = jel.rewrite_masks_by_l1(arch_j, mc_num, masks, jparams)
    _assert_tree_equal(got, want)
    for s in arch_t:
        for b, o in arch_t[s].items():
            assert got[s][b][o].sum() == mc_num[s][b][o]
            changed = not np.array_equal(got[s][b][o], before[s][b][o])
            assert changed == (target != TARGET)


def test_arch_params_pickle_is_jax_format(tmp_path):
    """The port's arch-params tree pickles to the bytes JAX's
    to_numpy_tree gives, and loads in the JAX parser."""
    rng = np.random.default_rng(0)
    arch = {"log_alphas": rng.standard_normal((18, 8)).astype(np.float32),
            "betas": {s: rng.standard_normal(d).astype(np.float32)
                      for s, d in jss.STAGE_DEPTHS.items()}}
    masks = {s: {b: {o: np.asarray(m) for o, m in d.items()}
                 for b, d in sd.items()}
             for s, sd in jss.build_mc_mask_dddict().items()}

    def blob(arch_np):
        return pickle.dumps({"arch_params": arch_np, "mc_mask_dddict": masks,
                             "epoch": 3, "T": 4.8})
    got = blob(to_numpy_tree(arch_from_jax(arch)))
    assert got == blob(jto_numpy(jax.tree_util.tree_map(jnp.asarray, arch)))
    path = tmp_path / "arch_params_03.pkl"
    path.write_bytes(got)
    ow, dw = jpa.get_op_and_depth_weights(str(path))
    assert jpa.parse_architecture(ow, dw) == tpa.parse_architecture(
        *tpa.get_op_and_depth_weights(str(path)))


def test_convert_round_trips():
    tnet = TNet(10, space=tss.tiny_space(32))
    tp, ta = tnet.init(torch.Generator().manual_seed(0))
    jp = params_to_jax(tp)
    back = params_from_jax(jp)
    jax.tree_util.tree_map(lambda a, b: torch.testing.assert_close(
        a, b, rtol=0, atol=0), back, tp)
    _assert_tree_equal(params_to_jax(back), jp)
    ja = to_numpy_tree(ta)
    jax.tree_util.tree_map(lambda a, b: torch.testing.assert_close(
        a, b, rtol=0, atol=0), arch_from_jax(ja), ta)
    # a conv kernel: OIHW here, HWIO there
    k = tp["first_stem"]["conv"]["kernel"]
    assert k.shape == (16, 3, 3, 3)
    np.testing.assert_array_equal(jp["first_stem"]["conv"]["kernel"],
                                  k.permute(2, 3, 1, 0).numpy())
    d = tp["stage1"]["block1"]["depth"]["kernel"]
    np.testing.assert_array_equal(jp["stage1"]["block1"]["depth"]["kernel"],
                                  d.permute(0, 3, 4, 2, 1).numpy())


def test_categorical_draw_distribution():
    logits = torch.tensor([0.0, 1.0, -1.0, 2.0, 0.5, -0.5, 0.0, 1.5])
    g = torch.Generator().manual_seed(0)
    draws = tbs.sample_gumbel_indices(logits.expand(40000, 8), g)
    freq = torch.bincount(draws, minlength=8).float() / draws.numel()
    p = torch.softmax(logits, 0)
    assert torch.all((freq - p).abs() < 4 * torch.sqrt(p * (1 - p) / 40000))
    # the JAX sampler draws from the same distribution
    jd = jbs.sample_gumbel_indices(jax.random.PRNGKey(0),
                                   jnp.broadcast_to(jnp.asarray(
                                       logits.numpy()), (40000, 8)))
    jfreq = np.bincount(np.asarray(jd), minlength=8) / 40000
    assert np.all(np.abs(jfreq - freq.numpy()) < 0.02)


def test_random_excluding_distribution():
    g = torch.Generator().manual_seed(1)
    excl = torch.randint(0, 8, (56000,), generator=g)
    r = tbs.sample_random_excluding(excl, 8, g)
    assert not torch.any(r == excl)
    assert r.min() >= 0 and r.max() <= 7
    for e in range(8):
        sel = r[excl == e]
        freq = torch.bincount(sel, minlength=8).float() / sel.numel()
        assert freq[e] == 0
        others = torch.cat([freq[:e], freq[e + 1:]])
        assert torch.all((others - 1 / 7).abs() < 0.02)


def test_gumbel_weights_match_jax_and_distribute():
    rng = np.random.default_rng(0)
    la = rng.standard_normal((6, 8)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    u = jax.random.uniform(key, la.shape, jnp.float32, minval=1e-10,
                           maxval=1.0)
    want = jbs.gumbel_softmax_weights(key, jnp.asarray(la), 2.0)
    got = tbs.gumbel_softmax_weights(torch.from_numpy(la), 2.0,
                                     torch.from_numpy(np.asarray(u)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    # argmax of the soft weights is a categorical draw of softmax(la)
    g = torch.Generator().manual_seed(2)
    big = torch.from_numpy(la[:1]).expand(40000, 8)
    w = tbs.gumbel_softmax_weights(big, 5.0, tbs.gumbel_uniform(big.shape, g))
    freq = torch.bincount(w.argmax(-1), minlength=8).float() / 40000
    assert torch.all((freq - torch.softmax(big[0], 0)).abs() < 0.02)
    assert torch.allclose(w.sum(-1), torch.ones(40000))


def test_project_log_softmax_matches_jax():
    rng = np.random.default_rng(1)
    la = rng.standard_normal((4, 9)).astype(np.float32)
    valid = (rng.uniform(size=(4, 9)) > 0.3).astype(np.float32)
    valid[:, 0] = 1
    for v in (None, valid):
        want = jbs.project_log_softmax(jnp.asarray(la),
                                       None if v is None else jnp.asarray(v))
        got = tbs.project_log_softmax(torch.from_numpy(la),
                                      None if v is None
                                      else torch.from_numpy(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
