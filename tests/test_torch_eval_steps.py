"""The port's eval-network train and val steps, lr schedule and metrics
against the JAX package's, on the CPU, tiny space, f32. The JAX steps run
over a one-device mesh, where the cross-replica means are the identity;
their drop-connect and dropout draws come from the step's key and are
handed to the port's step.

Tolerances: one train step (params, BN state, momentum, metrics) 1e-5; the
padded val step 1e-4; the lr schedule and the metrics 1e-6. Top-5 on tied
logits can differ between jax.lax.top_k and torch.topk (they order ties
differently); random f32 logits have no ties, so the metrics here compare
the same sets."""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfnas_tpu.models import search_space as jss
from tfnas_tpu.models.eval_net import EvalNetwork as JNet
from tfnas_tpu.parallel import make_mesh
from tfnas_tpu.parallel.train_dp import (EvalTrainState as JState,
                                         cosine_lr_with_warmup as jcos,
                                         make_eval_steps as jmake)
from tfnas_tpu.search.parser import get_mc_num_dddict
from tfnas_tpu.utils import metrics as jmetrics
from tfnas_tpu_torch.convert import (eval_state_from_jax, params_from_jax,
                                     params_to_jax)
from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.models.eval_net import EvalNetwork as TNet
from tfnas_tpu_torch.parallel import train_dp as tdp
from tfnas_tpu_torch.utils import metrics as tmetrics
from test_torch_eval_net import jax_keep_draws

N, RES, CLASSES = 8, 32, 10


def _close(got, want, tol):
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                                rtol=tol, atol=tol),
        got, want)


@pytest.fixture(scope="module")
def setup():
    jsp, tsp = jss.tiny_space(RES), tss.tiny_space(RES)
    parsed = OrderedDict(
        (stage, OrderedDict((b, (i + 5) % 8)
                            for i, b in enumerate(jsp.block_names(stage))))
        for stage in jsp.STAGE_NAMES)
    mc = get_mc_num_dddict(jsp.build_mc_mask_dddict())
    jn = JNet.from_parsed_arch(CLASSES, parsed, mc, 0.3, 0.5, space=jsp)
    tn = TNet.from_parsed_arch(CLASSES, parsed, mc, 0.3, 0.5, space=tsp)
    params, state = jax.tree_util.tree_map(np.asarray, jn.init(
        jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    mom = jax.tree_util.tree_map(
        lambda p: (0.01 * rng.standard_normal(p.shape)).astype(np.float32),
        params)
    x = rng.standard_normal((N, RES, RES, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, N).astype(np.int32)
    return dict(jn=jn, tn=tn, params=params, state=state, mom=mom, x=x, y=y,
                mesh=make_mesh(1))


def test_train_step_matches_jax(setup):
    s = setup
    kw = dict(num_classes=CLASSES, label_smooth=0.1, momentum=0.9,
              weight_decay=1e-5, grad_clip=5.0)
    jtrain, _ = jmake(s["jn"], s["mesh"], compute_dtype=jnp.float32, **kw)
    ttrain, _ = tdp.make_eval_steps(s["tn"], compute_dtype=torch.float32,
                                    **kw)
    key, lr = jax.random.PRNGKey(13), 0.2
    jst = JState(*jax.tree_util.tree_map(
        jnp.asarray, (s["params"], s["state"], s["mom"])),
        jnp.zeros((), jnp.int32))
    jst, jm = jtrain(jst, jnp.asarray(s["x"]), jnp.asarray(s["y"]),
                     jnp.float32(lr), key)
    # the shard's key is fold_in(key, shard index 0)
    keep = jax_keep_draws(s["jn"], jax.random.fold_in(key, 0), N)
    assert any(k is not None and 0 < k.sum() < N for k in keep[:-1])
    tst = eval_state_from_jax({"params": s["params"],
                               "bn_state": s["state"],
                               "momentum": s["mom"], "epoch": 0})
    tst, tm = ttrain(tst, torch.from_numpy(s["x"]),
                     torch.from_numpy(s["y"]).long(), lr, keep)
    _close(params_to_jax(tst.params), jst.params, 1e-5)
    _close(params_to_jax(tst.bn_state), jst.bn_state, 1e-5)
    _close(params_to_jax(tst.momentum), jst.momentum, 1e-5)
    for k in ("loss", "top1", "top5"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("n_valid", [8, 5, 0])
def test_val_step_padded_matches_jax(setup, n_valid):
    s = setup
    _, jval = jmake(s["jn"], s["mesh"], num_classes=CLASSES,
                    compute_dtype=jnp.float32)
    _, tval = tdp.make_eval_steps(s["tn"], num_classes=CLASSES,
                                  compute_dtype=torch.float32)
    wmask = (np.arange(N) < n_valid).astype(np.float32)
    jst = JState(s["params"], s["state"], None, jnp.zeros((), jnp.int32))
    jm = jval(jst, jnp.asarray(s["x"]), jnp.asarray(s["y"]),
              jnp.asarray(wmask))
    tst = tdp.EvalTrainState(params_from_jax(s["params"]),
                             params_from_jax(s["state"]), None, 0)
    tm = tval(tst, torch.from_numpy(s["x"]), torch.from_numpy(s["y"]).long(),
              torch.from_numpy(wmask))
    for k in ("loss", "top1", "top5"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-4)
    if n_valid == 0:  # max(sum w, 1): an all-padding batch scores 0
        assert float(tm["loss"]) == 0.0
    # padding never counts: the valid rows alone give the same metrics
    if n_valid:
        part = tval(tst, torch.from_numpy(s["x"][:n_valid]),
                    torch.from_numpy(s["y"][:n_valid]).long())
        for k in ("loss", "top1", "top5"):
            np.testing.assert_allclose(float(tm[k]), float(part[k]),
                                       rtol=1e-5, atol=1e-5)
    # and without a mask every row counts
    full = tval(tst, torch.from_numpy(s["x"]),
                torch.from_numpy(s["y"]).long())
    jfull = jval(jst, jnp.asarray(s["x"]), jnp.asarray(s["y"]))
    np.testing.assert_allclose(float(full["loss"]), float(jfull["loss"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("batch", [256, 512])
def test_cosine_lr_matches_jax(batch):
    for epochs in (1, 7, 250):
        for epoch in range(epochs):
            np.testing.assert_allclose(
                tdp.cosine_lr_with_warmup(0.2, epochs, epoch, batch),
                jcos(0.2, epochs, epoch, batch), rtol=1e-12, atol=0)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((16, 10)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    w = (rng.random(16) < 0.6).astype(np.float32)
    jl, jy, jw = jnp.asarray(logits), jnp.asarray(y), jnp.asarray(w)
    tl, ty, tw = (torch.from_numpy(logits), torch.from_numpy(y).long(),
                  torch.from_numpy(w))
    for eps in (0.0, 0.1):
        np.testing.assert_allclose(
            float(tmetrics.cross_entropy_label_smooth(tl, ty, 10, eps)),
            float(jmetrics.cross_entropy_label_smooth(jl, jy, 10, eps)),
            rtol=1e-6, atol=1e-6)
    for weights in (None, w):
        got = tmetrics.accuracy(tl, ty, (1, 5), None if weights is None
                                else tw)
        want = jmetrics.accuracy(jl, jy, (1, 5), None if weights is None
                                 else jw)
        np.testing.assert_allclose([float(g) for g in got],
                                   [float(v) for v in want], rtol=1e-6)
    vals = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        float(tmetrics.masked_mean(torch.from_numpy(vals), tw)),
        float(jmetrics.masked_mean(jnp.asarray(vals), jw)), rtol=1e-6)


def test_init_eval_train_state(setup):
    st = tdp.init_eval_train_state(setup["tn"],
                                   torch.Generator().manual_seed(0))
    assert st.epoch == 0
    assert jax.tree_util.tree_map(np.shape, params_to_jax(st.params)) == \
        jax.tree_util.tree_map(np.shape, setup["params"])
    assert all(not m.any() for m in jax.tree_util.tree_leaves(
        params_to_jax(st.momentum)))
