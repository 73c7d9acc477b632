"""The supernet's opt-in lowerings and the profiling tools of the port
(tfnas_tpu_torch) against the JAX package, on the CPU.

- float64 through the depthwise middle: the port's plain version keeps
  float64 (statistics and the fused op's sums), as JAX's _dw_middle does:
  1e-12;
- the soft block's four lowerings (einsum or grouped project, with and
  without the true-tap k3/k5 depthwise split) against JAX's _block_soft
  with the same flags, output and input gradient in f32: 1e-5 x max|.|;
- cond_width_split's sampled block against JAX's and against the flag off
  (1e-5), and the refusal to capture it;
- apply_multi_sampled in float64 against two apply_sampled calls and
  against JAX's (1e-7, as tests/test_supernet.py holds JAX's own);
- remat_blocks: the steps with and without it bit for bit, against JAX's
  remat steps (1e-5), and the hybrid blocks with and without it;
- train_search --profile_steps and TFNAS_STEP_TIMING, and the three tools
  (tools_profile, tools_ab_ksplit, tools_profile_eval) on the tiny space.
"""

import functools
import importlib.util
import json
import logging
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfnas_tpu.cost.flops import calculate_FLOPs_in_M as jflops
from tfnas_tpu.models import search_space as jss
from tfnas_tpu.models.eval_net import EvalNetwork as JEval
from tfnas_tpu.models.supernet import BlockSite as JSite
from tfnas_tpu.models.supernet import SuperNetwork as JNet
from tfnas_tpu.search.bisample import (sample_gumbel_indices,
                                       sample_random_excluding)
from tfnas_tpu.search.train_step import (adam_init as jadam_init,
                                         make_search_steps as jsteps,
                                         zeros_like_momentum)
from tfnas_tpu_torch import tools_ab_ksplit, tools_profile, train_search
from tfnas_tpu_torch import tools_profile_eval as ttpe
from tfnas_tpu_torch.convert import (arch_from_jax, params_from_jax,
                                     params_to_jax)
from tfnas_tpu_torch.cost.flops import calculate_FLOPs_in_M
from tfnas_tpu_torch.models import hybrid_space as ths
from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.models.eval_net import EvalNetwork
from tfnas_tpu_torch.models.folding import fold_batchnorm
from tfnas_tpu_torch.models.supernet import BlockSite, SuperNetwork as TNet
from tfnas_tpu_torch.models.supernet_hybrid import HybridSuperNetwork
from tfnas_tpu_torch.parallel.mesh import make_mesh
from tfnas_tpu_torch.parallel.pareto import make_pareto_search_steps
from tfnas_tpu_torch.search.train_step import (adam_init, make_search_steps,
                                               tree_leaves, tree_map,
                                               tree_unflatten,
                                               zeros_like_tree)
from tfnas_tpu_torch.utils import trace
from tfnas_tpu_torch.utils.checkpoint import to_numpy_tree

REPO = pathlib.Path(__file__).resolve().parent.parent
N, RES, CLASSES = 2, 32, 10
KW = dict(num_classes=CLASSES, lambda_lat=0.5, target_lat=0.02)
# a stride-1 site with a residual and the stride-2 site of
# tests/test_supernet.py's ksplit test
SITES = {"s1": ("stage3", "block2", 4, 40, 40, 1, "swish"),
         "s2": ("stage2", "block1", 2, 24, 40, 2, "swish")}
LOWERINGS = tools_ab_ksplit.VARIANTS  # einsum, grouped, ksplit+...


def _f64(tree):
    return tree_map(lambda t: t.double() if t.is_floating_point() else t,
                    tree)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _assert_rel(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _site_setup(name, seed=0, res=8):
    """A block site in both packages, its params (the port's init in both
    layouts), masks with a few live channels switched off, and an input."""
    spec = SITES[name]
    site, jsite = BlockSite(*spec), JSite(*spec)
    rng = np.random.default_rng(seed)
    tp = TNet(CLASSES)._init_block(site, torch.Generator().manual_seed(seed))
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_jax(tp))
    mask = np.zeros((8, site.width), np.float32)
    for o in range(8):
        live = site.ic * jss.OP_EXPAND[o]
        mask[o, :live] = 1.0
        mask[o, rng.choice(live, 3, replace=False)] = 0.0
    x = rng.standard_normal((N, res, res, site.ic)).astype(np.float32)
    return site, jsite, tp, jp, mask, x, rng


# -- float64 through the depthwise middle ---------------------------------

@pytest.mark.parametrize("stride", [1, 2])
def test_dw_middle_float64_matches_jax(stride):
    """Was 4.7e-7 / 3.9e-7 apart when the plain version rounded to f32."""
    rng = np.random.default_rng(stride)
    c = 12
    h = rng.standard_normal((N, 9, 9, c))
    dk = rng.standard_normal((5, 5, c)) * 0.2
    mask = np.ones(c)
    mask[rng.choice(c, 3, replace=False)] = 0.0
    with jax.enable_x64():
        want = JNet(CLASSES)._dw_middle(jnp.asarray(h), jnp.asarray(dk),
                                        jnp.asarray(mask), "swish", stride)
        want = np.asarray(want)
    got = TNet(CLASSES)._dw_middle(
        torch.from_numpy(h).permute(0, 3, 1, 2),
        torch.from_numpy(dk).permute(2, 0, 1)[:, None],
        torch.from_numpy(mask), "swish", stride)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-12)


# -- the soft block's lowerings ----------------------------------------------

@pytest.mark.parametrize("site_name", sorted(SITES))
@pytest.mark.parametrize("lowering", list(LOWERINGS))
def test_block_soft_lowerings_match_jax(lowering, site_name):
    site, jsite, tp, jp, mask, x, rng = _site_setup(site_name)
    w = rng.dirichlet(np.ones(8)).astype(np.float32)
    jnet = JNet(CLASSES, **LOWERINGS[lowering])
    tnet = TNet(CLASSES, **LOWERINGS[lowering])
    fn = jax.jit(lambda xx: jnet._block_soft(
        jsite, jp, jnp.asarray(mask), jnp.asarray(w), xx, training=True))
    want, vjp = jax.vjp(fn, jnp.asarray(x))
    ct = rng.standard_normal(want.shape).astype(np.float32)
    (want_gx,) = vjp(jnp.asarray(ct))

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = tnet._block_soft(site, tp, torch.from_numpy(mask),
                           torch.from_numpy(w), xt, training=True)
    (got.permute(0, 2, 3, 1) * torch.from_numpy(ct)).sum().backward()
    _assert_rel(_nhwc(got), want, 1e-5)
    _assert_rel(_nhwc(xt.grad), want_gx, 1e-5)


def test_ksplit_soft_blocks_launch_no_fused_kernel(monkeypatch):
    """dw_kernel_split's depthwise is plain convolutions, as in JAX."""
    from tfnas_tpu_torch.models import supernet as tsupernet
    site, _, tp, _, mask, x, rng = _site_setup("s2")
    calls = []
    orig = tsupernet.fused_dw_norm_act
    monkeypatch.setattr(tsupernet, "fused_dw_norm_act",
                        lambda *a: calls.append(1) or orig(*a))
    w = torch.from_numpy(rng.dirichlet(np.ones(8)).astype(np.float32))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for split in (False, True):
        TNet(CLASSES, dw_kernel_split=split)._block_soft(
            site, tp, torch.from_numpy(mask), w, xt, training=True)
    assert len(calls) == 1


# -- cond_width_split --------------------------------------------------------

@pytest.mark.parametrize("op", [2, 5])   # an e3 and an e6 candidate
def test_cond_width_split_matches_jax_and_flag_off(op):
    site, jsite, tp, jp, mask, x, rng = _site_setup("s2", seed=op)
    jnet = JNet(CLASSES, cond_width_split=True)
    want = jax.jit(lambda i: jnet._block_sampled(
        jsite, jp, jnp.asarray(mask), i, jnp.asarray(x), training=True))(
        jnp.int32(op))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    outs = [TNet(CLASSES, cond_width_split=split)._block_sampled(
        site, tp, torch.from_numpy(mask), torch.tensor(op), xt,
        training=True) for split in (True, False)]
    for got in outs:
        _assert_rel(_nhwc(got), want, 1e-5)
    _assert_rel(_nhwc(outs[0]), _nhwc(outs[1]), 1e-5)


def test_capture_refuses_cond_width_split():
    net = TNet(CLASSES, space=tss.tiny_space(RES), cond_width_split=True)
    with pytest.raises(ValueError, match="cond_width_split"):
        make_search_steps(net, capture=True, **KW)
    with pytest.raises(ValueError, match="cond_width_split"):
        make_pareto_search_steps(net, make_mesh(1, 2, 0),
                                 num_classes=CLASSES, targets=(0.02, 0.03),
                                 capture=True)
    make_search_steps(net, **KW)  # eager steps are fine


# -- the tiny-space supernet in both packages --------------------------------

@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(7)
    tnet = TNet(CLASSES, space=tss.tiny_space(RES))
    params = params_to_jax(tnet.init(torch.Generator().manual_seed(2))[0])
    nblk = len(tnet.sites)
    arch = {"log_alphas": (rng.standard_normal((nblk, 8)) * 0.5
                           ).astype(np.float32),
            "betas": {s: rng.standard_normal(d).astype(np.float32)
                      for s, d in tnet.ss.STAGE_DEPTHS.items()}}
    mc = tnet.ss.build_mc_mask_dddict()
    for stage in mc:
        for block in mc[stage]:
            for m in mc[stage][block].values():
                m[rng.choice(np.nonzero(m)[0], 2, replace=False)] = 0.0
    return dict(params=params, arch=arch, mc=mc, nblk=nblk,
                x=rng.standard_normal((N, RES, RES, 3)).astype(np.float32),
                y=rng.integers(0, CLASSES, N).astype(np.int32),
                lat=rng.uniform(0.0, 0.01, (nblk, 8)).astype(np.float32),
                key=jax.random.PRNGKey(9))


def test_apply_multi_sampled_float64(tiny):
    """Two sampled sub-networks as channel groups of one pass equal two
    apply_sampled calls and JAX's apply_multi_sampled (float64: at 32^2
    the deep stages' 1x1 maps make f32 BN over 2 values ill-conditioned)."""
    nb = tiny["nblk"]
    idx = np.stack([np.arange(nb) % 8, (np.arange(nb) + 3) % 8])
    tnet = TNet(CLASSES, space=tss.tiny_space(RES))
    tp = _f64(params_from_jax(tiny["params"]))
    ta = _f64(arch_from_jax(tiny["arch"]))
    tm = _f64(tnet.device_masks(tiny["mc"], "cpu"))
    x = torch.from_numpy(tiny["x"]).double()
    got = tnet.apply_multi_sampled(tp, ta, tm, x, torch.from_numpy(idx))
    assert got.shape == (2, N, CLASSES) and got.dtype == torch.float64
    for s in range(2):
        one = tnet.apply_sampled(tp, ta, tm, x, torch.from_numpy(idx[s]))
        np.testing.assert_allclose(got[s].numpy(), one.numpy(), rtol=1e-7,
                                   atol=1e-7)
    jnet = JNet(CLASSES, space=jss.tiny_space(RES))
    with jax.enable_x64():
        f64 = functools.partial(jax.tree_util.tree_map,
                                lambda a: jnp.asarray(a, jnp.float64))
        want = jnet.apply_multi_sampled(
            f64(tiny["params"]), f64(tiny["arch"]),
            f64(jnet._host_stacked_masks(tiny["mc"])),
            jnp.asarray(tiny["x"], jnp.float64), jnp.asarray(idx, jnp.int32),
            training=True)
        want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=1e-7)


# -- remat_blocks ------------------------------------------------------------

def _draws(tiny, kind):
    """The JAX steps' draws from tiny['key'], as the port takes them."""
    la = jnp.asarray(tiny["arch"]["log_alphas"])
    if kind == "arch":
        u = jax.random.uniform(tiny["key"], la.shape, jnp.float32,
                               minval=1e-10, maxval=1.0)
        return (torch.from_numpy(np.array(u)),)
    if kind == "warmup":
        return (torch.from_numpy(np.array(
            sample_gumbel_indices(tiny["key"], la))).long(),)
    kg, kr = jax.random.split(tiny["key"])
    g = sample_gumbel_indices(kg, la)
    return tuple(torch.from_numpy(np.array(d)).long()
                 for d in (g, sample_random_excluding(kr, g, 8)))


def _port_step(tiny, net, kind):
    """One port step from the tiny state; returns its updated trees."""
    s = make_search_steps(net, **KW)
    tp, ta = params_from_jax(tiny["params"]), arch_from_jax(tiny["arch"])
    masks = net.device_masks(tiny["mc"], "cpu")
    x, y = torch.from_numpy(tiny["x"]), torch.from_numpy(tiny["y"]).long()
    if kind == "arch":
        a, opt, m = s.arch_step(tp, ta, adam_init(ta), masks, x, y,
                                torch.from_numpy(tiny["lat"]), 0.004, 5.0,
                                *_draws(tiny, kind))
        return {"arch": a, "mu": opt.mu, "nu": opt.nu, "m": m}
    step = s.warmup_step if kind == "warmup" else s.weight_step
    p, mom, m = step(tp, ta, zeros_like_tree(tp), masks,
                     net.update_masks(tp, tiny["mc"]), x, y, 0.025,
                     *_draws(tiny, kind))
    return {"params": p, "mom": mom, "m": m}


@pytest.mark.parametrize("kind", ["warmup", "weight", "arch"])
def test_remat_steps_equal_plain_steps(tiny, kind):
    """Recomputing each block in the backward changes nothing: the same
    operations on the same values, bit for bit."""
    nets = [TNet(CLASSES, space=tss.tiny_space(RES), remat_blocks=r)
            for r in (True, False)]
    got, want = (_port_step(tiny, n, kind) for n in nets)
    for k in want:
        for a, b in zip(tree_leaves(got[k]), tree_leaves(want[k])):
            assert torch.equal(a, b), k


@pytest.mark.parametrize("kind", ["weight", "arch"])
def test_remat_steps_match_jax_remat_steps(tiny, kind):
    jnet = JNet(CLASSES, space=jss.tiny_space(RES), remat_blocks=True)
    js = jsteps(jnet, **KW)
    jp = jax.tree_util.tree_map(jnp.asarray, tiny["params"])
    ja = jax.tree_util.tree_map(jnp.asarray, tiny["arch"])
    masks = jnet.device_masks(tiny["mc"])
    x, y = jnp.asarray(tiny["x"]), jnp.asarray(tiny["y"])
    got = _port_step(tiny, TNet(CLASSES, space=tss.tiny_space(RES),
                                remat_blocks=True), kind)
    if kind == "arch":
        a, opt, _ = js.arch_step(jp, ja, jadam_init(ja), masks, x, y,
                                 jnp.asarray(tiny["lat"]), jnp.float32(0.004),
                                 jnp.float32(5.0), tiny["key"])
        pairs = [(to_numpy_tree(got["arch"]), a),
                 (to_numpy_tree(got["mu"]), opt.mu)]
    else:
        p, mom, _ = js.weight_step(jp, ja, zeros_like_momentum(jp), masks,
                                   jnet.update_masks(jp, tiny["mc"]), x, y,
                                   jnp.float32(0.025), tiny["key"])
        pairs = [(params_to_jax(got["params"]), p),
                 (params_to_jax(got["mom"]), mom)]
    for g, w in pairs:
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=1e-5, atol=1e-5), g, w)


def test_hybrid_remat_blocks_equal_plain_blocks():
    """A ViT site's sampled (ViT and conv picks) and soft block functions,
    forward and backward, with and without remat_blocks: bit for bit."""
    nets = [HybridSuperNetwork(CLASSES, remat_blocks=r) for r in (True, False)]
    g = next(iter(nets[0].vit))
    site = nets[0].sites[g]
    gen = torch.Generator().manual_seed(4)
    p = nets[0]._init_block(site, gen)
    p["vit"] = nets[0].vit_blocks[g].init(gen)[0]
    mc = ths.build_mc_mask_dddict()
    masks = nets[0].device_masks(mc, "cpu")
    x = torch.randn((N, site.ic, 4, 4), generator=gen)
    w = torch.softmax(torch.randn(ths.NUM_OPS, generator=gen), 0)
    results = []
    for net in nets:
        out = []
        for fn, arg in ((net._sampled_block_fn(site, True), torch.tensor(8)),
                        (net._sampled_block_fn(site, True), torch.tensor(3)),
                        (net._soft_block_fn(site, True), w)):
            leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
            xx = x.clone().requires_grad_()
            y = fn(tree_unflatten(p, leaves), masks, arg, xx)
            grads = torch.autograd.grad(y.square().sum(), [xx] + leaves,
                                        allow_unused=True)
            out.append([y] + [gr for gr in grads if gr is not None])
        results.append(out)
    for a, b in zip(*results):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            assert torch.equal(u, v)


# -- the driver's profiler and step timing -----------------------------------

def test_driver_profile_steps_and_step_timing(tmp_path, monkeypatch):
    work, save = tmp_path / "cwd", tmp_path / "save"
    work.mkdir()
    monkeypatch.chdir(work)
    trace.enable()  # what TFNAS_TRACE=1 does at import
    try:
        run_dir = train_search.main([
            "--device", "cpu", "--space", "tiny", "--synthetic",
            "--no_bf16", "--epochs", "2", "--warmup_epochs", "1",
            "--steps_per_epoch", "3", "--image_size", "32", "--batch_size",
            "4", "--num_classes", "10", "--target_lat", "2.0",
            "--profile_steps", "2", "--save", str(save)])
    finally:
        trace.disable()
        trace.reset()
    logging.getLogger().handlers.clear()
    trace_json = pathlib.Path(run_dir) / "profile" / "trace.json"
    events = json.loads(trace_json.read_text())["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
    # the spans lie in the operator's trace beside the kernels
    assert sum(e.get("name") == "tfnas.search.step" for e in events) >= 1
    assert not list(work.iterdir())  # nothing outside --save
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cwd", "save"]
    log = (pathlib.Path(run_dir) / "log.txt").read_text()
    assert log.count("timing: fetch ") == 6   # one per weight step
    assert f"profiler trace written to {trace_json}" in log


# -- the tools ---------------------------------------------------------------

TINY_TOOL = ["--device", "cpu", "--space", "tiny", "--image_size", "32",
             "--batch_size", "4", "--num_classes", "10"]


@pytest.mark.parametrize("flags", [[], ["--grouped_project",
                                        "--dw_kernel_split"]])
def test_tools_profile_rows(flags, capsys):
    out = tools_profile.main(TINY_TOOL + ["--iters", "1"] + flags)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(out))
    rows = ["sampled fwd", "sampled fwd+bwd",
            "bi-sample pair fwd+bwd (shared stem)", "soft fwd (8 branches)",
            "soft arch grad", *tools_profile.STEP_ROWS]
    assert list(out["ms"]) == rows and out["device"] == "cpu"
    assert all(math.isfinite(v) and v > 0 for v in out["ms"].values())
    assert math.isfinite(out["steps_per_s"])


def test_tools_ab_ksplit_variants(capsys):
    out = tools_ab_ksplit.main(TINY_TOOL + ["--n", "1"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["variants"].keys() == tools_ab_ksplit.VARIANTS.keys()
    for name, v in out["variants"].items():
        assert math.isfinite(v["ms"]) and math.isfinite(v["ms_pass1"])
        assert math.isfinite(v["loss_a"])
        # the same function: f32 rounding apart
        assert v["max_abs_log_alphas_vs_einsum"] < 1e-5, name


_spec = importlib.util.spec_from_file_location(
    "tools_profile_eval", REPO / "tools_profile_eval.py")
jtpe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jtpe)
CONFIGS = [
    ("checkpoints_e2e/pareto-tiny/"
     "pareto-search-20260819-205815-pareto-tiny/model_g0.config", 10, 32),
    ("checkpoints_e2e/proxy30-e2e-family-a/"
     "search-20260819-192932-proxy30-e2e-family-a/model.config", 30, 224),
]


@pytest.mark.parametrize("cfg,ncls,size", CONFIGS)
def test_segment_flops_match_jax_tool(cfg, ncls, size):
    config = json.loads((REPO / cfg).read_text())
    net = EvalNetwork.from_config(ncls, config)
    jnet = JEval.from_config(ncls, config)
    segs = ttpe.segment_flops(net, size)
    want = jtpe.segment_flops(jnet, size)
    assert [n for n, _ in segs] == [n for n, _ in want]
    for (_, f), (_, g) in zip(segs, want):
        assert f == pytest.approx(g, rel=1e-12)
    total = sum(f for _, f in segs)
    assert total == pytest.approx(calculate_FLOPs_in_M(net, size), rel=1e-9)
    assert total == pytest.approx(jflops(jnet, size), rel=1e-9)


def test_profile_eval_prefixes_and_main(tmp_path, capsys):
    """Every prefix program runs and deepens; the tool's CPU run prints
    its rows."""
    cfg, ncls, size = CONFIGS[0]
    net = EvalNetwork.from_config(ncls, json.loads((REPO / cfg).read_text()))
    net, params = fold_batchnorm(net, *net.init(
        torch.Generator().manual_seed(0)))  # as the tool does
    x = torch.zeros((2, size, size, 3))
    shapes = [tuple(ttpe.prefix_apply(net, k)(params, x).shape)
              for k in range(len(net.stages) + 4)]
    assert shapes[0] == () and shapes[-1] == (2, ncls)
    res = [s[2] for s in shapes[1:-1]]
    assert all(a >= b for a, b in zip(res, res[1:]))
    out = ttpe.main(["--device", "cpu", "--config_path", str(REPO / cfg),
                     "--num_classes", str(ncls), "--image_size", str(size),
                     "--batch_size", "2", "--iters", "1",
                     "--json_out", str(tmp_path / "o.json")])
    assert [r["segment"] for r in out["rows"]] == [
        n for n, _ in ttpe.segment_flops(net, size)]
    assert json.loads((tmp_path / "o.json").read_text())["rows"] == \
        json.loads(json.dumps(out["rows"]))
    assert out["peak_tflops"] == 989.0
    capsys.readouterr()
