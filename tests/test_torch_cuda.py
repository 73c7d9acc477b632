"""The port on a CUDA card: the hand-written fused depthwise kernel against
its plain PyTorch version (on the current device and, with two cards, on
another), the supernet and one warmup, weight and arch step on the card
against the same on the CPU, the eval net's forward, train step and folds,
and the prefetcher. These tests skip without a card. They import no JAX,
so they run on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py

Also the search steps replayed from CUDA graphs (search/compiled.py)
against the eager steps, the scanned iteration's draws and result captured
and eager, the step path without a host sync, the driver loop's buffer rewrites at epoch
boundaries, and the latency chain (cost/measure.py); the eval train step
replayed from its CUDA graph against the eager step (MBConv and hybrid
nets, a small CoAtNet, a short batch run eagerly between replays), and
the small CoAtNet's forward and train step on the card against the CPU;
and the supernet's
opt-in lowerings: remat_blocks captured against eager and against no
remat, the soft path's grouped project and k3/k5 depthwise split against
the CPU, apply_multi_sampled against two sampled forwards, and the kernel
at the channel counts they give it (4 * ic, 16 * ic); and the kernel at the
largest site of each stride at search batches 128 and 256. And the card
image pipeline (runtime/card.py): the augment kernel against its plain
version (sizes whose plan holds and sweeps, unaligned spans, two launches
in one call, images with and without contrast in one batch), nvJPEG
against PIL, the entries nvJPEG refuses, ImageList on the
card, and a card list whose library does not build. And the port's spans
(utils/trace.py): a GraphedFn's call, argument, replay and capture spans,
no device event under a stream capture, and the eager train step's
phases in a profiled Chrome trace with their device times.

Tolerances: f32 with TF32 off, 2e-4 for y (summation order) and 1e-3 for
the sums; bf16, 2e-2 (one bf16 rounding of y, 2^-8 relative, either way);
the augment kernel within one uint8 level of its plain version on at most
0.1% of the values; nvJPEG within 2 levels of PIL on average per file;
the search steps and the eval forward on the card against the CPU 1e-4,
one eval train step and the folds 1e-5; captured against eager steps bit
for bit (cuDNN deterministic), else 1e-5.
"""

import gc

import pytest
import torch

from tfnas_tpu_torch.kernels import fused_dw as tfused
from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.models.supernet import SuperNetwork
from tfnas_tpu_torch.search.train_step import tree_leaves, tree_map


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU version")
    # a GraphFamily and its graphs form a reference cycle: free those of
    # earlier tests now, since a graph freed by a collection that runs
    # inside a capture invalidates that capture
    gc.collect()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32


def _inputs(seed, n, h, c, device, dtype, w=None):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, h, w or h, c), generator=g).to(device, dtype)
    wk = (torch.randn((5, 5, c), generator=g) * 0.1).to(device)
    scale = (torch.rand(c, generator=g) + 0.5).to(device)
    offset = (torch.randn(c, generator=g) * 0.1).to(device)
    return x, wk, scale, offset


def _check_forward(a, stride, act, dtype):
    before = dict(tfused.launches)
    got = tfused.fused_dw_cuda(*a, stride, act)
    want = tfused.fused_dw_plain(*a, stride, act)
    torch.cuda.synchronize()
    before[stride] += 1
    assert tfused.launches == before
    assert got[0].dtype == dtype and got[0].shape == want[0].shape
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol,
                               atol=tol)
    # the sums: the kernel sums the f32 accumulator, the plain version the
    # rounded y, so bf16 differs by up to 2^-8 of sum |y| (and sum y^2)
    yf = want[0].float()
    for g, w, scale in ((got[1], want[1], yf.abs().sum((0, 1, 2))),
                        (got[2], want[2], (yf * yf).sum((0, 1, 2)))):
        rel = 1e-5 if dtype == torch.float32 else 2 ** -7
        assert torch.all((g - w).abs() <= rel * scale + 1e-4)
    return got


@pytest.mark.parametrize("c", [96, 768, 30])
@pytest.mark.parametrize("act", ["relu", "swish"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_kernel_matches_plain(cuda, stride, dtype, act, c):
    _check_forward(_inputs(3, 2, 14, c, cuda, dtype), stride, act, dtype)


@pytest.mark.parametrize("n,h,w,c", [(1, 1, 1, 30), (3, 7, 13, 194),
                                     (1, 13, 57, 200), (3, 57, 7, 30),
                                     (1, 57, 57, 194)])
@pytest.mark.parametrize("act", ["relu", "swish"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_kernel_edge_shapes(cuda, stride, dtype, act, n, h, w, c):
    """Ragged shapes: C not a multiple of the 16-byte copy or the channel
    group, H and W not multiples of the strip or segment, N 1 and 3. The
    forward, the four gradients (1e-3 f32, 2e-2 bf16 of the largest entry)
    and bit-identical sums over two runs."""
    a = _inputs(6, n, h, c, cuda, dtype, w)
    got = _check_forward(a, stride, act, dtype)
    again = tfused.fused_dw_cuda(*a, stride, act)
    for g1, g2 in zip(got, again):
        assert torch.equal(g1, g2)
    a1 = [t.clone().requires_grad_() for t in a]
    a2 = [t.clone().requires_grad_() for t in a]
    for out, args in ((tfused.fused_dw_norm_act(*a1, stride, act), a1),
                      (tfused.fused_dw_plain(*a2, stride, act), a2)):
        y, s, q = out
        ((y.float() ** 2).sum() + s.sum() + 1e-3 * q.sum()).backward()
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    for t1, t2 in zip(a1, a2):
        err = (t1.grad - t2.grad).abs().max()
        assert err <= tol * t2.grad.abs().max().clamp_min(1e-12)


def test_wrapper_refuses_bad_input(cuda):
    x, w, scale, offset = _inputs(4, 1, 8, 32, cuda, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        tfused.fused_dw_cuda(x.transpose(1, 2), w, scale, offset, 1, "relu")
    with pytest.raises(TypeError):
        tfused.fused_dw_cuda(x.half(), w, scale, offset, 1, "relu")
    with pytest.raises(ValueError, match="stride"):
        tfused.fused_dw_cuda(x, w, scale, offset, 3, "relu")
    with pytest.raises(ValueError, match="scale"):
        tfused.fused_dw_cuda(x, w, scale[:16], offset, 1, "relu")
    odd = _inputs(5, 1, 8, 33, cuda, torch.float32)
    with pytest.raises(ValueError, match="even"):
        tfused.fused_dw_cuda(*odd, 1, "relu")
    # 16-byte copies need x on a 16-byte boundary: a view one pixel in is
    # on one only when a pixel is a multiple of 16 bytes
    base = torch.zeros(2 * 8 * 8 * 32 + 2, device=cuda)
    shifted = base[2:].view(2, 8, 8, 32)
    with pytest.raises(ValueError, match="aligned"):
        tfused.fused_dw_cuda(shifted, w, scale, offset, 1, "relu")


def test_supernet_on_card_matches_cpu(cuda):
    """The tiny supernet's soft and sampled forwards through the kernel
    equal the CPU forwards through the plain version (f32, TF32 off)."""
    net = SuperNetwork(10, space=tss.tiny_space(32))
    params, arch = net.init(torch.Generator().manual_seed(0))
    masks = net.device_masks(net.ss.build_mc_mask_dddict(), "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn((4, 32, 32, 3), generator=g)
    idx = torch.randint(0, 8, (3,), generator=g)
    gw = torch.softmax(torch.randn((3, 8), generator=g), -1)
    lat = torch.rand((3, 8), generator=g)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    outs = {}
    for dev in ("cpu", cuda):
        p, a, m = to(params, dev), to(arch, dev), to(masks, dev)
        before = sum(tfused.launches.values())
        soft, l = net.apply_soft(p, a, m, x.to(dev), gw.to(dev), lat.to(dev))
        hard = net.apply_sampled(p, a, m, x.to(dev), idx.to(dev))
        outs[str(dev)] = (soft.cpu(), l.cpu(), hard.cpu())
        launched = sum(tfused.launches.values()) - before
        assert launched == (6 if dev == cuda else 0)
    for c, k in zip(outs["cpu"], outs["cuda"]):
        torch.testing.assert_close(k, c, rtol=1e-4, atol=1e-4)


def test_kernel_launches_on_current_and_other_device(cuda):
    """The wrapper enters a device guard only for x off the current device;
    the kernel is right on the current device and, with two cards, on the
    other one."""
    devices = [torch.device("cuda", torch.cuda.current_device())]
    if torch.cuda.device_count() > 1:
        devices.append(torch.device(
            "cuda", (torch.cuda.current_device() + 1)
            % torch.cuda.device_count()))
    for dev in devices:
        a = _inputs(7, 2, 14, 64, dev, torch.float32)
        before = dict(tfused.launches)
        got = tfused.fused_dw_cuda(*a, 1, "relu")
        want = tfused.fused_dw_plain(*a, 1, "relu")
        torch.cuda.synchronize(dev)
        assert got[0].device == dev
        assert tfused.launches[1] == before[1] + 1
        torch.testing.assert_close(got[0], want[0], rtol=2e-4, atol=2e-4)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree if tree is None or isinstance(tree, (int, float)) \
        else tree.to(dev)


def _eval_net():
    from collections import OrderedDict
    from tfnas_tpu_torch.models.eval_net import EvalNetwork
    from tfnas_tpu_torch.search.parser import get_mc_num_dddict
    sp = tss.tiny_space(32)
    parsed = OrderedDict(
        (stage, OrderedDict((b, (i + 5) % 8)
                            for i, b in enumerate(sp.block_names(stage))))
        for stage in sp.STAGE_NAMES)
    net = EvalNetwork.from_parsed_arch(
        10, parsed, get_mc_num_dddict(sp.build_mc_mask_dddict()), 0.3, 0.5,
        space=sp)
    params, state = net.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    state = tree_map(lambda t: t + 0.1 * torch.rand(t.shape, generator=g),
                     state)
    x = torch.randn((8, 32, 32, 3), generator=g)
    y = torch.randint(0, 10, (8,), generator=g)
    return net, params, state, x, y


def test_eval_forward_and_train_step_on_card_match_cpu(cuda):
    """The eval net's forward (eval and training with the same draws) and
    one train step on the card equal the CPU's: forward 1e-4, the step's
    params, BN state and momentum 1e-5, f32 with TF32 off."""
    from tfnas_tpu_torch.parallel import train_dp
    net, params, state, x, y = _eval_net()
    keep = net.draw_keep(8, torch.Generator().manual_seed(2))
    outs = []
    for dev in ("cpu", cuda):
        p, s = _to(params, dev), _to(state, dev)
        ev, _ = net.apply(p, s, x.to(dev))
        tr, st = net.apply(p, s, x.to(dev), training=True, keep=_to(keep, dev))
        train, _ = train_dp.make_eval_steps(net, num_classes=10,
                                            compute_dtype=torch.float32)
        mom = tree_map(torch.zeros_like, p)
        nst, m = train(train_dp.EvalTrainState(p, s, mom, 0), x.to(dev),
                       y.to(dev), 0.1, _to(keep, dev))
        outs.append([t.cpu() for t in [ev, tr] + tree_leaves(st)] + [
            t.cpu() for t in tree_leaves(nst.params)
            + tree_leaves(nst.bn_state) + tree_leaves(nst.momentum)
            + [m["loss"]]])
    n_fwd = 2 + len(tree_leaves(st))
    for i, (c, k) in enumerate(zip(*outs)):
        tol = 1e-4 if i < n_fwd else 1e-5
        torch.testing.assert_close(k, c, rtol=tol, atol=tol)


def test_folds_on_card_match_unfolded(cuda):
    """fold_batchnorm and the s2d stem on the card against the unfolded
    eval forward there: f32 1e-5."""
    from tfnas_tpu_torch.models import folding
    net, params, state, x, _ = _eval_net()
    p, s, xc = _to(params, cuda), _to(state, cuda), x.to(cuda)
    ref, _ = net.apply(p, s, xc)
    folded, fp = folding.fold_batchnorm(net, p, s)
    s2d, sp = folding.fold_stem_space_to_depth(folded, fp)
    for n2, p2 in ((folded, fp), (s2d, sp)):
        got, _ = n2.apply(p2, {}, xc)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_search_steps_on_card_match_cpu(cuda):
    """One warmup, one weight and one arch step of the tiny supernet on the
    card (through the fused kernel and its backward) against the same steps
    on the CPU with the same draws: 1e-4, f32 with TF32 off."""
    from tfnas_tpu_torch.search.train_step import (adam_init,
                                                   make_search_steps)
    net = SuperNetwork(10, space=tss.tiny_space(32))
    params, arch = net.init(torch.Generator().manual_seed(0))
    mc = net.ss.build_mc_mask_dddict()
    g = torch.Generator().manual_seed(1)
    x = torch.randn((4, 32, 32, 3), generator=g)
    y = torch.randint(0, 10, (4,), generator=g)
    ig = torch.randint(0, 8, (3,), generator=g)
    ir = (ig + 1 + torch.randint(0, 7, (3,), generator=g)) % 8
    u = torch.rand((3, 8), generator=g).clamp_min(1e-6)
    lat = torch.rand((3, 8), generator=g) * 0.01
    steps = make_search_steps(net, num_classes=10, lambda_lat=0.1,
                              target_lat=0.02)
    outs = []
    for dev in ("cpu", cuda):
        p, a = _to(params, dev), _to(arch, dev)
        masks = net.device_masks(mc, dev)
        um = net.update_masks(p, mc)
        mom = tree_map(torch.zeros_like, p)
        before = sum(tfused.launches.values())
        p1, m1, _ = steps.warmup_step(p, a, mom, masks, um, x.to(dev),
                                      y.to(dev), 0.025, ig.to(dev))
        p2, m2, _ = steps.weight_step(p1, a, m1, masks, um, x.to(dev),
                                      y.to(dev), 0.025, ig.to(dev),
                                      ir.to(dev))
        a3, opt, ma = steps.arch_step(p2, a, adam_init(a), masks, x.to(dev),
                                      y.to(dev), lat.to(dev), 0.004, 5.0,
                                      u.to(dev))
        launched = sum(tfused.launches.values()) - before
        assert launched == (0 if dev == "cpu" else 3 + 6 + 3)
        outs.append([t.cpu() for t in tree_leaves(p2) + tree_leaves(m2)
                     + tree_leaves(a3) + [ma["loss_a"], ma["lat"]]])
    for c, k in zip(*outs):
        torch.testing.assert_close(k, c, rtol=1e-4, atol=1e-4)


def test_prefetcher_and_normalizer_on_card(cuda):
    import numpy as np
    from tfnas_tpu_torch.data import DevicePrefetcher, device_normalizer
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (4, 8, 8, 3), np.uint8),
                np.arange(4, dtype=np.int32), 3) for _ in range(5)]
    prep = device_normalizer(torch.bfloat16)
    out = list(DevicePrefetcher(iter(batches), cuda))
    assert len(out) == 5
    for (x, y, n), (bx, by, bn) in zip(out, batches):
        assert x.is_cuda and y.dtype == torch.int64 and n == bn
        assert torch.equal(x.cpu(), torch.from_numpy(bx))
        want = device_normalizer(torch.bfloat16)(torch.from_numpy(bx))
        torch.testing.assert_close(prep(x).cpu(), want, rtol=0, atol=0)


# -- captured steps -----------------------------------------------------------

def _tiny_state(dev, seed=0, **net_kw):
    from tfnas_tpu_torch.search.train_step import adam_init, zeros_like_tree
    net = SuperNetwork(10, space=tss.tiny_space(32), **net_kw)
    params, arch = net.init(torch.Generator().manual_seed(seed))
    params, arch = _to(params, dev), _to(arch, dev)
    mc = net.ss.build_mc_mask_dddict()
    g = torch.Generator().manual_seed(seed + 1)
    state = {"params": params, "arch": arch, "mom": zeros_like_tree(params),
             "opt": adam_init(arch), "masks": net.device_masks(mc, dev),
             "umasks": net.update_masks(params, mc),
             "lat": (torch.rand((3, 8), generator=g) * 0.01).to(dev),
             "lr": torch.tensor(0.025, device=dev),
             "T": torch.tensor(5.0, device=dev),
             "base": torch.tensor(0.004, device=dev)}
    data = [(torch.randn((4, 32, 32, 3), generator=g).to(dev),
             torch.randint(0, 10, (4,), generator=g).to(dev))
            for _ in range(6)]
    return net, state, data


def _step(steps, kind, st, x, y, gen):
    from tfnas_tpu_torch.search.bisample import (gumbel_uniform,
                                                 sample_gumbel_indices,
                                                 sample_random_excluding)
    la = st["arch"]["log_alphas"]
    if kind == "arch":
        a, o, m = steps.arch_step(st["params"], st["arch"], st["opt"],
                                  st["masks"], x, y, st["lat"], st["base"],
                                  st["T"], gumbel_uniform(la.shape, gen))
        return {"arch": a, "opt": o}, m
    ig = sample_gumbel_indices(la, gen)
    if kind == "warmup":
        p, mo, m = steps.warmup_step(st["params"], st["arch"], st["mom"],
                                     st["masks"], st["umasks"], x, y,
                                     st["lr"], ig)
    else:
        p, mo, m = steps.weight_step(st["params"], st["arch"], st["mom"],
                                     st["masks"], st["umasks"], x, y,
                                     st["lr"], ig,
                                     sample_random_excluding(ig, 8, gen))
    return {"params": p, "mom": mo}, m


def _assert_trees_equal(a, b):
    from tfnas_tpu_torch.search.compiled import leaves_of
    la, lb = leaves_of(a), leaves_of(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


@pytest.fixture
def deterministic(cuda):
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    yield cuda
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old


def test_captured_steps_match_eager(deterministic):
    """Warmup, weight and arch steps replayed from CUDA graphs equal the
    eager steps from the same state, batch and draws, over two replays of
    each; each graph holds the kernel at both strides (the tiny space has
    sites of each) and a replay adds its nodes to the replayed count."""
    from tfnas_tpu_torch.search.compiled import GraphFamily
    from tfnas_tpu_torch.search.train_step import make_search_steps
    dev = deterministic
    net, st, data = _tiny_state(dev)
    kw = dict(num_classes=10, lambda_lat=0.1, target_lat=0.02)
    eager = make_search_steps(net, **kw)
    fam = GraphFamily(dev)
    capt = make_search_steps(net, capture=True, family=fam, **kw)
    est = dict(st)
    cst = fam.adopt(dict(st))
    for i, kind in enumerate(("warmup", "weight", "arch", "warmup",
                              "weight", "arch")):
        x, y = data[i]
        want, wm = _step(eager, kind, est, x, y,
                         torch.Generator(device=dev).manual_seed(i))
        before = dict(tfused.replayed)
        got, gm = _step(capt, kind, cst, x, y,
                        torch.Generator(device=dev).manual_seed(i))
        _assert_trees_equal(got, want)
        _assert_trees_equal(gm, wm)
        est.update(want)
        cst.update(got)
        graph = {g.name: g for g in fam.graphs}[f"{kind}_step"]
        assert all(graph.nodes.values()) and tfused.replayed == {
            s: before[s] + n for s, n in graph.nodes.items()}
    assert [g.name for g in fam.graphs] == ["warmup_step", "weight_step",
                                            "arch_step"]
    assert all(g.replays == 2 for g in fam.graphs)


def test_captured_draws_match_eager(deterministic):
    """The scanned iteration over the captured weight and arch steps draws
    from the caller's generator between replays: the same generator state
    gives the same draws and the same result as the eager loop over two
    calls of K units, the generator ends where eager leaves it, and the
    units replay the two step graphs and capture no other."""
    from tfnas_tpu_torch.search.compiled import GraphFamily
    from tfnas_tpu_torch.search.train_step import make_scanned_search_iter
    dev = deterministic
    net, st, data = _tiny_state(dev, seed=3)
    K = 2
    xw = torch.stack([d[0] for d in data[:4]]).reshape(K, 2, 4, 32, 32, 3)
    yw = torch.stack([d[1] for d in data[:4]]).reshape(K, 2, 4)
    xa = torch.stack([d[0] for d in data[4:6]])
    ya = torch.stack([d[1] for d in data[4:6]])
    kw = dict(num_classes=10, lambda_lat=0.1, target_lat=0.02)
    outs, gens = {}, {}
    fam = GraphFamily(dev)
    for name, kwargs in (("eager", {}),
                         ("captured", dict(capture=True, family=fam))):
        run = make_scanned_search_iter(net, **kwargs, **kw)
        gen = torch.Generator(device=dev).manual_seed(5)
        out = None
        for _ in range(2):
            s = st if out is None else dict(st, params=out[0], mom=out[1],
                                            arch=out[2], opt=out[3])
            out = run(s["params"], s["mom"], s["arch"], s["opt"], s["masks"],
                      s["umasks"], xw, yw, xa, ya, s["lr"], s["T"], s["lat"],
                      s["base"], gen)
        outs[name] = out
        gens[name] = torch.rand(4, generator=gen, device=dev)
    for k in ("idx_g", "idx_r"):
        assert torch.equal(outs["captured"][4][k], outs["eager"][4][k])
    assert torch.equal(outs["captured"][5]["gumbel_u"],
                       outs["eager"][5]["gumbel_u"])
    _assert_trees_equal(outs["captured"][:4], outs["eager"][:4])
    _assert_trees_equal(outs["captured"][4:], outs["eager"][4:])
    assert torch.equal(gens["captured"], gens["eager"])
    assert [(g.name, g.replays) for g in fam.graphs] == [
        ("weight_step", 2 * K * 2), ("arch_step", 2 * K)]


def _assert_trees_identical(a, b):
    from tfnas_tpu_torch.search.compiled import leaves_of
    la, lb = leaves_of(a), leaves_of(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _hybrid_eval_net():
    """The full-width eval net of the hybrid space with the ViT candidate
    at stage5/block1 and stage6/block1 (op 1 elsewhere), and its init."""
    from collections import OrderedDict
    from tfnas_tpu_torch.models import hybrid_space as hs
    from tfnas_tpu_torch.models.eval_net import EvalNetwork
    from tfnas_tpu_torch.search.parser import get_mc_num_dddict
    parsed = OrderedDict(
        (stage, OrderedDict((f"block{i + 1}", 1) for i in range(d)))
        for stage, d in hs.STAGE_DEPTHS.items())
    parsed["stage5"]["block1"] = parsed["stage6"]["block1"] = hs.VIT_OP_IDX
    net = EvalNetwork.from_parsed_arch(
        10, parsed, get_mc_num_dddict(hs.build_mc_mask_dddict()), 0.3, 0.5)
    assert sum(b.name == "ViTBlock" for _, _, b in net.iter_blocks()) == 2
    return (net, *net.init(torch.Generator().manual_seed(3)))


def _graphed_against_eager(dev, net, params, bn, sizes, res, dtype):
    """The default train step (graphed on the card) and the eager one
    (capture=False) from one state over batches of `sizes`, each with its
    own keep draws and lr; asserts every step's state and metrics are
    equal bit for bit and returns the graphed step."""
    from tfnas_tpu_torch.parallel import train_dp
    kw = dict(num_classes=10, compute_dtype=dtype)
    graphed, _ = train_dp.make_eval_steps(net, **kw)
    eager, _ = train_dp.make_eval_steps(net, capture=False, **kw)
    p = _to(params, dev)
    got = want = train_dp.EvalTrainState(p, _to(bn, dev),
                                         tree_map(torch.zeros_like, p), 0)
    g = torch.Generator(device=dev).manual_seed(4)
    for i, n in enumerate(sizes):
        x = torch.randn((n, res, res, 3), generator=g, device=dev)
        y = torch.randint(0, 10, (n,), generator=g, device=dev)
        keep = net.draw_keep(n, g)
        lr = 0.2 / (i + 1)
        got, gm = graphed(got, x, y, lr, keep)
        want, wm = eager(want, x, y, lr, keep)
        _assert_trees_identical([got[:3], gm], [want[:3], wm])
    return graphed


def _coatnet_net():
    """A small CoAtNet (L = (2, 2, 1, 2, 1), D = (16, 16, 32, 64, 64),
    64^2, 10 classes) with every block kind: MBConv blocks downsampling
    with and without a projection and at stride 1, transformer blocks
    downsampling and at stride 1; the reference's weight draws (bias
    tables, LN affines and SE biases away from their init)."""
    from benchmark.reference import coatnet as rc
    from benchmark.reference.nn import Pool
    from tfnas_tpu_torch.models.eval_net import EvalNetwork
    cfg = rc.model_config((2, 2, 1, 2, 1), (16, 16, 32, 64, 64), 64, 10)
    net = EvalNetwork.from_config(10, cfg, 0.3, 0.5)
    params, bn = rc.CoAtNet(cfg, 10).init(
        Pool(torch.Generator().manual_seed(3)))
    return net, params, bn


@pytest.mark.parametrize("kind,dtype", [("mbconv", torch.float32),
                                        ("mbconv", torch.bfloat16),
                                        ("hybrid", torch.float32),
                                        ("coatnet", torch.float32),
                                        ("coatnet", torch.bfloat16)])
def test_graphed_train_step_equals_eager(deterministic, kind, dtype):
    """make_eval_steps' default train step on the card replays one CUDA
    graph and equals the eager step bit for bit over 4 steps, each with
    fresh drop-connect and dropout draws and another lr: params, BN
    state, momentum and metrics; on the tiny MBConv net (32^2, batch 8),
    on a full-width hybrid net with two ViT blocks (64^2, batch 4) and on
    a small CoAtNet with all four of its block kinds (64^2, batch 4: the
    relative bias's backward sums without atomics)."""
    if kind == "mbconv":
        net, params, bn, _, _ = _eval_net()
        n, res = 8, 32
    elif kind == "coatnet":
        net, params, bn = _coatnet_net()
        n, res = 4, 64
    else:
        net, params, bn = _hybrid_eval_net()
        n, res = 4, 64
    step = _graphed_against_eager(deterministic, net, params, bn, [n] * 4,
                                  res, dtype)
    assert (step.replays, step.eager_calls) == (4, 0)
    assert step.graphed.replays == 4 and step.graphed.name == "train_step"


def test_coatnet_on_card_matches_cpu(cuda):
    """The small CoAtNet's training forward and one train step (params,
    BN state, momentum, loss) on the card against the CPU within 1e-4, f32
    with TF32 off."""
    from tfnas_tpu_torch.parallel import train_dp
    net, params, bn = _coatnet_net()
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4, 64, 64, 3), generator=g)
    y = torch.randint(0, 10, (4,), generator=g)
    keep = net.draw_keep(4, torch.Generator().manual_seed(6))
    outs = []
    for dev in ("cpu", cuda):
        p, s = _to(params, dev), _to(bn, dev)
        fwd, _ = net.apply(p, s, x.to(dev), training=True,
                           keep=_to(keep, dev))
        train, _ = train_dp.make_eval_steps(net, num_classes=10,
                                            compute_dtype=torch.float32,
                                            capture=False)
        nst, m = train(train_dp.EvalTrainState(
            p, s, tree_map(torch.zeros_like, p), 0), x.to(dev), y.to(dev),
            0.1, _to(keep, dev))
        outs.append([t.cpu() for t in [fwd, m["loss"]]
                     + tree_leaves(nst.params) + tree_leaves(nst.bn_state)
                     + tree_leaves(nst.momentum)])
    for c, k in zip(*outs):
        torch.testing.assert_close(k, c, rtol=1e-4, atol=1e-4)


def test_graphed_train_step_runs_a_short_batch_eagerly(deterministic):
    """A batch shorter than the captured one runs the eager step, and the
    next full batch replays the graph from that eager step's result:
    every step still equals the eager step bit for bit, and the counters
    read the full batches as replays and the short ones as eager calls."""
    net, params, bn, _, _ = _eval_net()
    step = _graphed_against_eager(deterministic, net, params, bn,
                                  [8, 8, 5, 8, 5, 8], 32, torch.float32)
    assert (step.replays, step.eager_calls) == (4, 2)
    assert step.graphed.replays == 4


def test_step_path_never_syncs(cuda):
    """One eager warmup, weight and arch step with their draws, after a
    first call has filled the first-use caches, under
    torch.cuda.set_sync_debug_mode('error'): no .item(), no pageable copy,
    nothing that waits for the card."""
    from tfnas_tpu_torch.search.train_step import make_search_steps
    net, st, data = _tiny_state(cuda, seed=5)
    steps = make_search_steps(net, num_classes=10, lambda_lat=0.1,
                              target_lat=0.02)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for kind in ("warmup", "weight", "arch"):
        st.update(_step(steps, kind, st, *data[0], gen)[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for kind in ("warmup", "weight", "arch"):
            st.update(_step(steps, kind, st, *data[1], gen)[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_epoch_boundaries_rewrite_graph_buffers(deterministic):
    """The driver loop (train_search.Search) over three epochs of the tiny
    space, captured and eager from the same seed: a warmup epoch and two
    search epochs, the second on the masks, latency vector, lr and T the
    first epoch's end wrote into the graphs' buffers, with the optimiser
    state zeroed in place. Both runs agree after every epoch, and the
    captured one rebinds none of the buffers its graphs read."""
    import numpy as np
    from tfnas_tpu_torch import train_search as ts
    from tfnas_tpu_torch.cost.lut import build_space_analytic_lut
    from tfnas_tpu_torch.search.compiled import GraphFamily, leaves_of
    dev = deterministic
    space = tss.tiny_space(32)
    lut = build_space_analytic_lut(space)
    g = torch.Generator().manual_seed(8)
    batches = [[(torch.randn((4, 32, 32, 3), generator=g).to(dev),
                 torch.randint(0, 10, (4,), generator=g).to(dev))
                for _ in range(5)] for _ in range(3)]
    arch_b = [(torch.randn((4, 32, 32, 3), generator=g).to(dev),
               torch.randint(0, 10, (4,), generator=g).to(dev))
              for _ in range(2)]
    kw = dict(num_classes=10, lambda_lat=0.5, target_lat=0.02)
    results = {}
    for mode in ("eager", "captured"):
        net = SuperNetwork(10, space=space)
        params, arch = net.init(torch.Generator().manual_seed(2))
        fam = GraphFamily(dev) if mode == "captured" else None
        search = ts.Search(net, space, lut, _to(params, dev), _to(arch, dev),
                           space.build_mc_mask_dddict(), dev,
                           step_kwargs=kw, family=fam, scan_units=2)
        draws = ts.GeneratorDraws(torch.Generator(device=dev).manual_seed(4))
        T, held, per_epoch = 5.0, None, []
        for epoch in range(3):
            search.begin_epoch(0.025 * (1 - epoch / 3), T)
            if mode == "captured" and held is None:
                held = [id(t) for t in leaves_of(
                    [search.masks, search.update_masks, search.lat_vec,
                     search.mom, search.opt_a, search.lr, search.T])]
            search.train_epoch(batches[epoch], lambda: iter(arch_b), draws,
                               epoch == 0, lambda x: x)
            if epoch:
                T *= 0.96
                search.end_epoch(0.015)
            per_epoch.append((_to(search.params, "cpu"),
                              _to(search.arch_params, "cpu"),
                              {s: {b: {o: np.asarray(m).copy()
                                       for o, m in d.items()}
                                   for b, d in sd.items()}
                               for s, sd in search.mc_mask_dddict.items()}))
        if mode == "captured":
            assert held == [id(t) for t in leaves_of(
                [search.masks, search.update_masks, search.lat_vec,
                 search.mom, search.opt_a, search.lr, search.T])]
            assert [g.name for g in fam.graphs] == [
                "warmup_step", "weight_step", "arch_step"]
        results[mode] = per_epoch
    for (pe, ae, me), (pc, ac, mc) in zip(results["eager"],
                                          results["captured"]):
        _assert_trees_equal(pc, pe)
        _assert_trees_equal(ac, ae)
        for s in me:
            for b in me[s]:
                for o in me[s][b]:
                    assert np.array_equal(me[s][b][o], mc[s][b][o])


def test_latency_chain_on_card(cuda):
    """The chain is one CUDA graph: its time per call is positive and at
    least the empty chain's, and each call still feeds the next."""
    from tfnas_tpu_torch.cost.measure import Chain, measure_latency_in_ms
    x = torch.ones(8, device=cuda)
    chain = Chain(lambda v: v * 1e30, (x,), iters=4)
    assert chain.graph is not None
    chain.run()
    torch.cuda.synchronize()
    assert chain.x[0].item() == pytest.approx(4.0)
    w = torch.randn(512, 512, device=cuda)
    ms = measure_latency_in_ms(lambda w, v: v @ w, (w, torch.randn(
        256, 512, device=cuda)), warmup=5, iters=20)
    empty = measure_latency_in_ms(lambda v: v, (x,), warmup=5, iters=20)
    assert 0 < empty <= ms


# -- the hybrid conv/ViT space -------------------------------------------------

def _hybrid_draws(la, valid, gen):
    """Masked weight-step draws with the ViT candidate picked at
    stage5/block1 (gumbel) and stage6/block1 (partner)."""
    from tfnas_tpu_torch.search.bisample import (sample_gumbel_indices,
                                                 sample_random_excluding)
    ig = sample_gumbel_indices(la, gen, valid)
    ig[13], ig[17] = 8, 0
    ir = sample_random_excluding(ig, 9, gen, valid)
    ir[17] = 8
    return ig, ir


def test_hybrid_steps_on_card_match_cpu(cuda):
    """One warmup, weight and arch step of the full-width hybrid supernet
    (64^2, batch 2, f32, TF32 off) on the card against the CPU with the
    same draws, ViT picks included: 1e-4."""
    from tfnas_tpu_torch.models import hybrid_space as hs
    from tfnas_tpu_torch.models.supernet_hybrid import HybridSuperNetwork
    from tfnas_tpu_torch.search.train_step import (adam_init,
                                                   make_search_steps)
    net = HybridSuperNetwork(10)
    params, arch = net.init(torch.Generator().manual_seed(0))
    mc = hs.build_mc_mask_dddict()
    valid = net.valid_mask("cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 64, 64, 3), generator=g)
    y = torch.randint(0, 10, (2,), generator=g)
    ig, ir = _hybrid_draws(arch["log_alphas"], valid, g)
    u = torch.rand((18, 9), generator=g).clamp_min(1e-6)
    lat = torch.rand((18, 9), generator=g) * 0.01 * valid
    outs = []
    for dev in ("cpu", cuda):
        steps = make_search_steps(net, num_classes=10, lambda_lat=0.1,
                                  target_lat=0.02,
                                  valid_mask=valid.to(dev))
        p, a = _to(params, dev), _to(arch, dev)
        masks = net.device_masks(mc, dev)
        um = net.update_masks(p, mc)
        mom = tree_map(torch.zeros_like, p)
        before = dict(tfused.launches)
        p1, m1, _ = steps.warmup_step(p, a, mom, masks, um, x.to(dev),
                                      y.to(dev), 0.025, ig.to(dev))
        p2, m2, _ = steps.weight_step(p1, a, m1, masks, um, x.to(dev),
                                      y.to(dev), 0.025, ig.to(dev),
                                      ir.to(dev))
        a3, opt, ma = steps.arch_step(p2, a, adam_init(a), masks, x.to(dev),
                                      y.to(dev), lat.to(dev), 0.004, 5.0,
                                      u.to(dev))
        launched = {s: tfused.launches[s] - before[s] for s in before}
        assert launched == ({1: 0, 2: 0} if dev == "cpu"
                            else {1: 14 * 4, 2: 4 * 4})
        outs.append([t.cpu() for t in tree_leaves(p2) + tree_leaves(m2)
                     + tree_leaves(a3) + [ma["loss_a"], ma["lat"]]])
    for c, k in zip(*outs):
        torch.testing.assert_close(k, c, rtol=1e-4, atol=1e-4)


def test_hybrid_captured_matches_eager_across_a_vit_rewrite(deterministic):
    """The driver loop over the full-width hybrid space (64^2, batch 2),
    captured and eager from the same seed: a warmup epoch, a search epoch
    whose end parses ViT picks and rewrites their MLP masks, and a search
    epoch on the rewritten masks written into the graphs' buffers. Both
    runs agree after every epoch, and a ViT mask changed."""
    import numpy as np
    from tfnas_tpu_torch import train_search as ts
    from tfnas_tpu_torch.make_lat_lut import build_analytic_lut
    from tfnas_tpu_torch.models import hybrid_space as hs
    from tfnas_tpu_torch.models.supernet_hybrid import HybridSuperNetwork
    from tfnas_tpu_torch.search.compiled import GraphFamily
    dev = deterministic
    lut = build_analytic_lut(space="hybrid")
    g = torch.Generator().manual_seed(8)
    batches = [[(torch.randn((2, 64, 64, 3), generator=g).to(dev),
                 torch.randint(0, 10, (2,), generator=g).to(dev))
                for _ in range(2)] for _ in range(3)]
    arch_b = [(torch.randn((2, 64, 64, 3), generator=g).to(dev),
               torch.randint(0, 10, (2,), generator=g).to(dev))]
    results = {}
    for mode in ("eager", "captured"):
        net = HybridSuperNetwork(10)
        params, arch = net.init(torch.Generator().manual_seed(2))
        arch["log_alphas"][9:, 8] += 2.0  # the parse picks the ViT blocks
        valid = net.valid_mask(dev)
        kw = dict(num_classes=10, lambda_lat=0.1, target_lat=0.5,
                  valid_mask=valid)
        fam = GraphFamily(dev) if mode == "captured" else None
        search = ts.Search(net, hs, lut, _to(params, dev), _to(arch, dev),
                           hs.build_mc_mask_dddict(), dev, step_kwargs=kw,
                           family=fam)
        draws = ts.GeneratorDraws(torch.Generator(device=dev).manual_seed(4),
                                  valid)
        per_epoch = []
        for epoch in range(3):
            search.begin_epoch(0.025, 5.0)
            search.train_epoch(batches[epoch], lambda: iter(arch_b), draws,
                               epoch == 0, lambda x: x)
            if epoch:
                search.end_epoch(0.5)
            per_epoch.append((_to(search.params, "cpu"),
                              _to(search.arch_params, "cpu"),
                              {s: {b: np.asarray(d[8]).copy()
                                   for b, d in sd.items() if 8 in d}
                               for s, sd in search.mc_mask_dddict.items()}))
        results[mode] = per_epoch
    first = hs.build_mc_mask_dddict()
    assert any(not np.array_equal(m, first[s][b][8])
               for s, d in results["eager"][1][2].items()
               for b, m in d.items())
    for (pe, ae, me), (pc, ac, mc) in zip(results["eager"],
                                          results["captured"]):
        _assert_trees_equal(pc, pe)
        _assert_trees_equal(ac, ae)
        for s in me:
            for b in me[s]:
                assert np.array_equal(me[s][b], mc[s][b])


def _pareto_inputs(net, dev, seed=0):
    """The state and step inputs of G = 2 tiny-space groups on `dev`."""
    from tfnas_tpu_torch.parallel import pareto
    from tfnas_tpu_torch.search.train_step import adam_init, zeros_like_tree
    mc = net.ss.build_mc_mask_dddict()
    inits = [net.init(torch.Generator().manual_seed(seed + g))
             for g in range(2)]
    params = [_to(p, dev) for p, _ in inits]
    arch = [_to(a, dev) for _, a in inits]
    st = pareto.ParetoSearchState(params, arch,
                                  [zeros_like_tree(p) for p in params],
                                  [adam_init(a) for a in arch])
    g = torch.Generator().manual_seed(seed + 7)
    return {"state": st,
            "masks": [net.device_masks(mc, dev) for _ in range(2)],
            "umasks": [net.update_masks(p, mc) for p in st.params],
            "lat": [(torch.rand((3, 8), generator=g) * 0.01).to(dev)
                    for _ in range(2)],
            "x": torch.randn((2, 4, 32, 32, 3), generator=g).to(dev),
            "y": torch.randint(0, 10, (2, 4), generator=g).to(dev),
            "ig": [torch.randint(0, 8, (3,), generator=g).to(dev)
                   for _ in range(2)],
            "u": [torch.rand((3, 8), generator=g).clamp_min(1e-6).to(dev)
                  for _ in range(2)]}


def _pareto_pair(steps, inp):
    """One Pareto weight step and one arch step of the groups: the leaves
    of the new state and metrics, on the CPU."""
    from tfnas_tpu_torch.search.compiled import leaves_of
    weight, arch = steps
    d = [(ig, (ig + 1) % 8) for ig in inp["ig"]]
    st, wm = weight(inp["state"], inp["masks"], inp["umasks"], inp["x"],
                    inp["y"], 0.025, d)
    st, am = arch(st, inp["masks"], inp["x"], inp["y"], inp["lat"], 0.004,
                  [5.0, 4.0], inp["u"])
    return [t.cpu() for t in leaves_of([st, wm, am])]


def test_pareto_steps_on_card_match_cpu(cuda):
    """A Pareto weight and arch step of G = 2 tiny-space groups (targets
    0.02 and 0.03 ms) on the card against the CPU: 1e-4, f32, TF32 off."""
    from tfnas_tpu_torch.parallel import pareto
    from tfnas_tpu_torch.parallel.mesh import make_mesh
    net = SuperNetwork(10, space=tss.tiny_space(32))
    steps = pareto.make_pareto_search_steps(
        net, make_mesh(1, 2, 0), num_classes=10, targets=[0.02, 0.03])
    before = sum(tfused.launches.values())
    outs = [_pareto_pair(steps, _pareto_inputs(net, dev))
            for dev in ("cpu", cuda)]
    assert sum(tfused.launches.values()) - before == 2 * (6 + 3)
    for c, k in zip(*outs):
        torch.testing.assert_close(k, c, rtol=1e-4, atol=1e-4)


def _nccl_checks(dev, world):
    from tfnas_tpu_torch.parallel import pareto, train_dp
    from tfnas_tpu_torch.parallel.mesh import ParetoMesh
    from tfnas_tpu_torch.search.compiled import GraphedFn, GraphFamily
    enet, *rest = _eval_net()
    params, bn, x, y = _to(rest, dev)
    keep = enet.draw_keep(len(y), torch.Generator(device=dev).manual_seed(2))
    out = {}
    for name, group in (("none", None), ("nccl", world)):
        gc.collect()  # the last turn's graph (see the cuda fixture)
        train, _ = train_dp.make_eval_steps(
            enet, num_classes=10, compute_dtype=torch.float32, group=group,
            capture=False)
        graphed = GraphedFn(GraphFamily(dev), train, {0: 0}, name)
        for mode, fn in (("eager", train), ("captured", graphed)):
            st = train_dp.EvalTrainState(
                params, bn, tree_map(torch.zeros_like, params), 0)
            new, m = fn(st, x, y, 0.1, keep)
            out[(name, mode)] = _to([new[:3], m], "cpu")
    for mode in ("eager", "captured"):
        _assert_trees_equal(out[("nccl", mode)], out[("none", mode)])

    for mode in ("eager", "captured"):
        res = {}
        for name, mesh in (("none", ParetoMesh(1, (0,), None, 0, 1)),
                           ("nccl", ParetoMesh(1, (0,), world, 0, 1))):
            gc.collect()
            net = SuperNetwork(10, space=tss.tiny_space(32),
                               bn_group=mesh.data_group)
            fam = GraphFamily(dev) if mode == "captured" else None
            steps = pareto.make_pareto_search_steps(
                net, mesh, num_classes=10, targets=[0.02],
                capture=fam is not None, family=fam)
            inp = _pareto_inputs(net, dev)
            inp = {k: v[:1] if isinstance(v, list) else v
                   for k, v in inp.items()}
            inp["state"] = pareto.ParetoSearchState(
                *(f[:1] for f in inp["state"]))
            res[name] = _pareto_pair(steps, inp)
        _assert_trees_equal(res["nccl"], res["none"])


def test_one_rank_nccl_group_matches_no_group(deterministic):
    """A 1-rank NCCL process group: the eval train step and the Pareto
    steps with the group (cross-replica BN and the gradient all-reduce,
    inside the CUDA graphs when captured) equal the same steps without a
    group, bit for bit, eager and captured. The group is left once the
    graphs holding its collectives are freed (a failure leaves it)."""
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    _nccl_checks(deterministic, dist.group.WORLD)
    gc.collect()
    dist.destroy_process_group()


# -- the opt-in lowerings -----------------------------------------------------

def _cloned(tree):
    from tfnas_tpu_torch.search.compiled import _flatten, _unflatten
    leaves = []
    spec = _flatten(tree, leaves)
    return _unflatten(spec, iter([t.clone() for t in leaves]))


def test_remat_captured_equals_eager_and_no_remat(deterministic):
    """remat_blocks: the captured warmup, weight and arch steps equal the
    same net's eager steps and the captured steps without remat, bit for
    bit. The backward recomputes every block's forward, so each graph
    holds twice the fused kernel nodes at each stride."""
    from tfnas_tpu_torch.search.compiled import GraphFamily
    from tfnas_tpu_torch.search.train_step import make_search_steps
    dev = deterministic
    kw = dict(num_classes=10, lambda_lat=0.1, target_lat=0.02)
    runs, nodes = {}, {}
    for name, remat, capture in (("eager", True, False),
                                 ("captured", True, True),
                                 ("no_remat", False, True)):
        net, st, data = _tiny_state(dev, remat_blocks=remat)
        fam = GraphFamily(dev) if capture else None
        steps = make_search_steps(net, capture=capture, family=fam, **kw)
        if fam is not None:
            st = fam.adopt(st)
        outs = []
        for i, kind in enumerate(("warmup", "weight", "arch")):
            x, y = data[i]
            got, m = _step(steps, kind, st, x, y,
                           torch.Generator(device=dev).manual_seed(i))
            outs.append(_cloned({"state": got, "metrics": m}))
            st.update(got)
        runs[name] = outs
        if fam is not None:
            nodes[name] = {g.name: g.nodes for g in fam.graphs}
    for other in ("eager", "no_remat"):
        for a, b in zip(runs["captured"], runs[other]):
            _assert_trees_equal(a, b)
    for graph, by_stride in nodes["no_remat"].items():
        assert all(by_stride.values())
        assert nodes["captured"][graph] == {
            s: 2 * n for s, n in by_stride.items()}


@pytest.mark.parametrize("flags", [dict(project_einsum=False),
                                   dict(dw_kernel_split=True),
                                   dict(dw_kernel_split=True,
                                        project_einsum=False)])
def test_soft_lowerings_on_card_match_cpu(cuda, flags):
    """The grouped project and the k3/k5 depthwise split: one arch step of
    the tiny supernet on the card against the CPU (1e-4, f32, TF32 off);
    with the split the soft blocks launch no fused kernel."""
    from tfnas_tpu_torch.search.train_step import (adam_init,
                                                   make_search_steps)
    net = SuperNetwork(10, space=tss.tiny_space(32), **flags)
    params, arch = net.init(torch.Generator().manual_seed(0))
    mc = net.ss.build_mc_mask_dddict()
    g = torch.Generator().manual_seed(1)
    x = torch.randn((4, 32, 32, 3), generator=g)
    y = torch.randint(0, 10, (4,), generator=g)
    u = torch.rand((3, 8), generator=g).clamp_min(1e-6)
    lat = torch.rand((3, 8), generator=g) * 0.01
    steps = make_search_steps(net, num_classes=10, lambda_lat=0.1,
                              target_lat=0.02)
    outs = []
    for dev in ("cpu", cuda):
        p, a = _to(params, dev), _to(arch, dev)
        before = sum(tfused.launches.values())
        a1, opt, m = steps.arch_step(p, a, adam_init(a),
                                     net.device_masks(mc, dev), x.to(dev),
                                     y.to(dev), lat.to(dev), 0.004, 5.0,
                                     u.to(dev))
        launched = sum(tfused.launches.values()) - before
        assert launched == (3 if dev != "cpu" and not net.dw_kernel_split
                            else 0)
        outs.append([t.cpu() for t in tree_leaves(a1) + tree_leaves(opt.mu)
                     + [m["loss_a"]]])
    for c, k in zip(*outs):
        torch.testing.assert_close(k, c, rtol=1e-4, atol=1e-4)


def test_multi_sampled_on_card_matches_two_sampled(cuda):
    """apply_multi_sampled on the card (one fused launch per block, over
    S * W channels) against two apply_sampled forwards on the card and
    against itself on the CPU: 1e-4 x max|logit|, f32, TF32 off."""
    net = SuperNetwork(10, space=tss.tiny_space(32))
    params, arch = net.init(torch.Generator().manual_seed(0))
    mc = net.ss.build_mc_mask_dddict()
    g = torch.Generator().manual_seed(1)
    x = torch.randn((4, 32, 32, 3), generator=g)
    idx = torch.stack([torch.arange(3) % 8, (torch.arange(3) + 3) % 8])
    got = {}
    for dev in ("cpu", cuda):
        p, a, m = _to(params, dev), _to(arch, dev), net.device_masks(mc, dev)
        before = sum(tfused.launches.values())
        got[str(dev)] = net.apply_multi_sampled(p, a, m, x.to(dev),
                                                idx.to(dev)).cpu()
        assert sum(tfused.launches.values()) - before == (
            0 if dev == "cpu" else 3)
        if dev != "cpu":
            two = [net.apply_sampled(p, a, m, x.to(dev), i.to(dev)).cpu()
                   for i in idx]
    tol = 1e-4 * got["cpu"].abs().max().item()
    for s in range(2):
        torch.testing.assert_close(got["cuda"][s], two[s], rtol=0, atol=tol)
    torch.testing.assert_close(got["cuda"], got["cpu"], rtol=0, atol=tol)


@pytest.mark.parametrize("c", [64, 256, 768, 3072])  # 4 * ic and 16 * ic
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_kernel_at_lowering_widths(cuda, stride, dtype, c):
    """The channel counts of cond_width_split's e3 picks (4 * ic: 64-768)
    and of apply_multi_sampled (16 * ic: 256-3072)."""
    _check_forward(_inputs(5, 2, 14, c, cuda, dtype), stride, "swish", dtype)


@pytest.mark.parametrize("n", [128, 256])  # the occupancy sweep's batches
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride,h,c", [(1, 56, 1152), (2, 112, 768)])
def test_kernel_at_large_batches(cuda, stride, h, c, dtype, n):
    """The largest site of each stride (the soft path at 48 * ic) at search
    batches 128 and 256: up to 2.5e9 input elements, past 32-bit
    indexing. Inputs are drawn on the card."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((n, h, h, c), generator=g, device=cuda).to(dtype)
    wk = torch.randn((5, 5, c), generator=g, device=cuda) * 0.1
    scale = torch.rand(c, generator=g, device=cuda) + 0.5
    offset = torch.randn(c, generator=g, device=cuda) * 0.1
    with torch.no_grad():
        _check_forward((x, wk, scale, offset), stride, "relu", dtype)


# -- the card image pipeline (runtime/card.py) ---------------------------------

def _card_jpeg(w, h, seed, **save):
    """PIL's JPEG of a smooth random image (PIL's default: baseline 4:2:0,
    quality 75)."""
    import io
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (max(2, h // 6), max(2, w // 6), 3),
                         np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
    if save.pop("gray", False):
        img = img.convert("L")
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **save)
    return buf.getvalue()


def _unequal(got, want):
    """(max |diff| in levels, share of unequal values) of two uint8
    tensors."""
    d = (got.int() - want.int()).abs()
    return d.max().item(), (d > 0).float().mean().item()


_AUG_SHAPES = [(1, 1), (2, 3), (7, 5), (31, 17), (97, 45), (333, 211),
               (501, 389)]


@pytest.mark.parametrize("order", [[], [0], [1], [2], [3], [1, 3],
                                   [3, 2, 1, 0], [2, 0, 3, 1], [0, 1, 2, 3],
                                   [3, 1, 0, 2]])
def test_augment_kernel_matches_plain(cuda, order):
    """The augment kernel against its plain version on the card: source
    images from 1 x 1 to 501 x 389 (odd widths), interleaved and planar
    (the decode buffer's layouts), both flips, crop boxes from one pixel to
    the whole image, at 224 and 37, at 225 (spans not 16-byte aligned) and
    at 1024 (the plan sweeps and recomputes after contrast); uint8 within
    one level on at most 0.1% of the values (the plain contrast mean sums
    in another order); one launch per call."""
    import numpy as np
    from tfnas_tpu_torch.data.transforms import sample_rrc_box, sample_jitter
    from tfnas_tpu_torch.runtime import card
    rng = np.random.default_rng(len(order) * 10 + sum(order))
    images, boxes, flips, factors = [], [], [], []
    for i, (w, h) in enumerate(_AUG_SHAPES):
        pix = torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8))
        if i % 2:  # planar, as the hardware backend may write
            pix = pix.permute(2, 0, 1).contiguous().permute(1, 2, 0)
        images.append(pix.to(cuda))
        boxes.append(sample_rrc_box(w, h, rng) if i % 3 else (0, 0, w, h))
        flips.append(bool(i % 2))
        factors.append(sample_jitter(rng)[1])
    orders = [order] * len(images)
    for size in (224, 37, 225, 1024):
        before = dict(card.launches)
        got = card.augment_train(images, boxes, size, flips, orders, factors)
        torch.cuda.synchronize()
        assert card.launches["augment"] == before["augment"] + 1
        assert card.launches["augment_kernels"] == \
            before["augment_kernels"] + 1
        for i, img in enumerate(images):
            want = card.quantize_plain(card.augment_train_plain(
                img, boxes[i], size, flips[i], order, factors[i]))
            err, share = _unequal(got[i], want)
            assert err <= 1 and share <= 1e-3, (i, err, share)
        val = card.augment_val(images, size)
        for i, img in enumerate(images):
            want = card.quantize_plain(card.augment_val_plain(img, size))
            assert _unequal(val[i], want)[0] == 0
        again = card.augment_train(images, boxes, size, flips, orders,
                                   factors)
        assert torch.equal(again, got)  # the contrast mean: fixed order


def test_augment_kernel_two_launches_mixed_contrast(cuda):
    """300 images in one call (two launches of 256 and 44, one count),
    then 20 (the smaller parameter block), each batch mixing images with
    contrast (at any position) and without, sources up to 257 x 263 at
    64^2 and 225^2: within one level of the plain version on at most 0.1%
    of the values, val equal, a rerun bit-identical."""
    import numpy as np
    from tfnas_tpu_torch.data.transforms import sample_rrc_box, sample_jitter
    from tfnas_tpu_torch.runtime import card
    rng = np.random.default_rng(300)
    for n, size in ((300, 64), (20, 225)):
        images, boxes, flips, orders, factors = [], [], [], [], []
        for i in range(n):
            w, h = int(rng.integers(1, 258)), int(rng.integers(1, 264))
            pix = torch.from_numpy(rng.integers(0, 256, (h, w, 3), np.uint8))
            if i % 2:
                pix = pix.permute(2, 0, 1).contiguous().permute(1, 2, 0)
            images.append(pix.to(cuda))
            boxes.append(sample_rrc_box(w, h, rng))
            flips.append(bool(i % 3 == 1))
            order, facs = sample_jitter(rng)
            if i % 3 == 0:
                order = [op for op in order if op != 1]
            orders.append(order)
            factors.append(facs)
        before = dict(card.launches)
        got = card.augment_train(images, boxes, size, flips, orders, factors)
        torch.cuda.synchronize()
        assert card.launches["augment"] == before["augment"] + 1
        assert card.launches["augment_kernels"] == \
            before["augment_kernels"] + -(-n // card.LAUNCH_IMAGES)
        for i, img in enumerate(images):
            want = card.quantize_plain(card.augment_train_plain(
                img, boxes[i], size, flips[i], orders[i], factors[i]))
            err, share = _unequal(got[i], want)
            assert err <= 1 and share <= 1e-3, (n, i, err, share)
        val = card.augment_val(images, size)
        for i, img in enumerate(images):
            want = card.quantize_plain(card.augment_val_plain(img, size))
            assert _unequal(val[i], want)[0] == 0, (n, i)
        assert torch.equal(card.augment_train(images, boxes, size, flips,
                                              orders, factors), got)


def test_nvjpeg_against_pil(cuda, capsys):
    """nvJPEG's pixels against PIL's (libjpeg) on JPEGs written by PIL:
    baseline 4:2:0 and 4:4:4 and grayscale, through the hardware backend
    where it takes them, and progressive through the default backend. The
    decoders' IDCT and chroma upsampling differ, so pixels differ by a few
    levels at edges; the gap per file is printed."""
    import io
    import numpy as np
    from PIL import Image
    from tfnas_tpu_torch.runtime import card
    files = {"420": _card_jpeg(203, 157, 1),
             "444": _card_jpeg(160, 99, 2, subsampling=0, quality=90),
             "gray": _card_jpeg(91, 120, 3, gray=True),
             "progressive": _card_jpeg(250, 171, 4, progressive=True)}
    images, backends = card.decode_batch(list(files.values()), cuda)
    hardware = card.info["hardware"]
    gaps = {}
    for (name, data), img, backend in zip(files.items(), images, backends):
        ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert img is not None and tuple(img.shape) == ref.shape, name
        d = np.abs(img.cpu().numpy().astype(int) - ref.astype(int))
        gaps[name] = (d.mean(), d.max())
        print(f"nvjpeg vs pil {name}: {backend}, mean {d.mean():.3f} max "
              f"{d.max()}", flush=True)
        if name == "progressive" or not hardware:
            assert backend == "default", name
        elif name != "gray":
            assert backend == "hardware", name
    assert all(mean <= 2.0 for mean, _ in gaps.values()), gaps


def test_nvjpeg_refuses_what_it_cannot_decode(cuda):
    """A PNG and a truncated JPEG take the status path; the good entry
    beside them decodes."""
    import io
    import numpy as np
    from PIL import Image
    from tfnas_tpu_torch.runtime import card
    good = _card_jpeg(64, 48, 5)
    png = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(png, format="PNG")
    images, backends = card.decode_batch(
        [png.getvalue(), good[:len(good) // 2], good, b"\xff\xd8"], cuda)
    assert backends[0] == backends[1] == backends[3] == "refused"
    assert images[0] is None and images[1] is None
    assert backends[2] in ("hardware", "default")
    assert tuple(images[2].shape) == (48, 64, 3)


def _card_list(root):
    """Eight entries: baseline JPEGs, a progressive one and a PNG."""
    import numpy as np
    from PIL import Image
    lines = []
    for i in range(8):
        w, h = 60 + 7 * i, 80 - 3 * i
        if i == 5:
            Image.fromarray(np.full((h, w, 3), 40 * i, np.uint8)).save(
                root / f"{i}.png")
            lines.append(f"{i}.png {i % 3}")
            continue
        (root / f"{i}.jpg").write_bytes(
            _card_jpeg(w, h, i, progressive=i == 2))
        lines.append(f"{i}.jpg {i % 3}")
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    return str(root), str(root / "list.txt")


def test_imagelist_on_card(cuda, tmp_path):
    """ImageList for the card decodes on it: card uint8 batches, the PNG
    through PIL and the same kernel (counted), the progressive file through
    the default backend; the DataLoader and the prefetcher carry the card
    batches; a val batch of the PNG equals the plain val transform of its
    pixels."""
    import numpy as np
    from tfnas_tpu_torch.data import (DataLoader, DevicePrefetcher,
                                      ImageList, image_decoder)
    from tfnas_tpu_torch.runtime import card
    root, lst = _card_list(tmp_path)
    assert card.available() and card.build_error is None
    assert image_decoder(cuda).startswith("nvjpeg (")
    train = ImageList(root, lst, True, image_size=32, device=cuda)
    assert train.decoder == "card"
    x, y = train.get_batch(list(range(8)), np.random.default_rng(0))
    assert x.is_cuda and x.dtype == torch.uint8 and x.shape == (8, 32, 32, 3)
    assert y.tolist() == [i % 3 for i in range(8)]
    assert train.decoded["pil"] == 1 and sum(train.decoded.values()) == 8
    assert train.decoded["default"] >= 1
    val = ImageList(root, lst, False, image_size=32, device=cuda)
    xv, _ = val.get_batch([5, 0], None)
    png = torch.full((80 - 15, 60 + 35, 3), 200, dtype=torch.uint8)
    want = card.quantize_plain(card.augment_val_plain(png, 32))
    assert torch.equal(xv[0].cpu(), want)
    dl = DataLoader(train, 4, shuffle=True, num_workers=2, seed=1)
    out = list(DevicePrefetcher(dl, cuda))
    assert len(out) == 2
    for xb, yb in out:
        assert xb.is_cuda and yb.is_cuda and yb.dtype == torch.int64
        assert xb.shape == (4, 32, 32, 3)


def test_imagelist_on_card_raises_when_the_library_fails(cuda, tmp_path,
                                                         monkeypatch):
    """No silent PIL on the card: a card pipeline that does not build
    (a broken source) raises when the list is made, with nvcc's error."""
    from tfnas_tpu_torch.data import ImageList
    from tfnas_tpu_torch.runtime import card
    root, lst = _card_list(tmp_path)
    broken = tmp_path / "image_decode.cu"
    broken.write_text("this is not CUDA\n")
    monkeypatch.setattr(card, "_SOURCE", broken)
    monkeypatch.setattr(card, "_lib", None)
    monkeypatch.setattr(card, "build_error", None)
    monkeypatch.setattr(card, "info", None)
    with pytest.raises(RuntimeError, match="nvcc failed on image_decode.cu"):
        ImageList(root, lst, True, image_size=32, device=cuda)
    assert "nvcc failed" in card.build_error
    with pytest.raises(RuntimeError, match="nvcc failed"):  # fails fast
        ImageList(root, lst, False, image_size=32, device=cuda)


# -- the port's spans (utils/trace.py) ----------------------------------------

@pytest.fixture
def tracing():
    from tfnas_tpu_torch.utils import trace
    trace.reset()
    trace.enable()
    yield trace
    trace.disable()
    trace.reset()


def test_graphed_fn_spans(cuda, tracing):
    """A GraphedFn's first call holds its capture (whose time is build_s
    and adds to the process's capture total); every call is
    tfnas.graph.call around its args and replay, each with the graph's
    name as its id."""
    from tfnas_tpu_torch.search import compiled
    trace = tracing
    fam = compiled.GraphFamily(cuda)
    fn = compiled.GraphedFn(fam, lambda x: (x * 2 + 1,), {}, "double")
    before = dict(compiled.captures)
    x = torch.arange(8.0, device=cuda)
    for _ in range(3):
        out = fn(x)[0]
    torch.cuda.synchronize()
    assert torch.equal(out, x * 2 + 1)
    snap = trace.snapshot()
    names = [s["name"] for s in snap["spans"]]
    assert names.count("tfnas.graph.capture") == 1
    assert names.count("tfnas.graph.call") == 3
    assert names.count("tfnas.graph.args") == 3
    assert names.count("tfnas.graph.replay") == 3
    for s in snap["spans"]:
        assert s["ids"] == {"graph": "double"}
        assert s["parent"] == (None if s["name"] == "tfnas.graph.call"
                               else "tfnas.graph.call")
    (cap,) = snap["host_ms"]["tfnas.graph.capture"]
    assert fn.build_s == pytest.approx(cap / 1e3)
    assert compiled.captures["count"] == before["count"] + 1
    assert compiled.captures["seconds"] == pytest.approx(
        before["seconds"] + fn.build_s)
    assert snap["device_ms"] == {}   # host spans only


def test_device_span_records_no_event_under_capture(cuda, tracing):
    trace = tracing
    x = torch.ones(1024, device=cuda)
    with trace.span("tfnas.test.eager", device=True) as eager:
        y = x * 3
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        with trace.span("tfnas.test.captured", device=True) as captured:
            z = y + 1
    graph.replay()
    torch.cuda.synchronize()
    assert captured.events is None and eager.events is not None
    assert torch.equal(z, torch.full_like(x, 4.0))
    snap = trace.snapshot()
    assert list(snap["device_ms"]) == ["tfnas.test.eager"]
    assert snap["device_ms"]["tfnas.test.eager"][0] >= 0


def test_train_step_spans_in_the_profiled_trace(cuda, tracing, tmp_path):
    """One eager train step under torch.profiler, inside a benchmark-style
    range: the tfnas.train.* ranges lie in the Chrome trace inside it, in
    order, each with a device time, and their device times add up to the
    step's (events around the step)."""
    import json
    from torch.profiler import ProfilerActivity, profile, record_function
    from tfnas_tpu_torch.parallel import train_dp
    trace = tracing
    net, params, state, x, y = _eval_net()
    p, s = _to(params, cuda), _to(state, cuda)
    train, _ = train_dp.make_eval_steps(net, num_classes=10,
                                        compute_dtype=torch.float32,
                                        capture=False)
    st = train_dp.EvalTrainState(p, s, tree_map(torch.zeros_like, p), 0)
    keep = _to(net.draw_keep(8, torch.Generator().manual_seed(2)), cuda)
    x, y = x.to(cuda), y.to(cuda)
    st, _ = train(st, x, y, 0.1, keep)  # warm-up
    torch.cuda.synchronize()
    trace.reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        with record_function("bench.train_step"):
            st, _ = train(st, x, y, 0.1, keep)
        end.record()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") in ("user_annotation", "cpu_op")
              and "dur" in e]
    (outer,) = [e for e in events if e["name"] == "bench.train_step"]
    phases = sorted((e for e in events
                     if e["name"].startswith("tfnas.train.")),
                    key=lambda e: e["ts"])
    assert [e["name"] for e in phases] == [
        "tfnas.train.forward", "tfnas.train.backward", "tfnas.train.update"]
    for e in phases:
        assert outer["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    dev = trace.snapshot()["device_ms"]
    assert sorted(dev) == sorted(e["name"] for e in phases)
    total = sum(v[0] for v in dev.values())
    assert total == pytest.approx(start.elapsed_time(end), rel=0.2)
