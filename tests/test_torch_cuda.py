"""The port on a CUDA card: the hand-written fused depthwise kernel against
its plain PyTorch version (on the current device and, with two cards, on
another), the supernet and one warmup, weight and arch step on the card
against the same on the CPU, the eval net's forward, train step and folds,
and the prefetcher. These tests skip without a card. They import no JAX,
so they run on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances: f32 with TF32 off, 2e-4 for y (summation order) and 1e-3 for
the sums; bf16, 2e-2 (one bf16 rounding of y, 2^-8 relative, either way);
the search steps and the eval forward on the card against the CPU 1e-4,
one eval train step and the folds 1e-5.
"""

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
