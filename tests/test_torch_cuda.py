"""The port on a CUDA card: the hand-written fused depthwise kernel against
its plain PyTorch version, and the supernet on the card against the same
supernet on the CPU. These tests skip without a card. They import no JAX,
so they run on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances: f32 with TF32 off, 2e-4 for y (summation order) and 1e-3 for
the sums; bf16, 2e-2 (one bf16 rounding of y, 2^-8 relative, either way).
"""

import pytest
import torch

from tfnas_tpu_torch.kernels import fused_dw as tfused
from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.models.supernet import SuperNetwork


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
