"""The port's fused depthwise kernel module (tfnas_tpu_torch.kernels.fused_dw).

On the CPU its wrapper runs the plain PyTorch version; that version and the
hand-written backward are held against the JAX kernel (Pallas, interpret
mode) and its jnp reference at f32, with tests/test_kernels.py's
tolerances: 2e-4 for y, 1e-3 for the sums and the four input gradients
(sums over the batch are taken in different orders). The CUDA kernel itself
runs only on the card: tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfnas_tpu.kernels import fused_dw as jfused
from tfnas_tpu_torch.kernels import fused_dw as tfused
from tfnas_tpu_torch.models import search_space as tss
from tfnas_tpu_torch.models.supernet import block_sites


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    orig = jfused.pl.pallas_call
    monkeypatch.setattr(jfused.pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _inputs(seed, n, h, c, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h, h, c)).astype(dtype),
            (rng.standard_normal((5, 5, c)) * 0.1).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32),
            (rng.standard_normal(c) * 0.1).astype(np.float32))


def _loss_t(out):
    y, s, q = out
    return (y.float() ** 2).sum() + s.sum() + q.sum() * 0.1


def _loss_j(out):
    y, s, q = out
    return jnp.sum(y.astype(jnp.float32) ** 2) + jnp.sum(s) + jnp.sum(q) * 0.1


@pytest.mark.parametrize("c", [128, 96])
@pytest.mark.parametrize("act", ["relu", "swish"])
@pytest.mark.parametrize("stride", [1, 2])
def test_plain_matches_jax(stride, act, c):
    x, w, scale, offset = _inputs(0, 2, 12, c)
    tin = [torch.from_numpy(a).requires_grad_() for a in (x, w, scale, offset)]
    out = tfused.fused_dw_norm_act(*tin, stride, act)
    _loss_t(out).backward()
    assert tfused.launches == {1: 0, 2: 0}  # CPU tensors never launch

    jin = [jnp.asarray(a) for a in (x, w, scale, offset)]
    for name, fn in (
            ("pallas", lambda *a: jfused.fused_dw_norm_act(*a, stride, act)),
            ("reference", lambda *a: jfused._reference(*a, stride=stride,
                                                       act=act))):
        want = fn(*jin)
        np.testing.assert_allclose(out[0].detach().numpy(),
                                   np.asarray(want[0]), rtol=2e-4, atol=2e-4,
                                   err_msg=name)
        for g, wv in zip(out[1:], want[1:]):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(wv),
                                       rtol=1e-3, err_msg=name)
        grads = jax.grad(lambda *a: _loss_j(fn(*a)), argnums=(0, 1, 2, 3))(
            *jin)
        for t, gv in zip(tin, grads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(gv),
                                       rtol=1e-3, atol=1e-3, err_msg=name)


def test_backward_matches_autograd_of_plain():
    """The hand-written backward equals autograd through the plain version,
    in f32 and in bf16 (where both round y and the taps at the same
    places)."""
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x, w, scale, offset = _inputs(1, 2, 10, 64)
        a = [torch.from_numpy(x).to(dtype)] + [torch.from_numpy(v)
                                                for v in (w, scale, offset)]
        a1 = [t.clone().requires_grad_() for t in a]
        a2 = [t.clone().requires_grad_() for t in a]
        _loss_t(tfused.fused_dw_norm_act(*a1, 2, "swish")).backward()
        _loss_t(tfused.fused_dw_plain(*a2, 2, "swish")).backward()
        for g1, g2 in zip(a1, a2):
            np.testing.assert_allclose(g1.grad.float().numpy(),
                                       g2.grad.float().numpy(), rtol=tol,
                                       atol=tol)


def test_fold_bn_mask_matches_jax():
    mean, var = np.array([1.0, 2.0], np.float32), np.array([4.0, 0.0],
                                                           np.float32)
    mask = np.array([1.0, 0.0], np.float32)
    got = tfused.fold_bn_mask(*(torch.from_numpy(v) for v in (mean, var,
                                                              mask)))
    want = jfused.fold_bn_mask(*(jnp.asarray(v) for v in (mean, var, mask)))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-6)


def _main_path_shapes():
    """(H, C, stride, act) of every depthwise site of the full search at
    224^2: the soft path's width 48 * ic and the sampled path's 8 * ic."""
    out = []
    for site in block_sites(tss):
        res = tss.BLOCK_INPUT_RES[site.stage][int(site.block[5:]) - 1]
        for c in (48 * site.ic, 8 * site.ic):
            out.append((res, c, site.stride, site.act))
    return sorted(set(out))


# ragged shapes the main path does not reach: (N, H, W, C, stride)
_EDGE_SHAPES = [(1, 1, 1, 30, 1), (3, 7, 13, 194, 2), (1, 13, 57, 200, 1),
                (3, 57, 7, 30, 2), (1, 57, 57, 194, 1), (3, 13, 13, 200, 2)]


@pytest.mark.parametrize(
    "n,h,w,c,stride,act",
    [(32, h, h, c, s, a) for h, c, s, a in _main_path_shapes()]
    + [(n, h, w, c, s, "swish") for n, h, w, c, s in _EDGE_SHAPES])
def test_work_list_covers_output(n, h, w, c, stride, act):
    """The kernel's work list (`plan`, `work_items`) covers every output
    pixel of every (image, channel) exactly once, in bf16 and f32; the
    partials have one row per block of a channel group; and the ring fits
    the SM as often as the plan says (csrc/fused_dw.cu)."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    for itemsize in (2, 4):
        p = tfused.plan(n, h, w, c, stride, itemsize, 132)
        assert p.cw in (1, 2, 4, 8)
        assert p.cb * p.cw == tfused.GROUP * tfused.WARPS
        assert p.sw == tfused.COLS * p.cw and (p.cw == 8 or p.sw >= wo)
        assert p.vec_bytes == (16 if c % (16 // itemsize) == 0
                               else 2 * itemsize)
        assert 1 <= p.bpg <= p.items
        assert p.blocks_per_sm * (p.smem + 1024) <= 228 * 1024
        assert p.groups * p.bpg <= max(p.groups, p.blocks_per_sm * 132)
        cover = np.zeros((p.groups, n, ho, wo), np.int32)
        rows = {}
        for block, (c0, c1), img, (y0, y1), (x0, x1) in tfused.work_items(
                p, n, h, w, stride):
            g, j = divmod(block, p.bpg)
            assert c0 == g * p.cb and c1 - c0 == p.cb
            assert y1 - y0 <= p.rs and x1 - x0 <= p.sw
            cover[g, img, y0:y1, x0:x1] += 1
            rows.setdefault(j, set()).add(g)
        assert (cover == 1).all()
        # partial row j holds every group's block j: one row per block
        assert sorted(rows) == list(range(p.bpg))
        assert all(gs == set(range(p.groups)) for gs in rows.values())
        assert p.groups * p.cb >= c > (p.groups - 1) * p.cb
    assert c % 2 == 0 and act in tfused._ACT_CODES


def test_wrapper_refuses_cpu_and_bad_input():
    x, w, scale, offset = (torch.from_numpy(a) for a in _inputs(2, 1, 8, 32))
    with pytest.raises(ValueError, match="CUDA"):
        tfused.fused_dw_cuda(x, w, scale, offset, 1, "relu")
    with pytest.raises(ValueError):
        tfused.fused_dw_forward(x.to("meta"), w, scale, offset, 1, "relu")
    assert tfused.launches == {1: 0, 2: 0}
