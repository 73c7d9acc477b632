"""The fused epilogue `out = act(x * gate + bias) + residual`
(kernels/bias_act.py) on the CPU, where `bias_act` runs its plain version.

The plain version against the op chain the layers ran before it (the gate's
multiply, the broadcast bias add, the activation and the residual add, each
an op of its own) in f32, to 1e-6, for every activation, with and without
a gate and a residual, on channels_last maps and on [N, C] rows; in bf16,
the one rounding of its f32 result. The rule of where the layers use it: a
site whose input or weights need a gradient keeps PyTorch's ops (no
bias_act call, the same output) and the counters stay at 0 on the CPU. The
BN-folded forward of a TF-NAS-A-class net (with and without the
space-to-depth stem) and of a small CoAtNet against the unfolded eval
forward, in f32 to 1e-5 as the folding tests hold it, with one bias_act
call at each epilogue site counted from the net's layers; with its
parameters cast to bf16, every site still takes bias_act. The card's
kernel is tested in tests/test_torch_cuda.py.

Torch runs on one thread here: the suite's workers share the machine.
"""

import json
import os

import pytest
import torch

from tfnas_tpu_torch.kernels import bias_act
from tfnas_tpu_torch.models import folding
from tfnas_tpu_torch.models.eval_net import EvalNetwork
from tfnas_tpu_torch.ops.activations import ACT_FNS, apply_act
from tfnas_tpu_torch.ops.layers import (ConvLayer, MBConvPreNorm,
                                        MBInvertedResBlock)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACTS = [None, *ACT_FNS]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(seed, layout, gate, residual, n=3, c=24):
    g = torch.Generator().manual_seed(seed)
    shape = (n, c, 5, 7) if layout == "channels_last" else (n, c)

    def draw(*size):
        t = torch.randn(size, generator=g) * 3.0
        return (t.contiguous(memory_format=torch.channels_last)
                if t.dim() == 4 else t)

    x, b = draw(*shape), torch.randn(c, generator=g)
    s = torch.rand((n, c), generator=g) if gate else None
    r = draw(*shape) if residual else None
    return x, b, s, r


def _chain(x, bias, act, gate, residual):
    """The op chain the layers run without bias_act, each op in x's
    dtype."""
    four = x.dim() == 4
    if gate is not None:
        x = x * (gate[:, :, None, None] if four else gate)
    x = x + (bias.to(x.dtype)[None, :, None, None] if four
             else bias.to(x.dtype))
    x = apply_act(x, act)
    return x if residual is None else x + residual


def test_act_codes_cover_every_activation():
    assert set(bias_act.ACT_CODES) == set(ACTS)


@pytest.mark.parametrize("layout", ["channels_last", "rows"])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_plain_matches_op_chain(act, gate, residual, layout):
    x, b, s, r = _operands(ACTS.index(act), layout, gate, residual)
    got = bias_act.bias_act(x, b, act, gate=s, residual=r)
    torch.testing.assert_close(got, _chain(x, b, act, s, r), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("act", ACTS)
def test_plain_rounds_once_in_bf16(act):
    """bf16 operands give the f32 result of the same values, rounded
    once (a bf16 gate too)."""
    x, b, s, r = _operands(11, "channels_last", True, True)
    xb, sb, rb = x.bfloat16(), s.bfloat16(), r.bfloat16()
    got = bias_act.bias_act(xb, b, act, gate=sb, residual=rb)
    want = bias_act.bias_act(xb.float(), b, act, gate=sb.float(),
                             residual=rb.float()).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_fusable_needs_no_gradient_and_counts_nothing_on_the_cpu():
    bias_act.reset_counts()
    x, w = torch.zeros(2, 3), torch.zeros(3, requires_grad=True)
    assert bias_act.fusable([x, torch.zeros(3)])
    assert not bias_act.fusable([x, w], sites=4)
    assert not bias_act.fusable([x.requires_grad_(), torch.zeros(3)])
    with torch.no_grad():
        assert bias_act.fusable([x, w])
    assert set(bias_act.counts().values()) == {0}


def _draw_bn(params, state, g):
    """BN scale and bias around 1 and 0, running statistics around 0 and
    1, so that the fold moves every layer."""
    if "bn" in params and "scale" in params["bn"]:
        c = params["bn"]["scale"].shape
        params["bn"]["scale"] = 0.5 + torch.rand(c, generator=g)
        params["bn"]["bias"] = (torch.rand(c, generator=g) - 0.5) * 0.2
        state["bn"]["mean"] = torch.randn(c, generator=g) * 0.1
        state["bn"]["var"] = 0.5 + torch.rand(c, generator=g)
    for k, v in params.items():
        if k != "bn" and isinstance(v, dict):
            _draw_bn(v, state.setdefault(k, {}), g)


def _net(kind):
    """(net, params, state, x) of a TF-NAS-A-class net at 64^2 or a small
    CoAtNet (every MBConv kind: with and without a shortcut projection,
    downsampling and not, then relative-attention blocks) at 64^2."""
    if kind == "coatnet":
        from benchmark.reference import coatnet as rc
        cfg = rc.model_config((2, 2, 1, 2, 1), (16, 16, 32, 64, 64), 64, 10)
    else:
        with open(os.path.join(ROOT, "configs", "tfnas_a_tpu.config")) as f:
            cfg = json.load(f)
    net = EvalNetwork.from_config(10, cfg)
    params, state = net.init(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    _draw_bn(params, state, g)
    x = torch.randn((2, 64, 64, 3), generator=g)
    return net, params, state, x


def _folded(kind):
    net, params, state, x = _net(kind)
    fnet, fparams = folding.fold_batchnorm(net, params, state)
    if kind == "tfnas_a_s2d":
        fnet, fparams = folding.fold_stem_space_to_depth(fnet, fparams)
    return net, params, state, x, fnet, fparams


def _sites(net):
    """The epilogue sites of a BN-folded net, from its layers: each stem,
    feature-mix and classifier layer; in an MBConv block each 1x1 and
    depthwise convolution, and the SE's reduce, expand and gate."""
    n = 2 + (net.feature_mix_layer is not None)
    for b in [net.second_stem] + [b for _, _, b in net.iter_blocks()]:
        if isinstance(b, ConvLayer):
            n += 1
        elif isinstance(b, MBInvertedResBlock):
            n += b.has_expand + 2 + 3 * b.has_se
        elif isinstance(b, MBConvPreNorm):
            n += b.has_proj + 6
    return n


def _spy(monkeypatch):
    calls = []
    real = bias_act.bias_act

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)
    monkeypatch.setattr(bias_act, "bias_act", counted)
    return calls


KINDS = ["tfnas_a", "tfnas_a_s2d", "coatnet"]


@pytest.mark.parametrize("kind", KINDS)
def test_folded_forward_matches_unfolded(kind, monkeypatch):
    """One bias_act call at every epilogue site (89 in the TF-NAS-A-class
    net) and the folded forward within 1e-5 of the unfolded one."""
    net, params, state, x, fnet, fparams = _folded(kind)
    with torch.no_grad():
        want, _ = net.apply(params, state, x)
    calls = _spy(monkeypatch)
    got, _ = fnet.apply(fparams, {}, x)
    assert len(calls) == _sites(fnet)
    if kind.startswith("tfnas_a"):
        assert len(calls) == 89
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("needs_grad", ["input", "weights"])
@pytest.mark.parametrize("kind", KINDS)
def test_gradient_keeps_pytorch_ops(kind, needs_grad, monkeypatch):
    """A folded forward whose input or weights need a gradient calls
    bias_act nowhere, gives the fused forward's output to 1e-6 and a
    gradient, and counts nothing on the CPU."""
    _, _, _, x, fnet, fparams = _folded(kind)
    fused, _ = fnet.apply(fparams, {}, x)
    bias_act.reset_counts()
    calls = _spy(monkeypatch)
    leaf = x.clone().requires_grad_() if needs_grad == "input" else x
    if needs_grad == "weights":
        fparams["classifier"]["linear"]["kernel"].requires_grad_()
        fparams["first_stem"]["conv"]["kernel"].requires_grad_()
    got, _ = fnet.apply(fparams, {}, leaf)
    assert calls == [] and set(bias_act.counts().values()) == {0}
    torch.testing.assert_close(got, fused, rtol=1e-6, atol=1e-6)
    got.sum().backward()
    grad = (leaf.grad if needs_grad == "input"
            else fparams["classifier"]["linear"]["kernel"].grad)
    assert grad is not None and bool(torch.isfinite(grad).all())


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_parameters_take_every_epilogue(kind, monkeypatch):
    """The folded forward with its parameters cast to bf16, as a server
    holds them (cost/measure.py): every epilogue site takes bias_act with
    a bf16 bias, and the logits stay within bf16 rounding (2e-2 of the
    largest) of the forward whose biases are f32."""
    from tfnas_tpu_torch.search.train_step import tree_map
    _, _, _, x, fnet, fparams = _folded(kind)
    x = x.bfloat16()
    want, _ = fnet.apply(fparams, {}, x)
    p16 = tree_map(lambda t: t.to(torch.bfloat16), fparams)
    calls = _spy(monkeypatch)
    got, _ = fnet.apply(p16, {}, x)
    assert len(calls) == _sites(fnet)
    assert got.dtype == torch.bfloat16
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * scale
