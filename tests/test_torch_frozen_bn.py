"""The fused frozen batch norm, residual and ReLU (``kernels/frozen_bn.py``)
on the CPU: its plain path against the layers one by one, the ResNet
blocks that route through it against their module-by-module forward, and
the operators' fake bodies. The kernels themselves are held against the
plain ops on the card in ``tests/test_torch_cuda.py``."""

import pytest
import torch
import torch.nn.functional as F

from tpudet_torch.kernels import frozen_bn as kfb
from tpudet_torch.models.layers import FrozenBatchNorm, make_norm
from tpudet_torch.models.resnet import BasicBlock, Bottleneck, ResNet

DTYPES = [torch.float32, torch.bfloat16]
FORMS = ["plain", "identity", "projected"]


def drawn_norm(channels: int, gen: torch.Generator) -> FrozenBatchNorm:
    """A frozen norm far from the identity: w and b not trivial."""
    norm = FrozenBatchNorm(channels)
    norm.scale.copy_(0.25 + 2 * torch.rand(channels, generator=gen))
    norm.bias.copy_(torch.randn(channels, generator=gen))
    norm.mean.copy_(0.5 * torch.randn(channels, generator=gen))
    norm.var.copy_(0.05 + 3 * torch.rand(channels, generator=gen))
    return norm


def written_out(x, norm, residual=None, residual_norm=None):
    """``FrozenBatchNorm.forward``'s formula, the add and the ReLU, as the
    plain ops compute them in the map's dtype."""
    def affine(t, n):
        w = n.scale / torch.sqrt(n.var + n.epsilon)
        b = n.bias - n.mean * w
        return (t * w.to(t.dtype)[None, :, None, None]
                + b.to(t.dtype)[None, :, None, None])
    y = affine(x, norm)
    if residual is not None:
        y = y + (residual if residual_norm is None
                 else affine(residual, residual_norm))
    return F.relu(y)


def form_inputs(form, dtype, gen, shape=(2, 64, 5, 7)):
    x = torch.randn(*shape, generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last)
    norm = drawn_norm(shape[1], gen)
    residual = residual_norm = None
    if form != "plain":
        residual = torch.randn(*shape, generator=gen).to(dtype).contiguous(
            memory_format=torch.channels_last)
    if form == "projected":
        residual_norm = drawn_norm(shape[1], gen)
    return x, norm, residual, residual_norm


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
def test_frozen_bn_act_cpu_equals_the_layers(form, dtype):
    gen = torch.Generator().manual_seed(7)
    x, norm, r, rn = form_inputs(form, dtype, gen)
    xs = x.clone().requires_grad_()
    rs = None if r is None else r.clone().requires_grad_()
    got = kfb.frozen_bn_act(xs, norm, rs, rn)
    xw = x.clone().requires_grad_()
    rw = None if r is None else r.clone().requires_grad_()
    want = written_out(xw, norm, rw, rn)
    assert got.dtype == dtype and torch.equal(got, want)
    assert (want > 0).any() and (want == 0).any()
    cot = torch.randn(x.shape, generator=gen).to(dtype)
    leaves = [t for t in (xs, rs) if t is not None]
    refs = [t for t in (xw, rw) if t is not None]
    for g, w in zip(torch.autograd.grad(got, leaves, cot),
                    torch.autograd.grad(want, refs, cot)):
        assert torch.equal(g, w)


def module_by_module(block, x):
    """The blocks' forward as the layers one by one."""
    shortcut = (block.norm_proj(block.conv_proj(x)) if block.has_proj
                else x)
    if isinstance(block, Bottleneck):
        y = F.relu(block.norm1(block.conv1(x)))
        y = F.relu(block.norm2(block.conv2(y)))
        y = block.norm3(block.conv3(y))
    else:
        y = F.relu(block.norm1(block.conv1(x)))
        y = block.norm2(block.conv2(y))
    return F.relu(y + shortcut)


@pytest.mark.parametrize("kind,in_ch,channels,stride", [
    ("bottleneck", 64, 256, 1), ("bottleneck", 256, 256, 1),
    ("bottleneck", 256, 512, 2), ("basic", 64, 64, 1),
    ("basic", 64, 128, 2)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_block_equals_module_by_module(kind, in_ch, channels, stride, dtype):
    gen = torch.Generator().manual_seed(in_ch + channels + stride)
    cls = Bottleneck if kind == "bottleneck" else BasicBlock
    block = cls(in_ch, channels, stride, "frozen_bn", dtype)
    with torch.no_grad():
        for m in block.modules():
            if isinstance(m, FrozenBatchNorm):
                fresh = drawn_norm(m.scale.shape[0], gen)
                for name in ("scale", "bias", "mean", "var"):
                    getattr(m, name).copy_(getattr(fresh, name))
            elif hasattr(m, "weight") and m.weight is not None:
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               * m.weight[0].numel() ** -0.5)
    assert block.has_proj == (in_ch != channels or stride != 1)
    x = torch.randn(2, in_ch, 9, 11, generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last)
    xs, xw = x.clone().requires_grad_(), x.clone().requires_grad_()
    got, want = block(xs), module_by_module(block, xw)
    assert torch.equal(got, want)
    cot = torch.randn(want.shape, generator=gen).to(dtype)
    params = [p for p in block.parameters()]
    for g, w in zip(torch.autograd.grad(got, [xs, *params], cot),
                    torch.autograd.grad(want, [xw, *params], cot)):
        assert torch.equal(g, w)


def test_gn_blocks_keep_the_layers():
    """A GroupNorm block runs its layers, not the frozen norm's path."""
    block = Bottleneck(64, 256, 1, "gn", torch.float32)
    x = torch.randn(2, 64, 6, 6)
    assert torch.equal(block(x), module_by_module(block, x))
    assert not isinstance(make_norm("gn", 8), FrozenBatchNorm)


def test_resnet_stem_routes_through_the_fused_pass(monkeypatch):
    """The stem and every unit of a frozen-norm ResNet call the fused
    entry: 1 + 3 per bottleneck, 40 to c4 of ResNet-50."""
    import tpudet_torch.models.resnet as resnet

    calls = []

    def counted(*args):
        calls.append(len(args))
        return kfb.frozen_bn_act(*args)

    monkeypatch.setattr(resnet, "frozen_bn_act", counted)
    net = ResNet((3, 4, 6, 3), norm="frozen_bn")
    net(torch.zeros(1, 3, 64, 64).contiguous(
        memory_format=torch.channels_last), stop_at="c4")
    assert len(calls) == 1 + 3 * 13


META = "meta"


@pytest.mark.parametrize("form", FORMS)
def test_frozen_bn_act_off_the_card_runs_the_layers(form):
    """On a device other than CUDA or the CPU (here ``meta``) the entry
    runs the plain layers, as ``FrozenBatchNorm`` does, and so does a
    ResNet unit there."""
    gen = torch.Generator().manual_seed(4)
    x, norm, r, rn = form_inputs(form, torch.bfloat16, gen)
    to_meta = (lambda t: None if t is None else t.to(META))
    norm, rn = norm.to(META), None if rn is None else rn.to(META)
    out = kfb.frozen_bn_act(to_meta(x), norm, to_meta(r), rn)
    assert (out.device.type, out.shape, out.dtype) == (META, x.shape,
                                                       torch.bfloat16)
    block = Bottleneck(64, 256, 1, "frozen_bn", torch.float32, device=META)
    y = block(torch.empty(2, 64, 6, 6, device=META).contiguous(
        memory_format=torch.channels_last))
    assert (y.device.type, y.shape) == (META, (2, 256, 6, 6))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("fmt", [torch.channels_last, torch.contiguous_format])
def test_frozen_bn_fake_shapes(form, dtype, fmt):
    """voc_r50's c2 map at b=32 on 640x832: the outputs' shapes, dtypes
    and layouts. NCHW-contiguous too: torch.export's fake convolutions
    report that layout for maps that are channels-last on the card."""
    shape = (32, 256, 160, 208)
    x = torch.empty(shape, dtype=dtype, device=META).contiguous(
        memory_format=fmt)
    buffers = [torch.empty(256, device=META) for _ in range(4)]
    residual = None if form == "plain" else torch.empty_like(x)
    proj = buffers if form == "projected" else []
    out = kfb.frozen_bn_act_fwd(x, *buffers, 1e-5, residual, proj, 1e-5)
    assert (out.shape, out.dtype, out.stride()) == (x.shape, dtype,
                                                    x.stride())
    gx, g2 = kfb.frozen_bn_act_bwd(out, out, buffers[0], buffers[3], 1e-5,
                                   residual is not None,
                                   [proj[0], proj[3]] if proj else [], 1e-5)
    assert (gx.shape, gx.dtype, gx.stride()) == (x.shape, dtype, x.stride())
    if residual is None:
        assert g2.numel() == 0
    else:
        assert (g2.shape, g2.dtype, g2.stride()) == (x.shape, dtype,
                                                     x.stride())
