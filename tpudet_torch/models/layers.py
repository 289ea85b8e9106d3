"""Shared building blocks (``tpudet.models.layers``): convolution and dense
layers that compute in a given dtype over float32 parameters, Flax's
initializers, the two backbone normalizations, Flax's GroupNorm and
LayerNorm, Flax's dropout over an explicit generator, and the tensor-parallel
form of the Dense layers (``shard_model``).

Tensors are NCHW in ``torch.channels_last`` memory format inside the
backbone, so an NHWC view of any feature map is a free permute.

Tensor parallelism (Megatron-LM, Shoeybi et al., arXiv:1909.08053 §3): a
column-parallel Dense holds its rank's rows of the weight and bias (its
share of the output features) behind the operator **f** (identity forward,
all-reduce of the gradient over the model group backward); a row-parallel
Dense holds its rank's columns of the weight (its share of the input
features) and is followed by **g** (all-reduce forward, identity backward),
its replicated bias added once after the reduction; its partial products
are f32 sums of the dtype's operands, rounded to the dtype once after the
reduction, as the one-process product is. The attention modules
then compute their rank's heads only. Each operator is a
``torch.autograd.Function`` over ``dist.all_reduce`` alone, the one
collective that gloo supports on CUDA tensors besides ``broadcast``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

# Flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"),
# i.e. a normal truncated at +-2 std whose std is corrected for the cut.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    draw = torch.empty(weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    with torch.no_grad():
        weight.copy_(draw)


def normal_(weight: torch.Tensor, std: float,
            generator: torch.Generator) -> None:
    draw = torch.empty(weight.shape, dtype=torch.float32)
    nn.init.normal_(draw, 0.0, std, generator=generator)
    with torch.no_grad():
        weight.copy_(draw)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """Flax/TF "SAME" padding (low, high) of one spatial axis: the output
    has ``ceil(size / stride)`` cells and any odd pad goes to the high side
    (a 3x3 stride-2 conv on an even input pads (0, 1), not torch's (1, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """2-D convolution over NCHW input. ``weight`` is OIHW f32 and is cast
    to ``dtype`` at call time, as Flax's ``nn.Conv(dtype=...)`` computes in
    ``dtype`` over f32 params. ``padding`` is "SAME" (Flax's, which puts an
    odd pad on the high side) or a symmetric int. ``init_std`` None draws
    lecun-normal, else normal(init_std)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: Union[str, int] = "SAME", bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None,
                 init_std: Optional[float] = None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.init_std = init_std
        self.weight = nn.Parameter(
            torch.zeros(out_ch, in_ch, kernel, kernel, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_ch, device=device))
                     if bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        o, i, kh, kw = self.weight.shape
        if self.init_std is None:
            lecun_normal_(self.weight, i * kh * kw, generator)
        else:
            normal_(self.weight, self.init_std, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        pad = self.padding
        if pad == "SAME":
            k = w.shape[-1]
            ph = same_padding(x.shape[2], k, self.stride)
            pw = same_padding(x.shape[3], k, self.stride)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                pad = (ph[0], pw[0])
            else:
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
                pad = 0
        return F.conv2d(x, w, b, stride=self.stride, padding=pad)


class ConvTranspose(nn.Module):
    """Flax's ``nn.ConvTranspose`` with "SAME" padding over NCHW input:
    ``stride`` times the input (``stride`` defaults to ``kernel``, where the
    taps do not overlap). An overlapping kernel (the keypoint head's 4x4 at
    stride 2) is torch's transposed convolution at padding ``(kernel -
    stride) / 2``. ``weight`` is torch's ``[in, out, kh, kw]`` f32, cast to
    ``dtype`` at call time. Flax applies its ``(kh, kw, in, out)`` kernel
    unflipped (``transpose_kernel=False``), so the weight is that kernel
    flipped in both spatial axes (``import_weights`` converts it). Drawn
    from ``variance_scaling(2, "fan_out", "normal")``: std ``sqrt(2 / (kh *
    kw * out))``; ``lecun_init`` draws Flax's default lecun-normal over the
    fan-in ``kh * kw * in`` instead (the simple feature pyramid's)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, device=None,
                 lecun_init: bool = False):
        super().__init__()
        self.lecun_init = lecun_init
        self.stride = stride or kernel
        if kernel < self.stride or (kernel - self.stride) % 2:
            raise ValueError(f"ConvTranspose: kernel {kernel} at stride "
                             f"{self.stride} has no symmetric SAME padding")
        self.padding = (kernel - self.stride) // 2
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.zeros(in_ch, out_ch, kernel, kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        i, o, kh, kw = self.weight.shape
        if self.lecun_init:
            lecun_normal_(self.weight, kh * kw * i, generator)
        else:
            normal_(self.weight, math.sqrt(2.0 / (kh * kw * o)), generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype),
                                  self.bias.to(self.dtype), stride=self.stride,
                                  padding=self.padding)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward, the gradient summed over the
    model group backward (each rank's columns contribute a part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the sum of the ranks' partial outputs forward, the
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SplitToModel(torch.autograd.Function):
    """This rank's share of ``dim`` of a replicated tensor forward
    (``TensorParallel.shard``); backward, the whole gradient joined from
    the ranks' shares (``TensorParallel.join``), so the replicated layer
    that made the tensor gets its whole gradient on every rank."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return tp.shard(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.tp.join(grad.contiguous(), ctx.dim), None, None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A sharded model's place on the model axis: the layout it was cut by
    (``parallel.sharding_rules.tp_layout``), its model group, and this
    process's rank and the group's size."""

    layout: Dict[str, object]
    group: object
    rank: int
    size: int

    def mean_(self, x: torch.Tensor) -> torch.Tensor:
        """In place: the mean of ``x`` over the model group."""
        dist.all_reduce(x, group=self.group)
        return x.div_(self.size)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself; its gradient summed over the model group (f)."""
        return _CopyToModel.apply(x, self.group)

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's share of ``dim`` of the replicated ``x``
        (``_SplitToModel``)."""
        return _SplitToModel.apply(x, dim, self)

    def join(self, shard: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """The whole tensor of this rank's ``shard`` (cut on ``dim``; None
        returns it): each peer's shard in its place in zeros, summed over
        the model group. Every peer calls it, in the same order."""
        if dim is None:
            return shard
        step = shard.shape[dim]
        shape = list(shard.shape)
        shape[dim] = step * self.size
        whole = shard.new_zeros(shape)
        whole.narrow(dim, self.rank * step, step).copy_(shard)
        dist.all_reduce(whole, group=self.group)
        return whole

    def shard(self, whole: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's contiguous share of ``dim`` of ``whole`` (None
        returns it)."""
        if dim is None:
            return whole
        step = whole.shape[dim] // self.size
        return whole.narrow(dim, self.rank * step, step).contiguous()


class Dense(nn.Module):
    """Linear layer computing in ``dtype`` over an f32 ``[out, in]`` weight
    (Flax's ``nn.Dense`` kernel is ``[in, out]``: the weight is its
    transpose). ``shard_model`` makes it column- or row-parallel
    (``tp``: the kind and the model group)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 init_std: Optional[float] = None):
        super().__init__()
        self.dtype = dtype
        self.init_std = init_std
        self.tp: Optional[Tuple[str, object]] = None
        self.weight = nn.Parameter(
            torch.zeros(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.init_std is None:
            lecun_normal_(self.weight, self.weight.shape[1], generator)
        else:
            normal_(self.weight, self.init_std, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.tp is None:
            return F.linear(x, self.weight.to(self.dtype),
                            self.bias.to(self.dtype))
        kind, group = self.tp
        if kind == "column":
            return F.linear(_CopyToModel.apply(x, group),
                            self.weight.to(self.dtype),
                            self.bias.to(self.dtype))
        # Row-parallel: each rank's partial product kept in f32 (a bf16
        # partial would round before the reduction and lose the one
        # rounding of the one-process product), summed over the group,
        # then the bias, then one rounding.
        part = _linear_f32_out(x, self.weight.to(self.dtype))
        return (_ReduceFromModel.apply(part, group)
                + self.bias.float()).to(self.dtype)


class _MatmulF32Out(torch.autograd.Function):
    """``x @ w.T`` of 16-bit operands on the card as one tensor-core GEMM
    that accumulates in f32 and returns the f32 sums (``torch.mm``'s
    ``out_dtype``). Backward, the gradient (16-bit exact: it comes through
    the layer's rounding to its dtype) in the operands' dtype, and the two
    GEMMs of an ordinary 16-bit linear layer."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        out = torch.mm(x2, w.t(), out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g2 = grad.to(x.dtype).reshape(-1, w.shape[0])
        grad_x = torch.mm(g2, w).reshape(x.shape)
        grad_w = torch.mm(g2.t(), x.reshape(-1, x.shape[-1]))
        return grad_x, grad_w


def _linear_f32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` in f32 from operands of one dtype: on the card a 16-bit
    pair is one tensor-core GEMM with f32 output (``_MatmulF32Out``);
    elsewhere, and for f32 operands, an f32 GEMM of the widened operands
    (whose products are exact all the same)."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        return _MatmulF32Out.apply(x, w)
    return F.linear(x.float(), w.float())


def shard_model(model: nn.Module, layout: Dict[str, object],
                group) -> TensorParallel:
    """Cut ``model`` (a model or its ``core``) over the model ``group`` by
    ``layout`` (``parallel.sharding_rules.tp_layout``): each Dense whose
    weight the layout cuts keeps this rank's contiguous slice of its weight
    (and of a column-parallel bias) and becomes column- or row-parallel;
    each attention module whose value projection is column-parallel
    computes this rank's heads. Call it after the
    weights are drawn or loaded and before the optimizer and the EMA are
    made, which then hold shards too. Returns the ``TensorParallel``, also
    kept as ``core.tp``; every module with a ``shard_tp(tp)`` hook is handed
    it after the cut."""
    core = getattr(model, "core", model)
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    tp = TensorParallel(layout=layout, group=group, rank=rank, size=size)

    def cut(tensor: torch.Tensor, dim: int, name: str) -> nn.Parameter:
        if tensor.shape[dim] % size:
            raise ValueError(f"shard_model: {name} has {tensor.shape[dim]} "
                             f"rows on dim {dim}, not divisible by {size}")
        step = tensor.shape[dim] // size
        return nn.Parameter(tensor.detach().narrow(dim, rank * step, step)
                            .contiguous())

    for name, module in core.named_modules():
        if not isinstance(module, Dense):
            continue
        shard = layout[f"{name}.weight"]
        if shard.kind == "replicated":
            continue
        module.weight = cut(module.weight, shard.dim, f"{name}.weight")
        if layout[f"{name}.bias"].kind == "column":
            module.bias = cut(module.bias, 0, f"{name}.bias")
        module.tp = (shard.kind, group)
    for module in core.modules():
        if hasattr(module, "shard_tp"):
            module.shard_tp(tp)
    core.tp = tp
    return tp


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics and affine, as buffers:
    ``x * w + b`` with ``w = scale / sqrt(var + eps)``, ``b = bias - mean * w``
    computed in f32 and cast to the input's dtype (``layers.py:36-38`` of the
    JAX package). The identity at init."""

    def __init__(self, channels: int, epsilon: float = 1e-5, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.register_buffer("scale", torch.ones(channels, device=device))
        self.register_buffer("bias", torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        self.scale.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.scale / torch.sqrt(self.var + self.epsilon)
        b = self.bias - self.mean * w
        return x * w.to(x.dtype)[None, :, None, None] + b.to(x.dtype)[None, :, None, None]


class AdaptiveGroupNorm(nn.Module):
    """GroupNorm with ``gcd(32, C)`` groups and Flax's epsilon 1e-6 (torch's
    default is 1e-5). Statistics in f32, output in the input's dtype."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.groups = math.gcd(32, channels)
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.groups, self.scale, self.bias, eps=1e-6)
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """Flax's ``nn.GroupNorm(num_groups=min(32, C))``: epsilon 1e-6,
    statistics in f32, output in the input's dtype. Its parameters are
    ``weight`` and ``bias`` (Flax's ``scale`` and ``bias`` sit directly
    under the layer's scope, and ``import_weights`` renames such a
    ``scale``)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.groups = min(32, channels)
        if channels % self.groups:
            raise ValueError(f"GroupNorm: {channels} channels in "
                             f"{self.groups} groups")
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.groups, self.weight, self.bias,
                         eps=1e-6)
        return y.to(x.dtype)


class LayerNorm(nn.Module):
    """Flax's ``nn.LayerNorm`` over the last axis: epsilon 1e-6 (torch's
    default is 1e-5), statistics in f32 as ``E[x^2] - E[x]^2`` clamped at
    0, and an f32 output whatever the input dtype (Flax promotes to the f32
    parameters): a bf16 input comes out f32."""

    def __init__(self, features: int, epsilon: float = 1e-6, device=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        del generator
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        mean2 = (x * x).mean(dim=-1, keepdim=True)
        var = (mean2 - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        return (x - mean) * mul + self.bias


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            tp: Optional[TensorParallel] = None) -> torch.Tensor:
    """Flax's ``nn.Dropout``: each entry kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``, the rest zeroed. The mask is drawn
    from ``generator`` (on ``x``'s device) alone; ``generator`` None is
    Flax's ``deterministic=True`` and returns ``x``. With ``tp``, ``x`` is
    this rank's share of the last axis of a column-parallel output: the
    mask is drawn at the full width and cut to the rank's columns, so the
    model peers (whose generators are in one state) draw the one-process
    mask between them."""
    if generator is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    shape = x.shape if tp is None else x.shape[:-1] + (x.shape[-1] * tp.size,)
    keep = torch.rand(shape, generator=generator, device=x.device) < keep_prob
    if tp is not None:
        keep = keep.narrow(-1, tp.rank * x.shape[-1], x.shape[-1])
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def make_norm(kind: str, channels: int, device=None) -> nn.Module:
    if kind == "frozen_bn":
        return FrozenBatchNorm(channels, device=device)
    if kind == "gn":
        return AdaptiveGroupNorm(channels, device=device)
    raise ValueError(f"unknown norm: {kind!r} (use 'frozen_bn' or 'gn')")


def init_module(module: nn.Module, generator: torch.Generator) -> None:
    """Redraw every layer of ``module`` from ``generator``, in registration
    order."""
    for m in module.modules():
        if isinstance(m, (Conv, ConvTranspose, Dense, FrozenBatchNorm,
                          AdaptiveGroupNorm, GroupNorm, LayerNorm)):
            m.reset_parameters(generator)


def run_block(block: nn.Module, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """``block(x)``; with ``remat`` while autograd records, its activations
    are recomputed in the backward pass instead of kept
    (``torch.utils.checkpoint``, the JAX package's ``nn.remat``)."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(block, x, use_reentrant=False)
    return block(x)
