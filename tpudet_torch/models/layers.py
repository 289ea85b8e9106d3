"""Shared building blocks (``tpudet.models.layers``): convolution and dense
layers that compute in a given dtype over float32 parameters, Flax's
initializers, the two backbone normalizations, Flax's GroupNorm and
LayerNorm and Flax's dropout over an explicit generator.

Tensors are NCHW in ``torch.channels_last`` memory format inside the
backbone, so an NHWC view of any feature map is a free permute.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
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


class Dense(nn.Module):
    """Linear layer computing in ``dtype`` over an f32 ``[out, in]`` weight
    (Flax's ``nn.Dense`` kernel is ``[in, out]``: the weight is its
    transpose)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, device=None,
                 init_std: Optional[float] = None):
        super().__init__()
        self.dtype = dtype
        self.init_std = init_std
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
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


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
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax's ``nn.Dropout``: each entry kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``, the rest zeroed. The mask is drawn
    from ``generator`` (on ``x``'s device) alone; ``generator`` None is
    Flax's ``deterministic=True`` and returns ``x``."""
    if generator is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
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
