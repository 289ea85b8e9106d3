"""ResNet backbones (``tpudet.models.resnet``): ResNet-18/34 of basic
blocks, ResNet-50/101 of bottlenecks, the tiny test backbone, and the
backbone factory (VGG-16 in ``models.vgg``).

Tensors are NCHW in ``torch.channels_last`` memory format, so every feature
map is also a contiguous NHWC view. Module names follow the Flax tree
(``stem_conv``, ``stage4_block2.conv1``, ``Conv_0``, ...) so a converted
variables tree loads by name (``models.import_weights``).

Convs compute in the backbone dtype over float32 parameters. The pyramid
stops at ``stop_at``: the single-level detector reads ``c4`` and never runs
the ``c5`` stage (its weights exist so that the parameter tree has the JAX
package's shape); the FPN detector reads c2..c5.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.kernels.frozen_bn import frozen_bn_act
from tpudet_torch.models.layers import Conv, make_norm, run_block
from tpudet_torch.models.vgg import VGG

STAGE_BLOCKS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
}
# Basic-block (3x3 -> 3x3) variants; the rest are bottlenecks.
BASIC_BLOCK = {"resnet18", "resnet34"}
LEVELS = ("c2", "c3", "c4", "c5")


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """``[N, C, H, W]`` -> ``[N, b*b*C, H/b, W/b]`` with the channels in the
    JAX package's NHWC order: channel ``(a * b + c) * C + k`` holds input
    channel ``k`` at row ``a`` and column ``c`` of each block."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // block, block, w // block, block)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, block * block * c,
                                               h // block, w // block)


def stem_kernel_to_s2d(weight: torch.Tensor) -> torch.Tensor:
    """The standard stem's ``[64, C, 7, 7]`` stride-2 weight -> the equal
    ``[64, 4 * C, 4, 4]`` stride-1 weight over the block-2 space-to-depth
    input (``tpudet.models.resnet.stem_kernel_to_s2d`` in OIHW): the 7x7
    taps padded to 8x8 on the top and left, so each tap ``u`` in [-4, 3]
    splits as ``2k + a - 4``, regrouped over the s2d channels ``(a, b, C)``."""
    o, c, kh, kw = weight.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"stem_kernel_to_s2d takes a 7x7 kernel, got "
                         f"{(kh, kw)}")
    pad = F.pad(weight, (1, 0, 1, 0))                     # [O, C, 8, 8]
    k4 = pad.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return k4.reshape(o, 4 * c, 4, 4)


def convert_params_to_s2d(state_dict: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """A state dict with a standard stem (any key ending in
    ``stem_conv.weight``) rewritten for ``s2d_stem=True``."""
    return {k: (stem_kernel_to_s2d(v) if k.endswith("stem_conv.weight")
                and v.shape[-1] == 7 else v)
            for k, v in state_dict.items()}


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with a projection shortcut on a shape
    change. ``stride_in_1x1=True`` strides the first 1x1 (Keras/caffe);
    False strides the 3x3 (torchvision "v1.5")."""

    def __init__(self, in_ch: int, channels: int, stride: int, norm: str,
                 dtype: torch.dtype, stride_in_1x1: bool = True, device=None):
        super().__init__()
        width = channels // 4
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.has_proj = in_ch != channels or stride != 1
        if self.has_proj:
            self.conv_proj = Conv(in_ch, channels, 1, stride, bias=False,
                                  dtype=dtype, device=device)
            self.norm_proj = make_norm(norm, channels, device)
        self.conv1 = Conv(in_ch, width, 1, s1, bias=False, dtype=dtype,
                          device=device)
        self.norm1 = make_norm(norm, width, device)
        # Flax pads this 3x3 explicitly with (1, 1), not "SAME".
        self.conv2 = Conv(width, width, 3, s3, padding=1, bias=False,
                          dtype=dtype, device=device)
        self.norm2 = make_norm(norm, width, device)
        self.conv3 = Conv(width, channels, 1, bias=False, dtype=dtype,
                          device=device)
        self.norm3 = make_norm(norm, channels, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.conv_proj(x) if self.has_proj else x
        y = frozen_bn_act(self.conv1(x), self.norm1)
        y = frozen_bn_act(self.conv2(y), self.norm2)
        return frozen_bn_act(self.conv3(y), self.norm3, shortcut,
                             self.norm_proj if self.has_proj else None)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block (ResNet-18/34) with a projection shortcut
    on a shape change. The stride sits on the first 3x3 in every
    convention: ``stride_in_1x1`` is accepted and ignored, as in the JAX
    package."""

    def __init__(self, in_ch: int, channels: int, stride: int, norm: str,
                 dtype: torch.dtype, stride_in_1x1: bool = True, device=None):
        super().__init__()
        del stride_in_1x1
        self.has_proj = in_ch != channels or stride != 1
        if self.has_proj:
            self.conv_proj = Conv(in_ch, channels, 1, stride, bias=False,
                                  dtype=dtype, device=device)
            self.norm_proj = make_norm(norm, channels, device)
        self.conv1 = Conv(in_ch, channels, 3, stride, padding=1, bias=False,
                          dtype=dtype, device=device)
        self.norm1 = make_norm(norm, channels, device)
        self.conv2 = Conv(channels, channels, 3, padding=1, bias=False,
                          dtype=dtype, device=device)
        self.norm2 = make_norm(norm, channels, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.conv_proj(x) if self.has_proj else x
        y = frozen_bn_act(self.conv1(x), self.norm1)
        return frozen_bn_act(self.conv2(y), self.norm2, shortcut,
                             self.norm_proj if self.has_proj else None)


class ResNet(nn.Module):
    """ResNet (``STAGE_BLOCKS``): 7x7/2 stem, 3x3/2 max-pool, stages c2..c5
    at strides 4..32, of bottleneck blocks (256..2048 wide) or with
    ``basic`` of basic blocks (64..512). ``freeze_stem`` detaches c2, so no
    gradient reaches the stem or stage c2. ``s2d_stem``: the stem is the
    equal 4x4/1 conv on 12 channels of the block-2 space-to-depth image,
    padded (2, 1) on each axis (``stem_kernel_to_s2d`` converts a standard
    stem). ``remat``: each block is recomputed in the backward pass."""

    def __init__(self, blocks: Sequence[int] = (3, 4, 6, 3),
                 norm: str = "frozen_bn", dtype: torch.dtype = torch.float32,
                 stride_in_1x1: bool = True, freeze_stem: bool = True,
                 device=None, basic: bool = False, s2d_stem: bool = False,
                 remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.blocks = tuple(blocks)
        self.freeze_stem = freeze_stem
        self.s2d_stem = s2d_stem
        self.remat = remat
        if s2d_stem:
            self.stem_conv = Conv(12, 64, 4, 1, padding=0, bias=False,
                                  dtype=dtype, device=device)
        else:
            self.stem_conv = Conv(3, 64, 7, 2, padding=3, bias=False,
                                  dtype=dtype, device=device)
        self.norm_stem = make_norm(norm, 64, device)
        in_ch = 64
        widths = (64, 128, 256, 512) if basic else (256, 512, 1024, 2048)
        block_cls = BasicBlock if basic else Bottleneck
        for stage, (n_blocks, ch) in enumerate(zip(self.blocks, widths)):
            for i in range(n_blocks):
                stride = 2 if (i == 0 and stage > 0) else 1
                self.add_module(
                    f"stage{stage + 2}_block{i}",
                    block_cls(in_ch, ch, stride, norm, dtype, stride_in_1x1,
                              device),
                )
                in_ch = ch
        self.channels = dict(zip(LEVELS, widths))

    def forward(self, x: torch.Tensor,
                stop_at: str = "c5") -> Dict[str, torch.Tensor]:
        """NCHW (channels-last) image -> {"c2": .., up to ``stop_at``}."""
        x = x.to(self.dtype)
        if self.s2d_stem:
            x = F.pad(space_to_depth(x), (2, 1, 2, 1)).contiguous(
                memory_format=torch.channels_last)
        x = frozen_bn_act(self.stem_conv(x), self.norm_stem)
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = {}
        for stage, n_blocks in enumerate(self.blocks):
            for i in range(n_blocks):
                x = run_block(getattr(self, f"stage{stage + 2}_block{i}"), x,
                              self.remat)
            if stage == 0 and self.freeze_stem:
                # No gradient into the stem and stage c2 (their
                # parameters get none; weight decay still moves them).
                x = x.detach()
            feats[LEVELS[stage]] = x
            if LEVELS[stage] == stop_at:
                break
        return feats


class TinyBackbone(nn.Module):
    """Five 3x3/2 SAME convs to stride 32, for the CPU tests. Flax names
    these layers automatically (``Conv_0``, ``AdaptiveGroupNorm_0``, ...);
    the port uses the same names."""

    def __init__(self, width: int = 32, norm: str = "gn",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.norm_kind = {"gn": "AdaptiveGroupNorm",
                          "frozen_bn": "FrozenBatchNorm"}[norm]
        in_ch = 3
        for i in range(5):
            self.add_module(f"Conv_{i}", Conv(in_ch, width, 3, 2, dtype=dtype,
                                              device=device))
            self.add_module(f"{self.norm_kind}_{i}",
                            make_norm(norm, width, device))
            in_ch = width
        self.channels = {name: width for name in LEVELS}

    def forward(self, x: torch.Tensor,
                stop_at: str = "c5") -> Dict[str, torch.Tensor]:
        x = x.to(self.dtype)
        feats = {}
        for i in range(5):
            conv = getattr(self, f"Conv_{i}")
            norm = getattr(self, f"{self.norm_kind}_{i}")
            x = frozen_bn_act(conv(x), norm)
            if i > 0:
                feats[LEVELS[i - 1]] = x
                if LEVELS[i - 1] == stop_at:
                    break
        return feats


def build_backbone(name: str, norm: str, dtype: torch.dtype,
                   stride_in_1x1: bool = True, device=None,
                   freeze_stem: bool = True, s2d_stem: bool = False,
                   remat: bool = False) -> nn.Module:
    """``freeze_stem`` stops the gradient after stage c2 of a ResNet and
    after stage 2 of VGG-16, as the JAX package does; the tiny backbone
    ignores it, as JAX's does, and ``s2d_stem`` and ``remat`` too. VGG has
    no norm layers and no stem variants: ``norm``, ``stride_in_1x1`` and
    ``s2d_stem`` do not apply to it. (The ViTs are built by
    ``models.vit.build_vit``.)"""
    if name == "tiny":
        return TinyBackbone(norm=norm, dtype=dtype, device=device)
    if name in STAGE_BLOCKS:
        return ResNet(STAGE_BLOCKS[name], norm=norm, dtype=dtype,
                      stride_in_1x1=stride_in_1x1, freeze_stem=freeze_stem,
                      device=device, basic=name in BASIC_BLOCK,
                      s2d_stem=s2d_stem, remat=remat)
    if name == "vgg16":
        return VGG(dtype=dtype, freeze_stem=freeze_stem, device=device,
                   remat=remat)
    raise ValueError(f"unknown backbone {name!r}")

