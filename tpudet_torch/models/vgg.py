"""VGG-16 backbone (``tpudet.models.vgg``; the original Faster R-CNN's,
arXiv:1506.01497 §3.2).

3x3 SAME convs with biases and no norm layers, a 2x2 VALID max-pool before
stages 2-5. The pyramid contract is the ResNet one: c2 = conv3_3 (stride
4), c3 = conv4_3 (stride 8), c4 = conv5_3 (stride 16), c5 = pool5 (stride
32, read by FPN only). ``freeze_stem`` detaches the output of stage 2, so
conv1 and conv2 get no gradient (Fast R-CNN §4.5).

Tensors are NCHW in channels-last memory, as in ``models.resnet``. Module
names follow the Flax tree (``stage3.conv3_1``, ...).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.models.layers import Conv, run_block

# (3x3 convs, channels) per stage; a max-pool precedes stages 2-5.
VGG16_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


class _VGGStage(nn.Module):
    def __init__(self, in_ch: int, n_convs: int, channels: int, stage: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.names = [f"conv{stage}_{i + 1}" for i in range(n_convs)]
        for name in self.names:
            self.add_module(name, Conv(in_ch, channels, 3, dtype=dtype,
                                       device=device))
            in_ch = channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.names:
            x = F.relu(getattr(self, name)(x))
        return x


class VGG(nn.Module):
    """VGG-16 to the c2..c5 pyramid (see the module docstring); ``remat``
    recomputes each stage in the backward pass."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 freeze_stem: bool = True, device=None, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.freeze_stem = freeze_stem
        self.remat = remat
        in_ch = 3
        for stage, (n, ch) in enumerate(VGG16_STAGES, start=1):
            self.add_module(f"stage{stage}",
                            _VGGStage(in_ch, n, ch, stage, dtype, device))
            in_ch = ch
        self.channels = {"c2": 256, "c3": 512, "c4": 512, "c5": 512}

    def forward(self, x: torch.Tensor,
                stop_at: str = "c5") -> Dict[str, torch.Tensor]:
        """NCHW (channels-last) image -> {"c2": .., up to ``stop_at``}."""
        x = x.to(self.dtype)
        feats = {}
        for stage in range(1, len(VGG16_STAGES) + 1):
            if stage > 1:
                x = F.max_pool2d(x, 2, 2)
            x = run_block(getattr(self, f"stage{stage}"), x, self.remat)
            if stage == 2 and self.freeze_stem:
                x = x.detach()
            if stage >= 3:
                feats[f"c{stage - 1}"] = x
                if f"c{stage - 1}" == stop_at:
                    return feats
        feats["c5"] = F.max_pool2d(x, 2, 2)
        return feats
