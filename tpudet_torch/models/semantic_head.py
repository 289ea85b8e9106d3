"""Panoptic FPN's semantic head (``tpudet.models.semantic_head``; Kirillov
et al., arXiv:1901.02446 §3): p2..p5 each pass through (1, 1, 2, 3) stages
of a 3x3 convolution, GroupNorm and ReLU, the coarser levels upsampled 2x
(bilinear) after each stage, all summed at 1/4 scale, then a 1x1
convolution to the semantic class logits.

Each level's map is cropped to p2's shape before the sum (ceil-grid strides
can leave one extra cell). The tower computes in the configured dtype (the
upsample in f32, rounded back) and the logits come out f32, NHWC ``[B,
H/4, W/4, classes]``. Module names follow the Flax scopes (``p2_conv0``,
``p4_gn1``, ``predict``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.models.keypoint_head import upsample2x
from tpudet_torch.models.layers import Conv, GroupNorm

# FPN level -> its 2x upsamples to reach p2's scale.
LEVELS = (("p2", 0), ("p3", 1), ("p4", 2), ("p5", 3))


class SemanticHead(nn.Module):
    def __init__(self, in_ch: int, num_classes: int, channels: int = 128,
                 dtype: torch.dtype = torch.float32, device=None):
        """``num_classes``: stuff plus thing classes (label l > 0 is channel
        l - 1)."""
        super().__init__()
        for name, n_up in LEVELS:
            width = in_ch
            for j in range(max(n_up, 1)):
                self.add_module(f"{name}_conv{j}", Conv(
                    width, channels, 3, dtype=dtype, device=device))
                self.add_module(f"{name}_gn{j}", GroupNorm(channels,
                                                           device=device))
                width = channels
        self.predict = Conv(channels, num_classes, 1, dtype=dtype,
                            device=device, init_std=0.01)

    def forward(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        """``{"p2": [B, C, H/4, W/4], ..}`` -> logits ``[B, H/4, W/4,
        classes]`` f32."""
        h, w = feats["p2"].shape[2:]
        total = None
        for name, n_up in LEVELS:
            x = feats[name]
            for j in range(max(n_up, 1)):
                x = getattr(self, f"{name}_conv{j}")(x)
                x = F.relu(getattr(self, f"{name}_gn{j}")(x))
                if j < n_up:
                    x = upsample2x(x)
            x = x[:, :, :h, :w]
            total = x if total is None else total + x
        return self.predict(total).float().permute(0, 2, 3, 1)
