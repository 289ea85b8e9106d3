"""Feature Pyramid Networks (``tpudet.models.fpn``; Lin et al.).

``FPN``: 1x1 laterals of c2..c5, a nearest x2 top-down path cropped to each
lateral and added, 3x3 SAME output convs -> p2..p5, and p6 as the stride-2
1x1 max-pool of p5 (every other cell, ``ceil(side / 2)`` cells).
``RetinaNetFPN`` (arXiv:1708.02002 §4): the same top-down path over c3..c5
-> p3..p5, p6 a stride-2 3x3 SAME conv on c5 and p7 one on ``relu(p6)``.
All levels are ``channels`` wide.

Tensors are NCHW in channels-last memory format, as in the backbone, so
``p.permute(0, 2, 3, 1)`` of p2..p5 is a contiguous NHWC map. Module names
follow the Flax scopes (``lateral_c2``, ``output_p2``, ...).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.models.layers import Conv

INPUTS = ("c2", "c3", "c4", "c5")


class FPN(nn.Module):
    def __init__(self, in_channels: Dict[str, int], channels: int = 256,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.channels = channels
        for name in INPUTS:
            self.add_module(f"lateral_{name}",
                            Conv(in_channels[name], channels, 1, dtype=dtype,
                                 device=device))
        for level in range(2, 6):
            self.add_module(f"output_p{level}",
                            Conv(channels, channels, 3, dtype=dtype,
                                 device=device))

    def forward(self, feats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``{"c2".."c5"}`` -> ``{"p2".."p6"}``."""
        merged = [getattr(self, f"lateral_{n}")(feats[n]) for n in INPUTS]
        for i in range(2, -1, -1):
            th, tw = merged[i].shape[2:]
            # Nearest x2 is a repeat of each cell (and keeps channels-last).
            up = F.interpolate(merged[i + 1], scale_factor=2.0,
                               mode="nearest")[:, :, :th, :tw]
            merged[i] = merged[i] + up
        outs = {f"p{i + 2}": getattr(self, f"output_p{i + 2}")(m)
                for i, m in enumerate(merged)}
        outs["p6"] = outs["p5"][:, :, ::2, ::2]
        return outs


class RetinaNetFPN(nn.Module):
    """P3..P7 of RetinaNet and FCOS. Module names follow the Flax scopes
    (``lateral_c3``, ``output_p3``, ``p6_conv``, ``p7_conv``)."""

    def __init__(self, in_channels: Dict[str, int], channels: int = 256,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.channels = channels
        for name in INPUTS[1:]:
            self.add_module(f"lateral_{name}",
                            Conv(in_channels[name], channels, 1, dtype=dtype,
                                 device=device))
        for level in range(3, 6):
            self.add_module(f"output_p{level}",
                            Conv(channels, channels, 3, dtype=dtype,
                                 device=device))
        self.p6_conv = Conv(in_channels["c5"], channels, 3, 2, dtype=dtype,
                            device=device)
        self.p7_conv = Conv(channels, channels, 3, 2, dtype=dtype,
                            device=device)

    def forward(self, feats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``{"c3".."c5"}`` -> ``{"p3".."p7"}``."""
        merged = [getattr(self, f"lateral_{n}")(feats[n]) for n in INPUTS[1:]]
        for i in range(1, -1, -1):
            th, tw = merged[i].shape[2:]
            up = F.interpolate(merged[i + 1], scale_factor=2.0,
                               mode="nearest")[:, :, :th, :tw]
            merged[i] = merged[i] + up
        outs = {f"p{i + 3}": getattr(self, f"output_p{i + 3}")(m)
                for i, m in enumerate(merged)}
        outs["p6"] = self.p6_conv(feats["c5"])
        outs["p7"] = self.p7_conv(F.relu(outs["p6"]))
        return outs
