"""RPN head (``tpudet.models.rpn_head``; Faster R-CNN §3.1): a shared 3x3
conv, then 1x1 objectness logits (A per cell) and 1x1 box deltas (4A per
cell).

Outputs keep the JAX package's layout: ``[B, H*W*A]`` / ``[B, H*W*A, 4]``
in (y, x, a) row-major order, the order of ``ops.anchors.generate_anchors_np``.
The NCHW (channels-last) conv outputs are permuted to NHWC before the
flatten, so the order matches.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.models.layers import Conv


class RPNHead(nn.Module):
    def __init__(self, in_ch: int, num_anchors: int, conv_channels: int = 512,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv = Conv(in_ch, conv_channels, 3, dtype=dtype, device=device)
        self.objectness = Conv(conv_channels, num_anchors, 1, dtype=dtype,
                               device=device, init_std=0.01)
        self.deltas = Conv(conv_channels, 4 * num_anchors, 1, dtype=dtype,
                           device=device, init_std=0.01)

    def forward(self, feat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """NCHW ``[B, C, H, W]`` -> (logits ``[B, H*W*A]`` f32, deltas
        ``[B, H*W*A, 4]`` f32)."""
        x = F.relu(self.conv(feat))
        b = feat.shape[0]
        logits = self.objectness(x).permute(0, 2, 3, 1).reshape(b, -1)
        deltas = self.deltas(x).permute(0, 2, 3, 1).reshape(b, -1, 4)
        return logits.float(), deltas.float()
