"""Mask R-CNN's mask head (``tpudet.models.mask_head``; He et al.,
arXiv:1703.06870 §3, Detectron's ``mask_rcnn_fcn_head_v1upXconvs``): an FCN
over each RoI's pooled features predicting one m x m mask logit map per
class.

``num_convs`` 3x3 convolutions of ``channels`` with ReLU, a 2x2 stride-2
transposed convolution with ReLU that doubles the size, and a 1x1
convolution to the per-class logits; MSRA (He) init on the tower, normal
(0.001) on the predictor. The tower computes in the configured dtype and
the logits come out f32. The pooled features arrive NHWC ``[N, s, s, C]``
and the logits leave NHWC ``[N, 2s, 2s, classes]``, the JAX package's
layouts; inside, the permuted views are NCHW in channels-last memory.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.models.layers import Conv, ConvTranspose


class MaskHead(nn.Module):
    def __init__(self, in_ch: int, num_classes: int, num_convs: int = 4,
                 channels: int = 256, dtype: torch.dtype = torch.float32,
                 device=None):
        """``num_classes``: foreground classes, 1 when class-agnostic."""
        super().__init__()
        self.num_convs = num_convs
        width = in_ch
        for i in range(num_convs):
            # variance_scaling(2, "fan_out", "normal") of a 3x3 conv.
            self.add_module(f"conv{i + 1}", Conv(
                width, channels, 3, dtype=dtype, device=device,
                init_std=(2.0 / (9 * channels)) ** 0.5))
            width = channels
        self.deconv = ConvTranspose(width, channels, 2, dtype=dtype,
                                    device=device)
        self.predict = Conv(channels, num_classes, 1, dtype=dtype,
                            device=device, init_std=0.001)

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        """``[N, s, s, C_feat]`` -> mask logits ``[N, 2s, 2s, classes]``
        f32."""
        x = rois.permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        x = F.relu(self.deconv(x))
        return self.predict(x).float().permute(0, 2, 3, 1)
