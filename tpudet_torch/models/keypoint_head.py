"""Keypoint R-CNN's keypoint head (``tpudet.models.keypoint_head``; He et
al., arXiv:1703.06870 §5, Detectron's keypoint_rcnn head): an FCN over each
RoI's pooled features predicting one heatmap per keypoint.

``num_convs`` 3x3 convolutions of ``channels`` with ReLU, a 4x4 stride-2
transposed convolution to the K keypoint channels (overlapping taps, "SAME"
padding), then a 2x bilinear upsample in f32: ``s x s`` pooled features
become ``4s x 4s`` heatmap logits (14 -> 56). MSRA (He) init on every
layer. The pooled features arrive NHWC ``[N, s, s, C]`` and the logits
leave NHWC ``[N, 4s, 4s, K]`` f32, the JAX package's layouts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.models.layers import Conv, ConvTranspose


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """``jax.image.resize(x, 2x, "bilinear")`` of an NCHW map: half-pixel
    centres, edges clamped; computed in f32 and returned in ``x``'s
    dtype."""
    return F.interpolate(x.float(), scale_factor=2, mode="bilinear",
                         align_corners=False).to(x.dtype)


class KeypointHead(nn.Module):
    def __init__(self, in_ch: int, num_keypoints: int, num_convs: int = 8,
                 channels: int = 512, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.num_convs = num_convs
        width = in_ch
        for i in range(num_convs):
            # variance_scaling(2, "fan_out", "normal") of a 3x3 conv.
            self.add_module(f"conv{i + 1}", Conv(
                width, channels, 3, dtype=dtype, device=device,
                init_std=(2.0 / (9 * channels)) ** 0.5))
            width = channels
        self.deconv = ConvTranspose(width, num_keypoints, 4, stride=2,
                                    dtype=dtype, device=device)

    def forward(self, rois: torch.Tensor) -> torch.Tensor:
        """``[N, s, s, C_feat]`` -> heatmap logits ``[N, 4s, 4s, K]`` f32."""
        x = rois.permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        logits = self.deconv(x).float()
        return upsample2x(logits).permute(0, 2, 3, 1)
