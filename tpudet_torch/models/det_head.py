"""Fast R-CNN detection head (``tpudet.models.det_head``; Fast R-CNN §2.1):
flattened RoI features -> two FC layers -> (C+1)-way class logits and
per-class box deltas. Class 0 is background.

The pooled features arrive NHWC ``[N, S, S, C]`` and flatten in that order,
the order of the Flax head, so ``fc1``'s weight is the transpose of the Flax
``[in, out]`` kernel with no row permutation.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.models.layers import Dense


class FastRCNNHead(nn.Module):
    def __init__(self, in_features: int, num_classes: int, fc_dim: int = 1024,
                 class_agnostic: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_box_classes = 1 if class_agnostic else num_classes
        self.fc1 = Dense(in_features, fc_dim, dtype=dtype, device=device)
        self.fc2 = Dense(fc_dim, fc_dim, dtype=dtype, device=device)
        self.cls = Dense(fc_dim, num_classes + 1, dtype=dtype, device=device,
                         init_std=0.01)
        self.bbox = Dense(fc_dim, 4 * self.num_box_classes, dtype=dtype,
                          device=device, init_std=0.001)

    def forward(self, rois: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[N, S, S, C]`` -> (cls_logits ``[N, C+1]`` f32, deltas
        ``[N, C_box, 4]`` f32)."""
        n = rois.shape[0]
        x = F.relu(self.fc1(rois.reshape(n, -1)))
        x = F.relu(self.fc2(x))
        cls_logits = self.cls(x).float()
        deltas = self.bbox(x).float().reshape(n, self.num_box_classes, 4)
        return cls_logits, deltas
