"""Device-side preprocess (``tpudet.data.preprocess.device_preprocess``).

Inference only: uint8 (or float) canvases -> ``(x - mean) / std`` in f32,
cast to bf16 when the backbone computes in bf16. The training flip and
colour jitter wait for the training slice (ROADMAP.md, Queue 1 item 5).
"""

from __future__ import annotations

from typing import Dict

import torch

from tpudet_torch.config import Config


def device_preprocess(cfg: Config, batch: Dict[str, torch.Tensor],
                      training: bool = False) -> Dict[str, torch.Tensor]:
    """Normalize ``batch["image"]`` (``[B, H, W, 3]``) on its device; the
    other entries pass through."""
    if training:
        raise NotImplementedError(
            "device_preprocess(training=True): the flip and colour jitter are "
            "not ported yet (ROADMAP.md, Queue 1 item 5)")
    d = cfg.data
    image = batch["image"].to(torch.float32)
    mean = torch.tensor(d.pixel_mean, dtype=torch.float32, device=image.device)
    std = torch.tensor(d.pixel_std, dtype=torch.float32, device=image.device)
    normalized = (image - mean) / std
    if cfg.backbone.dtype == "bfloat16":
        normalized = normalized.to(torch.bfloat16)
    out = dict(batch)
    out["image"] = normalized
    return out
