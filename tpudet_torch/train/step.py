"""Inference step (``tpudet.train.step.make_eval_step``).

JAX's step is a jitted ``(variables, batch) -> detections``. Here the
weights live in the model, so the step is ``batch -> detections``; it moves
the batch to the model's device and runs under ``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from tpudet_torch.config import Config
from tpudet_torch.data.preprocess import device_preprocess


def make_eval_step(model, cfg: Config, fused_preprocess: bool = True
                   ) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """``batch`` (``image [B, H, W, 3]`` uint8 or normalized, ``image_hw
    [B, 2]``; tensors or arrays) -> the detection dict of ``predict``."""

    @torch.inference_mode()
    def eval_fn(batch):
        batch = {k: torch.as_tensor(v).to(model.device, non_blocking=True)
                 for k, v in batch.items()}
        if fused_preprocess:
            batch = device_preprocess(cfg, batch, training=False)
        return model.predict(batch)

    return eval_fn
