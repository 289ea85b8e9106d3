"""The one traffic generator: a mix's parameters (a ``traffic/<mix>.json``)
and the seed -> a pool of batches in the host's pinned memory, as a loader
would hand them to the program.

Every seed gives the same sizes: ``pool`` batches of ``batch`` uint8
canvases of the ``canvas`` bucket. The seed draws the content: noise
pixels inside each image's valid region (``valid_frac`` of the canvas on
each side; the padding is 0, as the loader pads), and for training
ground-truth boxes, each 0.1-0.5 of the region on a side, painted in its
class's colour, padded to ``max_gt_boxes``. The pool's counts of boxes
per image are one fixed set spread evenly over ``boxes_per_image``, which
the seed only shuffles over the images, so every seed gives the matcher
and the losses the same work. Pixels are drawn on the device in a few
large calls.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def stream(seed: int, tag: str) -> int:
    """A 63-bit seed for the part ``tag`` of a run, from the run's seed."""
    words = [int(seed) % 2 ** 64] + [ord(c) for c in tag]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0]) % 2 ** 63


def make_pool(traffic: dict, seed: int, device, max_gt_boxes: int = 100,
              num_classes: int = 1) -> List[Dict[str, torch.Tensor]]:
    """``traffic["pool"]`` batches: ``image [B, H, W, 3]`` uint8 and
    ``image_hw [B, 2]`` f32, and with ``boxes_per_image`` also
    ``gt_boxes [B, G, 4]`` (xyxy pixels), ``gt_classes [B, G]`` int32
    1..C and ``gt_valid [B, G]`` bool; on the host, pinned where the
    device is a card."""
    device = torch.device(device)
    n, b = traffic["pool"], traffic["batch"]
    h, w = traffic["canvas"]
    lo, hi = traffic["valid_frac"]
    gen = torch.Generator(device=device).manual_seed(stream(seed, "pixels"))
    image = torch.randint(0, 256, (n, b, h, w, 3), generator=gen,
                          device=device, dtype=torch.uint8)
    frac = torch.rand(n, b, 2, generator=gen, device=device) * (hi - lo) + lo
    hw = torch.floor(frac * torch.tensor([h, w], device=device,
                                         dtype=torch.float32))
    rows = torch.arange(h, device=device)[None, None, :, None]
    cols = torch.arange(w, device=device)[None, None, None, :]
    inside = (rows < hw[..., 0, None, None]) & (cols < hw[..., 1, None, None])
    image *= inside[..., None].to(torch.uint8)
    batches = [{"image": image[i], "image_hw": hw[i]} for i in range(n)]
    if "boxes_per_image" in traffic:
        _plant(batches, traffic, seed, max_gt_boxes, num_classes)
    if device.type != "cuda":
        return batches
    return [{k: _pinned(v) for k, v in batch.items()} for batch in batches]


def _plant(batches, traffic, seed, g, num_classes):
    """Ground truth drawn on the host from the seed, painted on the device."""
    rng = np.random.default_rng(stream(seed, "boxes"))
    k_lo, k_hi = traffic["boxes_per_image"]
    colours = rng.integers(0, 256, (num_classes + 1, 3))
    images = sum(batch["image"].shape[0] for batch in batches)
    counts = iter(rng.permutation(
        k_lo + np.arange(images) * (k_hi - k_lo + 1) // images))
    for batch in batches:
        b = batch["image"].shape[0]
        hw = batch["image_hw"].cpu().numpy()
        gt = np.zeros((b, g, 4), np.float32)
        classes = np.zeros((b, g), np.int32)
        valid = np.zeros((b, g), bool)
        for i, (ih, iw) in enumerate(hw):
            k = int(next(counts))
            size = rng.uniform(0.1, 0.5, (k, 2)) * (iw, ih)
            x1 = rng.uniform(0, iw - size[:, 0])
            y1 = rng.uniform(0, ih - size[:, 1])
            gt[i, :k] = np.stack([x1, y1, x1 + size[:, 0], y1 + size[:, 1]],
                                 -1)
            classes[i, :k] = rng.integers(1, num_classes + 1, k)
            valid[i, :k] = True
            for (a, c, e, f), cls in zip(gt[i, :k].astype(int),
                                         classes[i, :k]):
                batch["image"][i, c:f, a:e] = torch.as_tensor(
                    colours[cls], dtype=torch.uint8,
                    device=batch["image"].device)
        batch["gt_boxes"] = torch.from_numpy(gt)
        batch["gt_classes"] = torch.from_numpy(classes)
        batch["gt_valid"] = torch.from_numpy(valid)


def _pinned(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    return out
