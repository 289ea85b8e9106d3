"""RoI Align, plain PyTorch versions (``tpudet.ops.roi_align``).

Canonical aligned RoI Align (Mask R-CNN, Detectron2 convention): boxes in
feature-map coordinates ``[x1, y1, x2, y2]`` are shifted by -0.5, split
into ``S x S`` bins, and each bin averages ``r x r`` bilinear samples.
Samples outside ``[-1, dim]`` contribute zero; samples inside are clamped to
``[0, dim - 1]``.

``roi_align`` is the gather form: the CPU path of the pooler and the
reference of the Hopper kernel in ``tpudet_torch.kernels.roi_align``.
``roi_align_mxu`` is the two-einsum form the JAX package runs on the TPU;
the port keeps it for the tests and as a timing reference only.

FPN: ``fpn_assign_levels`` picks each RoI's level and ``roi_align_levels``
pools each RoI once at it (the reference of the Hopper kernel in
``tpudet_torch.kernels.roi_align_window``).

``crop_and_resize`` is the other pooler: ``tf.image.crop_and_resize``'s
convention (the JAX package's ``ops.roi_align.crop_and_resize``), which no
TPU kernel computes, in plain PyTorch; autograd differentiates it in the
features.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _sample_grid(starts, extents, size, s, r):
    """Sample coordinates along one axis: ``[K, s*r]`` clamped positions +
    validity (the Detectron2 border rule).

    The divisions are by tensors on the boxes' device: PyTorch's CUDA
    kernels turn a division by a Python scalar into a multiply by its
    reciprocal, an ulp away from the true division the CPU, JAX and the
    CUDA kernel make (an ulp of a sample position shows as ~2e-5 on a
    feature map with steep gradients)."""
    dev = starts.device
    s_div = torch.tensor(float(s), device=dev)
    r_div = torch.tensor(float(r), device=dev)
    grid = (
        torch.arange(s, dtype=torch.float32, device=dev)[:, None]
        + (torch.arange(r, dtype=torch.float32, device=dev)[None, :] + 0.5)
        / r_div
    ).reshape(-1)  # [s*r]
    pos = (starts - 0.5)[:, None] + grid[None, :] * (
        extents.clamp(min=1e-6) / s_div)[:, None]
    valid = (pos >= -1.0) & (pos <= size)
    if isinstance(size, torch.Tensor):  # one size per row, [K, 1]
        return _clamp_upto(pos, size - 1), valid
    return pos.clamp(0, size - 1), valid


def roi_align(
    features: torch.Tensor,
    boxes: torch.Tensor,
    output_size: int,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """One image: ``[H, W, C]``, ``[N, 4]`` -> ``[N, S, S, C]`` in the
    features' dtype (sampling and the average run in f32)."""
    return roi_align_batched(
        features[None], boxes,
        torch.zeros(boxes.shape[0], dtype=torch.int32, device=boxes.device),
        output_size, sampling_ratio,
    )


def roi_align_batched(
    features: torch.Tensor,
    boxes: torch.Tensor,
    image_index: torch.Tensor,
    output_size: int,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Batched gather form: ``[B, H, W, C]`` features, ``[K, 4]`` boxes and
    their ``[K]`` image indices -> ``[K, S, S, C]`` in the features' dtype.

    Differentiable in the features: the corners are gathered from an f32
    view of the map (exact for bf16), so autograd sums the gradient in f32
    and rounds it once to the features' dtype, as the backward kernel
    does."""
    _, h, w, c = features.shape
    feats32 = features.float()  # the tensor itself when already f32
    k = boxes.shape[0]
    s, r = output_size, sampling_ratio
    boxes = boxes.float()
    ys, vy = _sample_grid(boxes[:, 1], boxes[:, 3] - boxes[:, 1], h, s, r)
    xs, vx = _sample_grid(boxes[:, 0], boxes[:, 2] - boxes[:, 0], w, s, r)

    y0 = ys.floor().long().clamp(0, h - 1)
    x0 = xs.floor().long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    ly = (ys - y0.float())[:, :, None, None]  # [K, s*r, 1, 1]
    lx = (xs - x0.float())[:, None, :, None]  # [K, 1, s*r, 1]

    img = image_index.long()[:, None, None]

    def corner(yi, xi):  # [K, s*r, s*r, C] in f32
        return feats32[img, yi[:, :, None], xi[:, None, :]]

    top = corner(y0, x0) * (1.0 - lx) + corner(y0, x1) * lx
    bot = corner(y1, x0) * (1.0 - lx) + corner(y1, x1) * lx
    sampled = top * (1.0 - ly) + bot * ly
    vmask = (vy[:, :, None] & vx[:, None, :])[..., None]
    sampled = torch.where(vmask, sampled, torch.zeros_like(sampled))
    pooled = sampled.reshape(k, s, r, s, r, c).mean(dim=(2, 4))
    return pooled.to(features.dtype)


def _interp_weights(pos, valid, size):
    """[K, S] positions -> [K, S, size] bilinear weight rows, zeroed where
    the sample is out of range."""
    idx = torch.arange(size, dtype=pos.dtype, device=pos.device)
    wts = (1.0 - (pos[:, :, None] - idx[None, None, :]).abs()).clamp(min=0.0)
    return wts * valid[:, :, None]


def roi_align_mxu(
    features: torch.Tensor,
    boxes: torch.Tensor,
    output_size: int,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """RoI Align as two contractions with separable bin-weight rows (the
    JAX package's TPU formulation). One image: ``[H, W, C]``, ``[N, 4]`` ->
    ``[N, S, S, C]``."""
    h, w = features.shape[0], features.shape[1]
    n = boxes.shape[0]
    s, r = output_size, sampling_ratio
    boxes = boxes.float()
    ys, vy = _sample_grid(boxes[:, 1], boxes[:, 3] - boxes[:, 1], h, s, r)
    xs, vx = _sample_grid(boxes[:, 0], boxes[:, 2] - boxes[:, 0], w, s, r)
    wy = _interp_weights(ys, vy, h).reshape(n, s, r, h).mean(dim=2)
    wx = _interp_weights(xs, vx, w).reshape(n, s, r, w).mean(dim=2)
    wy = wy.to(features.dtype)
    wx = wx.to(features.dtype)
    if w >= h:
        t1 = torch.einsum("ntw,hwc->nthc", wx, features)
        return torch.einsum("nsh,nthc->nstc", wy, t1)
    t1 = torch.einsum("nsh,hwc->nswc", wy, features)
    return torch.einsum("ntw,nswc->nstc", wx, t1)


# The f32 constants XLA folds ``x / 224``, ``x / (window - 12)`` and
# ``log2(x) = log(x) / log(2)`` into: multiplies by f32 reciprocals.
_INV_LN2 = float(np.float32(1.0) / np.float32(np.log(np.float32(2.0))))


def _f32_recip(x: float) -> float:
    return float(np.float32(1.0) / np.float32(x))


def _fma_f32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """``a * b + c`` with one rounding to f32, as a fused multiply-add:
    the f32 product is exact in f64 (``b`` and ``c`` are f32 values)."""
    return (a.double() * b + c).float()


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``log`` rounded from f64, so the CPU and the card agree."""
    return torch.log(x.double()).float()


def fpn_assign_levels(
    boxes: torch.Tensor,
    min_level: int = 2,
    max_level: int = 5,
    canonical_scale: float = 224.0,
    canonical_level: int = 4,
    fit_window: int = 0,
) -> torch.Tensor:
    """FPN-paper level ``floor(k0 + log2(sqrt(area) / 224))`` of ``[..., 4]``
    image-pixel boxes, clipped to ``[min_level, max_level]``, as int32.

    ``fit_window > 0`` bumps each RoI up to the first level where its longer
    side spans at most ``fit_window - 12`` cells (``ceil(log2(max(span, 1)
    / (fit_window - 12)))``), as ``tpudet.ops.roi_align.fpn_assign_levels``
    does for its windowed pooler.

    The level is a discrete decision, so it repeats the f32 arithmetic of
    the JAX function as XLA compiles it under ``jit``: both divisions by a
    constant become multiplies by the f32 reciprocal, ``log2`` is ``log``
    times ``1/ln 2``, and the two multiply-adds (``sqrt(area) * (1/224) +
    1e-8`` and ``log(.) * (1/ln 2) + 4``) are fused. The f32 ``log`` is
    rounded from f64, which the CPU and CUDA both compute to within an ulp
    of f64, so both devices round it alike."""
    boxes = boxes.float()
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    areas = w.clamp(min=0.0) * h.clamp(min=0.0)
    x = _fma_f32(torch.sqrt(areas), _f32_recip(canonical_scale), 1e-8)
    k = torch.floor(_fma_f32(_log_f32(x), _INV_LN2, float(canonical_level)))
    k = k.clamp(min_level, max_level).to(torch.int32)
    if fit_window:
        if fit_window <= 12:
            raise ValueError(f"fit_window={fit_window} must exceed the 12-cell "
                             "window slack (use window >= 24)")
        span = torch.maximum(w, h).clamp(min=1.0)
        y = span * torch.tensor(_f32_recip(fit_window - 12), device=span.device)
        need = torch.ceil(_log_f32(y) * torch.tensor(_INV_LN2, device=y.device))
        k = torch.maximum(k, need.to(torch.int32)).clamp(min_level, max_level)
    return k


def _clamp_upto(x: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``x.clamp(0, hi)`` for a per-row ``hi`` tensor (clamp's order: the
    lower bound, then the upper)."""
    return torch.minimum(x.clamp(min=0), hi)


def roi_align_levels(
    features: Sequence[torch.Tensor],
    strides: Sequence[float],
    boxes: torch.Tensor,
    levels: torch.Tensor,
    output_size: int,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """Multi-level RoI Align, each RoI pooled once at its own level:
    ``[B, H_l, W_l, C]`` maps, ``[B, N, 4]`` image-pixel boxes and ``[B, N]``
    0-based levels -> ``[B, N, S, S, C]`` in the features' dtype. A RoI whose
    level names no map pools to zeros.

    The value of the JAX package's windowed pooler and of its all-level
    masked sum under the same levels: each RoI goes through the arithmetic
    of ``roi_align_batched`` on ``boxes / stride`` at its level, in one
    gather pass over the levels laid out one after another in one flat f32
    buffer (each RoI with its level's row offset, height, width and
    stride). Its shapes depend on no data, so ``torch.export`` traces it."""
    b, n = boxes.shape[:2]
    dev = boxes.device
    c = features[0].shape[-1]
    s, r = output_size, sampling_ratio
    k = b * n
    flat_levels = levels.reshape(k).long()
    known = (flat_levels >= 0) & (flat_levels < len(features))
    lvl = torch.where(known, flat_levels, torch.zeros_like(flat_levels))
    # Per level: row offset in the flat buffer, height, width, stride.
    sizes = [f.shape[0] * f.shape[1] * f.shape[2] for f in features]
    bases = torch.tensor([sum(sizes[:i]) for i in range(len(features))],
                         dtype=torch.int64, device=dev)[lvl]
    heights = torch.tensor([f.shape[1] for f in features], dtype=torch.int64,
                           device=dev)[lvl]
    widths = torch.tensor([f.shape[2] for f in features], dtype=torch.int64,
                          device=dev)[lvl]
    stride = torch.tensor([float(st) for st in strides], dtype=torch.float32,
                          device=dev)[lvl]
    table = torch.cat([f.float().reshape(-1, c) for f in features])
    image = torch.arange(b, dtype=torch.int64, device=dev).repeat_interleave(n)

    rois = boxes.reshape(k, 4).float() / stride[:, None]
    h32, w32 = heights.float()[:, None], widths.float()[:, None]
    ys, vy = _sample_grid(rois[:, 1], rois[:, 3] - rois[:, 1], h32, s, r)
    xs, vx = _sample_grid(rois[:, 0], rois[:, 2] - rois[:, 0], w32, s, r)
    hmax, wmax = heights[:, None] - 1, widths[:, None] - 1
    y0 = _clamp_upto(ys.floor().long(), hmax)
    x0 = _clamp_upto(xs.floor().long(), wmax)
    y1 = torch.minimum(y0 + 1, hmax)
    x1 = torch.minimum(x0 + 1, wmax)
    ly = (ys - y0.float())[:, :, None, None]
    lx = (xs - x0.float())[:, None, :, None]
    row0 = (bases + image * heights * widths)[:, None, None]
    width = widths[:, None, None]

    def corner(yi, xi):  # [K, s*r, s*r, C] in f32
        return table[row0 + yi[:, :, None] * width + xi[:, None, :]]

    top = corner(y0, x0) * (1.0 - lx) + corner(y0, x1) * lx
    bot = corner(y1, x0) * (1.0 - lx) + corner(y1, x1) * lx
    sampled = top * (1.0 - ly) + bot * ly
    vmask = (vy[:, :, None] & vx[:, None, :] & known[:, None, None])[..., None]
    sampled = torch.where(vmask, sampled, torch.zeros_like(sampled))
    pooled = sampled.reshape(k, s, r, s, r, c).mean(dim=(2, 4))
    return pooled.to(features[0].dtype).reshape(b, n, s, s, c)


def crop_and_resize_batched(
    features: torch.Tensor,
    boxes: torch.Tensor,
    image_index: torch.Tensor,
    crop_size: int,
    extrapolation_value: float = 0.0,
) -> torch.Tensor:
    """``tf.image.crop_and_resize``'s convention, as the JAX package's
    ``crop_and_resize``: ``[B, H, W, C]`` features, ``[K, 4]`` boxes
    ``[x1, y1, x2, y2]`` in feature-map index coordinates and their ``[K]``
    image indices -> ``[K, S, S, C]`` f32. A ``crop_size`` grid spans the
    box corners inclusive (the centre when ``crop_size`` is 1), each point
    sampled bilinearly; a point outside ``[0, dim - 1]`` takes
    ``extrapolation_value``. The arithmetic is f32 over the features cast
    to f32 (JAX promotes a bf16 map times f32 weights to f32)."""
    _, h, w, _ = features.shape
    feats32 = features.float()
    boxes = boxes.float()
    s = crop_size
    x1, y1, x2, y2 = boxes.unbind(-1)
    dev = boxes.device
    if s > 1:
        steps = (torch.arange(s, dtype=torch.float32, device=dev)
                 / torch.tensor(float(s - 1), device=dev))
        ys = y1[:, None] + steps[None, :] * (y2 - y1)[:, None]
        xs = x1[:, None] + steps[None, :] * (x2 - x1)[:, None]
    else:
        ys = (0.5 * (y1 + y2))[:, None]
        xs = (0.5 * (x1 + x2))[:, None]
    valid_y = (ys >= 0) & (ys <= h - 1)
    valid_x = (xs >= 0) & (xs <= w - 1)
    ys = ys.clamp(0, h - 1)
    xs = xs.clamp(0, w - 1)
    y0 = ys.floor().long().clamp(0, h - 1)
    x0 = xs.floor().long().clamp(0, w - 1)
    y1i = (y0 + 1).clamp(max=h - 1)
    x1i = (x0 + 1).clamp(max=w - 1)
    ly = (ys - y0.float())[:, :, None, None]  # [K, S, 1, 1]
    lx = (xs - x0.float())[:, None, :, None]  # [K, 1, S, 1]
    img = image_index.long()[:, None, None]

    def corner(yi, xi):  # [K, S, S, C]
        return feats32[img, yi[:, :, None], xi[:, None, :]]

    top = corner(y0, x0) * (1.0 - lx) + corner(y0, x1i) * lx
    bot = corner(y1i, x0) * (1.0 - lx) + corner(y1i, x1i) * lx
    out = top * (1.0 - ly) + bot * ly
    valid = (valid_y[:, :, None] & valid_x[:, None, :])[..., None]
    return torch.where(valid, out, torch.full_like(out, extrapolation_value))


def crop_and_resize(
    features: torch.Tensor,
    boxes: torch.Tensor,
    crop_size: int,
    extrapolation_value: float = 0.0,
) -> torch.Tensor:
    """One image: ``[H, W, C]``, ``[N, 4]`` -> ``[N, S, S, C]`` f32 (see
    ``crop_and_resize_batched``)."""
    return crop_and_resize_batched(
        features[None], boxes,
        torch.zeros(boxes.shape[0], dtype=torch.int32, device=boxes.device),
        crop_size, extrapolation_value)


def crop_and_resize_levels(
    features: Sequence[torch.Tensor],
    strides: Sequence[float],
    boxes: torch.Tensor,
    levels: torch.Tensor,
    crop_size: int,
) -> torch.Tensor:
    """FPN ``crop_and_resize``: ``[B, H_l, W_l, C]`` maps, ``[B, N, 4]``
    image-pixel boxes and ``[B, N]`` 0-based levels -> ``[B, N, S, S, C]``
    f32, each RoI cropped at its level from ``boxes / stride``: the value
    of the JAX package's all-level masked sum (every level pooled, the
    assigned one kept; the others add exact zeros)."""
    b, n = boxes.shape[:2]
    flat = boxes.reshape(b * n, 4)
    image_index = torch.arange(b, dtype=torch.int32,
                               device=boxes.device).repeat_interleave(n)
    flat_levels = levels.reshape(b * n)
    pooled = None
    for level, (feat, stride) in enumerate(zip(features, strides)):
        p = crop_and_resize_batched(feat, flat / float(stride), image_index,
                                    crop_size)
        keep = (flat_levels == level)[:, None, None, None]
        pooled = (torch.where(keep, p, torch.zeros_like(p)) if pooled is None
                  else torch.where(keep, p, pooled))
    return pooled.reshape((b, n) + pooled.shape[1:])
