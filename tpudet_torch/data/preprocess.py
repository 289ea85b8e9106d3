"""Image preprocessing (``tpudet.data.preprocess``).

Host half (numpy and torch on the CPU, in the loader's threads): an
aspect-preserving resize so that the min side is ``min_size`` and the max
side at most ``max_size``, padding onto the static canvas (top-left), and
the boxes scaled by the same factors. The canvas stays uint8, so the copy to
the card is 4x smaller than f32. The JAX package resizes with PIL's
bilinear filter; ``resize_uint8`` computes PIL's resampling in torch (its
weights, fixed-point arithmetic and two passes), so the canvases are the
JAX package's bit for bit and the data path needs no PIL.
``prepare_example_jpeg`` does the decode, resize and pad in the native C++
front end (``tpudet_torch/native``) instead.

Device half (on the batch's device, inside the train or eval step): uint8
-> f32, the per-channel normalization and, in training, the colour jitter
and the random horizontal flip of each image's valid region with its boxes
(and the masks, semantic maps and keypoints that come with them).
Their random draws come in as tensors (``augment_draws``), as the samplers'
do, so a test can give both packages the same ones.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpudet_torch.config import Config, DataConfig
from tpudet_torch.data import native_decode
from tpudet_torch.data.masks import crop_instances
from tpudet_torch.ops.boxes import flip_boxes_horizontal

_warned_gt_truncation = False


def resize_scale(h: int, w: int, min_size: int, max_size: int) -> float:
    """Aspect-preserving scale: min side -> min_size, capped by max_size."""
    scale = min_size / min(h, w)
    if scale * max(h, w) > max_size:
        scale = max_size / max(h, w)
    return scale


def jittered_minmax(cfg: DataConfig, h: int, w: int, ch: int, cw: int,
                    factor: float) -> Tuple[int, int]:
    """Integer (min_size, max_size) of the per-image scale jitter: the
    protocol sizes times ``factor``, clamped so that the resized image fits
    the (ch, cw) canvas chosen from the unjittered size (the loader's bucket
    plan never sees the jitter)."""
    s_fit = min(ch / h, cw / w)
    jmin = min(round(cfg.min_size * factor), int(s_fit * min(h, w)))
    jmax = min(round(cfg.max_size * factor), int(s_fit * max(h, w)))
    return max(1, jmin), max(1, jmax)


def bucket_for_hw(cfg: DataConfig, h: int, w: int) -> int:
    """Bucket id of an image of original size (h, w): with
    ``aspect_buckets`` the canvas that fits its resized shape with the
    fewest padded pixels (a bucket too small on an axis pays 4x the clipped
    area); with ``orientation_buckets`` landscape 0, portrait 1; else 0."""
    if cfg.aspect_buckets:
        scale = resize_scale(h, w, cfg.min_size, cfg.max_size)
        th, tw = round(h * scale), round(w * scale)
        best, best_cost = 0, None
        for i, (ch, cw) in enumerate(cfg.aspect_buckets):
            fit_h, fit_w = min(th, ch), min(tw, cw)
            clipped = th * tw - fit_h * fit_w
            cost = (ch * cw - fit_h * fit_w) + 4 * clipped
            if best_cost is None or cost < best_cost:
                best, best_cost = i, cost
        return best
    if cfg.orientation_buckets:
        return 0 if w >= h else 1
    return 0


def canvas_for_hw(cfg: DataConfig, h: int, w: int) -> Tuple[int, int]:
    """Static canvas (ch, cw) of an image of original size (h, w)."""
    if cfg.aspect_buckets:
        return tuple(cfg.aspect_buckets[bucket_for_hw(cfg, h, w)])
    if not cfg.orientation_buckets:
        return cfg.canvas_height, cfg.canvas_width
    if w >= h:
        return cfg.canvas_short, cfg.canvas_width
    return cfg.canvas_height, cfg.canvas_short


# PIL's fixed-point precision for 8-bit resampling (Resample.c).
_PRECISION_BITS = 32 - 8 - 2


@functools.lru_cache(maxsize=256)
def _bilinear_taps(in_size: int, out_size: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PIL's bilinear taps of one axis (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``): ``(idx [out, K] int64, weight [out, K]
    int32)``, each output's input positions and fixed-point weights (taps
    past an output's support weigh 0). The filter widens by the scale when
    shrinking (antialiasing); the weight sums run in PIL's order."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # the bilinear filter's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    count = np.minimum((center + support + 0.5).astype(np.int64),
                       in_size) - xmin
    taps = np.arange(ksize)
    x = np.abs(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5)
               * (1.0 / filterscale))
    w = np.where(taps[None, :] < count[:, None],
                 np.where(x < 1.0, 1.0 - x, 0.0), 0.0)
    total = np.zeros(out_size)
    for k in range(ksize):
        total = total + w[:, k]
    w = np.where(total[:, None] != 0.0,
                 w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = (0.5 + w * (1 << _PRECISION_BITS)).astype(np.int64)  # w >= 0
    idx = np.minimum(xmin[:, None] + taps[None, :], in_size - 1)
    return (torch.from_numpy(idx),
            torch.from_numpy(fixed.astype(np.int32)))


def _resample_rows(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """One of PIL's passes over axis 0 of a 2-D uint8 tensor: the taps'
    fixed-point sum, rounded and clipped back to uint8."""
    idx, weight = _bilinear_taps(x.shape[0], out_size)
    acc = torch.full((out_size, x.shape[1]), 1 << (_PRECISION_BITS - 1),
                     dtype=torch.int32)
    xi = x.to(torch.int32)
    for k in range(idx.shape[1]):
        acc.add_(xi.index_select(0, idx[:, k]).mul_(weight[:, k:k + 1]))
    return acc.bitwise_right_shift_(_PRECISION_BITS).clamp_(0, 255).to(
        torch.uint8)


def resize_uint8(image: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """[h, w, 3] uint8 -> [nh, nw, 3] uint8, as PIL's
    ``Image.resize((nw, nh), BILINEAR)`` computes it: the horizontal pass,
    rounded to uint8, then the vertical one, each skipped where the size
    stays."""
    h, w, c = image.shape
    x = torch.from_numpy(np.require(image, requirements=("C", "W")))
    if nw != w:
        x = _resample_rows(x.permute(1, 0, 2).reshape(w, h * c), nw)
        x = x.reshape(nw, h, c).permute(1, 0, 2)
    if nh != h:
        x = _resample_rows(x.reshape(h, nw * c), nh).reshape(nh, nw, c)
    return x.contiguous().numpy()


def _finalize_example(cfg: DataConfig, canvas: np.ndarray, nh: int, nw: int,
                      h: int, w: int, boxes: np.ndarray, classes: np.ndarray,
                      difficult: Optional[np.ndarray] = None,
                      crowd: Optional[np.ndarray] = None,
                      area: Optional[np.ndarray] = None,
                      masks=None, keypoints=None,
                      semantic=None) -> Dict[str, np.ndarray]:
    """The ground truth packed to ``max_gt_boxes`` rows and the boxes scaled
    by the per-axis resize factors. ``area`` is the annotation's own area in
    original pixels (COCO); -1 marks none (the evaluator then uses the
    box's). With ``data.load_masks``, ``gt_masks`` [max_gt_boxes, M, M]
    uint8: each instance's mask rep (``data.masks``) cropped to its
    original-pixel box, which makes the crop resize-invariant. With
    ``data.load_semantic``, ``gt_semantic`` [ceil(H/4), ceil(W/4)] int32 of
    the canvas: each cell the original map's pixel nearest to the cell's
    canvas centre ``4i + 1.5``, 0 (void) outside the image. With
    ``data.load_keypoints``, ``gt_keypoints`` [max_gt_boxes, K, 3]: each
    instance's ``[K, 3]`` (x, y, v) in original pixels (None: unannotated,
    v stays 0) with x and y scaled as the boxes."""
    g = cfg.max_gt_boxes
    gt_boxes = np.zeros((g, 4), np.float32)
    gt_classes = np.zeros((g,), np.int32)
    gt_valid = np.zeros((g,), bool)
    gt_difficult = np.zeros((g,), bool)
    gt_crowd = np.zeros((g,), bool)
    gt_area = np.full((g,), -1.0, np.float32)
    n = min(len(boxes), g)
    if len(boxes) > g:
        global _warned_gt_truncation
        if not _warned_gt_truncation:
            _warned_gt_truncation = True
            print(f"preprocess: an image has {len(boxes)} GT boxes; keeping "
                  f"the first {g} (raise data.max_gt_boxes to keep all: "
                  "dropped GT are invisible to training and to eval npos). "
                  "Further truncations will not be logged.")
    if difficult is not None and n:
        gt_difficult[:n] = difficult[:n]
    if crowd is not None and n:
        gt_crowd[:n] = crowd[:n]
    if area is not None and n:
        gt_area[:n] = area[:n]
    if n:
        gt_boxes[:n] = np.stack([boxes[:n, 0] * (nw / w),
                                 boxes[:n, 1] * (nh / h),
                                 boxes[:n, 2] * (nw / w),
                                 boxes[:n, 3] * (nh / h)],
                                axis=-1).astype(np.float32)
        gt_classes[:n] = classes[:n]
        gt_valid[:n] = True
    extra = {}
    if cfg.load_semantic:
        ch, cw = canvas.shape[:2]
        s4h, s4w = -(-ch // 4), -(-cw // 4)
        gt_semantic = np.zeros((s4h, s4w), np.int32)
        if semantic is not None:
            sem = np.asarray(semantic)
            cyc = np.arange(s4h) * 4.0 + 1.5  # each cell's canvas centre
            cxc = np.arange(s4w) * 4.0 + 1.5
            oy = np.clip((cyc * (h / nh)).astype(np.int64), 0, h - 1)
            ox = np.clip((cxc * (w / nw)).astype(np.int64), 0, w - 1)
            inside = (cyc < nh)[:, None] & (cxc < nw)[None, :]
            gt_semantic = np.where(inside, sem[oy[:, None], ox[None, :]],
                                   0).astype(np.int32)
        extra["gt_semantic"] = gt_semantic
    if cfg.load_keypoints:
        kk = cfg.num_keypoints
        gt_keypoints = np.zeros((g, kk, 3), np.float32)
        for i in range(n if keypoints is not None else 0):
            if keypoints[i] is None:  # an instance without keypoints
                continue
            ki = np.asarray(keypoints[i], np.float32)
            if ki.shape != (kk, 3):
                raise ValueError(
                    f"instance keypoints shaped {ki.shape} but "
                    f"data.num_keypoints = {kk} (want [{kk}, 3])")
            gt_keypoints[i, :, 0] = ki[:, 0] * (nw / w)
            gt_keypoints[i, :, 1] = ki[:, 1] * (nh / h)
            gt_keypoints[i, :, 2] = ki[:, 2]
        extra["gt_keypoints"] = gt_keypoints
    if cfg.load_masks:
        m = cfg.gt_mask_size
        gt_masks = np.zeros((g, m, m), np.uint8)
        if n:
            gt_masks[:n] = crop_instances(
                None if masks is None else masks[:n], boxes[:n], m)
        extra["gt_masks"] = gt_masks
    return {
        "image": canvas,
        "image_hw": np.asarray([nh, nw], np.float32),
        "image_scale": np.asarray([nh / h, nw / w], np.float32),
        "orig_hw": np.asarray([h, w], np.float32),
        "gt_boxes": gt_boxes,
        "gt_classes": gt_classes,
        "gt_valid": gt_valid,
        "gt_difficult": gt_difficult,
        "gt_crowd": gt_crowd,
        "gt_area": gt_area,
        **extra,
    }


def prepare_example(cfg: DataConfig, image: np.ndarray, boxes: np.ndarray,
                    classes: np.ndarray,
                    difficult: Optional[np.ndarray] = None,
                    crowd: Optional[np.ndarray] = None,
                    area: Optional[np.ndarray] = None,
                    masks=None, keypoints=None, semantic=None,
                    scale_factor: float = 1.0) -> Dict[str, np.ndarray]:
    """One example -> fixed-shape arrays. ``image`` [h, w, 3] uint8, boxes
    [n, 4] (x1, y1, x2, y2) pixels, classes [n] in 1..C, ``masks`` one rep
    per instance (read with ``data.load_masks``), ``keypoints`` one [K, 3]
    or None per instance (``data.load_keypoints``), ``semantic`` the
    original-resolution class map (``data.load_semantic``);
    ``scale_factor`` is the train-time scale jitter
    (``jittered_minmax``)."""
    h, w = image.shape[:2]
    ch, cw = canvas_for_hw(cfg, h, w)
    if scale_factor == 1.0:
        min_size, max_size = cfg.min_size, cfg.max_size
    else:
        min_size, max_size = jittered_minmax(cfg, h, w, ch, cw, scale_factor)
    scale = resize_scale(h, w, min_size, max_size)
    nh, nw = min(ch, round(h * scale)), min(cw, round(w * scale))
    if (nh, nw) != (h, w):
        image = resize_uint8(image, nh, nw)
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[:nh, :nw] = image
    return _finalize_example(cfg, canvas, nh, nw, h, w, boxes, classes,
                             difficult, crowd, area, masks, keypoints,
                             semantic)


def prepare_example_jpeg(cfg: DataConfig, jpeg: bytes, boxes: np.ndarray,
                         classes: np.ndarray,
                         difficult: Optional[np.ndarray] = None,
                         crowd: Optional[np.ndarray] = None,
                         area: Optional[np.ndarray] = None,
                         masks=None, keypoints=None, semantic=None,
                         scale_factor: float = 1.0) -> Dict[str, np.ndarray]:
    """``prepare_example`` through the native front end: the C++ library
    fuses the JPEG decode (DCT-scaled when ``fast_jpeg_scale``), the resize
    and the canvas pad in one pass. The same output contract, the scale
    jitter included (the same integer sizes from ``jittered_minmax``)."""
    h = w = None
    if cfg.orientation_buckets or cfg.aspect_buckets:
        h, w = native_decode.jpeg_dims(jpeg)
        ch, cw = canvas_for_hw(cfg, h, w)
    else:
        ch, cw = cfg.canvas_height, cfg.canvas_width
    min_size, max_size = cfg.min_size, cfg.max_size
    if scale_factor != 1.0:
        if h is None:
            h, w = native_decode.jpeg_dims(jpeg)  # a header parse
        min_size, max_size = jittered_minmax(cfg, h, w, ch, cw, scale_factor)
    canvas, (nh, nw), (h, w) = native_decode.decode_resize_pad(
        jpeg, min_size, max_size, ch, cw, fast_dct_scale=cfg.fast_jpeg_scale)
    return _finalize_example(cfg, canvas, nh, nw, h, w, boxes, classes,
                             difficult, crowd, area, masks, keypoints,
                             semantic)


def rescale_to_original(boxes: np.ndarray, image_scale: np.ndarray,
                        orig_hw: np.ndarray) -> np.ndarray:
    """Canvas coordinates -> original-image coordinates: the inverse of the
    per-axis resize of ``_finalize_example``, clipped to the image."""
    sy, sx = image_scale[0], image_scale[1]
    out = boxes.copy()
    out[:, [0, 2]] /= sx
    out[:, [1, 3]] /= sy
    out[:, [0, 2]] = out[:, [0, 2]].clip(0, orig_hw[1])
    out[:, [1, 3]] = out[:, [1, 3]].clip(0, orig_hw[0])
    return out


def rescale_keypoints_to_original(kps: np.ndarray, image_scale: np.ndarray,
                                  orig_hw: np.ndarray) -> np.ndarray:
    """Canvas keypoints [..., 3] (x, y, v or score) -> original-image
    pixels, clipped to the image: ``rescale_to_original`` for keypoints."""
    sy, sx = image_scale[0], image_scale[1]
    out = kps.copy()
    out[..., 0] = (out[..., 0] / sx).clip(0, orig_hw[1])
    out[..., 1] = (out[..., 1] / sy).clip(0, orig_hw[0])
    return out


def augment_draws(generator: torch.Generator, b: int
                  ) -> Dict[str, torch.Tensor]:
    """The train-time augmentation's draws for ``b`` images, on the
    generator's device: ``jitter [B, 4]`` uniforms in [0, 1) (brightness,
    contrast, saturation, hue) and ``flip [B]`` bool, each image's coin at
    0.5. Drawn whatever the config enables, so the stream's layout is
    fixed."""
    device = generator.device
    jitter = torch.rand(b, 4, generator=generator, device=device)
    flip = torch.rand(b, generator=generator, device=device) < 0.5
    return {"jitter": jitter, "flip": flip}


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform(minval=lo, maxval=hi)`` of the unit draw ``u``:
    ``max(lo, u * (hi - lo) + lo)`` in f32."""
    lo_t = torch.tensor(lo, dtype=torch.float32, device=u.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=u.device)
    return torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)


_LUMA = (0.299, 0.587, 0.114)  # ITU-R 601, torchvision's grayscale
_RGB2YIQ = ((0.299, 0.587, 0.114),
            (0.5959, -0.2746, -0.3213),
            (0.2115, -0.5227, 0.3112))
_YIQ2RGB = ((1.0, 0.956, 0.619),
            (1.0, -0.272, -0.647),
            (1.0, -1.106, 1.703))


def color_jitter(image: torch.Tensor, image_hw: torch.Tensor,
                 u: torch.Tensor, jitter) -> torch.Tensor:
    """Photometric jitter of each image's valid region (``[B, H, W, 3]``
    f32 in 0..255, ``u [B, 4]`` unit draws): brightness, contrast and
    saturation by U(1 - x, 1 + x) factors, hue by a U(-h, h)-turn rotation
    of the YIQ chroma plane (one 3x3 matrix per image). The grey means read
    the valid region only and the padding stays zero."""
    b_j, c_j, s_j, h_j = jitter
    dev, dt = image.device, image.dtype
    rows = torch.arange(image.shape[1], device=dev)[None, :, None] \
        < image_hw[:, 0, None, None]
    cols = torch.arange(image.shape[2], device=dev)[None, None, :] \
        < image_hw[:, 1, None, None]
    valid = (rows & cols)[..., None].to(dt)  # [B, H, W, 1]
    n_valid = torch.clamp(valid.sum(dim=(1, 2, 3)), min=1.0)
    luma = torch.tensor(_LUMA, dtype=dt, device=dev)

    def per_image(x):
        return x[:, None, None, None]

    out = image
    if b_j > 0:
        out = out * per_image(_uniform(u[:, 0], 1 - b_j, 1 + b_j))
    if c_j > 0:
        gray_mean = ((out @ luma)[..., None] * valid).sum(dim=(1, 2, 3)) \
            / n_valid
        f = _uniform(u[:, 1], 1 - c_j, 1 + c_j)
        out = (out - per_image(gray_mean)) * per_image(f) \
            + per_image(gray_mean)
    if s_j > 0:
        gray = (out @ luma)[..., None]
        f = _uniform(u[:, 2], 1 - s_j, 1 + s_j)
        out = gray + (out - gray) * per_image(f)
    if h_j > 0:
        theta = _uniform(u[:, 3], -h_j, h_j) * (2.0 * np.pi)
        cos_t, sin_t = torch.cos(theta), torch.sin(theta)
        one, zero = torch.ones_like(theta), torch.zeros_like(theta)
        rot = torch.stack([torch.stack([one, zero, zero], -1),
                           torch.stack([zero, cos_t, -sin_t], -1),
                           torch.stack([zero, sin_t, cos_t], -1)], -2)
        m = (torch.tensor(_YIQ2RGB, dtype=dt, device=dev) @ rot
             @ torch.tensor(_RGB2YIQ, dtype=dt, device=dev))  # [B, 3, 3]
        out = out @ m.transpose(1, 2)[:, None]
    return torch.clamp(out, 0.0, 255.0) * valid


def flip_image(image: torch.Tensor, image_hw: torch.Tensor) -> torch.Tensor:
    """Mirror each ``[B, H, W, C]`` canvas's valid columns [0, w) (the
    padding stays where it is)."""
    b, h, w, c = image.shape
    w_img = image_hw[:, 1]
    cols = torch.arange(w, device=image.device, dtype=w_img.dtype)[None, :]
    src = torch.where(cols < w_img[:, None], w_img[:, None] - 1 - cols,
                      cols).to(torch.int64)
    return torch.gather(image, 2, src[:, None, :, None].expand(b, h, w, c))


def flip_horizontal(image: torch.Tensor, boxes: torch.Tensor,
                    image_hw: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mirror each image's valid columns [0, w) (the padding stays where it
    is) and its boxes about its width."""
    return (flip_image(image, image_hw),
            flip_boxes_horizontal(boxes, image_hw[:, 1:2]))


def flip_semantic(sem: torch.Tensor, image_hw: torch.Tensor) -> torch.Tensor:
    """Mirror each quarter-scale map ``[B, H4, W4]``'s valid columns, those
    whose canvas centre ``4j + 1.5`` lies inside the image: ``w4 =
    ceil((w - 1.5) / 4)`` of them."""
    b, h4, w4 = sem.shape
    valid = torch.ceil((image_hw[:, 1] - 1.5) / 4.0)[:, None]
    cols = torch.arange(w4, device=sem.device, dtype=valid.dtype)[None, :]
    src = torch.where(cols < valid, valid - 1 - cols, cols).to(torch.int64)
    return torch.gather(sem, 2, src[:, None, :].expand(b, h4, w4))


def flip_keypoints(kps: torch.Tensor, image_hw: torch.Tensor,
                   flip_pairs) -> torch.Tensor:
    """Mirror the x of each labeled keypoint ``[B, G, K, 3]`` about its
    image's width (as the boxes; v = 0 rows keep their zeros) and swap the
    left/right ``flip_pairs``."""
    w_img = image_hw[:, 1][:, None, None]
    labeled = kps[..., 2] > 0
    fx = torch.where(labeled, w_img - kps[..., 0], kps[..., 0])
    flipped = torch.stack([fx, kps[..., 1], kps[..., 2]], dim=-1)
    perm = list(range(kps.shape[2]))
    for a, b in flip_pairs:
        perm[a], perm[b] = perm[b], perm[a]
    return flipped[:, :, perm, :]


def device_preprocess(cfg: Config, batch: Dict[str, torch.Tensor],
                      training: bool = False,
                      draws: Optional[Dict[str, torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
    """Normalize ``batch["image"]`` (``[B, H, W, 3]``) on its device to
    ``(x - mean) / std`` (bf16 when the backbone computes in bf16). In
    training, first the colour jitter (when ``data.color_jitter`` is not all
    zero) and the random flip of the image, ``gt_boxes``, ``gt_masks``,
    ``gt_semantic`` and ``gt_keypoints`` (when ``data.random_flip``; the
    keypoints' left/right pairs swapped), with ``draws``
    (``augment_draws``'s layout) or draws from ``generator``. The other
    entries pass through."""
    d = cfg.data
    image = batch["image"].to(torch.float32)
    out = dict(batch)
    if training:
        if draws is None:
            if generator is None:
                raise ValueError("device_preprocess(training=True) draws its "
                                 "augmentation at random: pass draws or a "
                                 "torch.Generator")
            draws = augment_draws(generator, image.shape[0])
        image_hw = batch["image_hw"].to(torch.float32)
        if tuple(d.color_jitter) not in ((), (0.0,) * 4):
            image = color_jitter(image, image_hw, draws["jitter"],
                                 d.color_jitter)
        gt_boxes = batch.get("gt_boxes")
        if d.random_flip and gt_boxes is not None:
            do_flip = draws["flip"]
            f_img, f_boxes = flip_horizontal(image, gt_boxes.to(torch.float32),
                                             image_hw)
            image = torch.where(do_flip[:, None, None, None], f_img, image)
            out["gt_boxes"] = torch.where(do_flip[:, None, None], f_boxes,
                                          gt_boxes.to(torch.float32))
            if "gt_masks" in batch:
                # A box-frame crop is resize-invariant but not
                # flip-invariant: mirroring the image mirrors each instance
                # within its mirrored box.
                gm = batch["gt_masks"]
                out["gt_masks"] = torch.where(do_flip[:, None, None, None],
                                              gm.flip(-1), gm)
            if "gt_semantic" in batch:
                gs = batch["gt_semantic"]
                out["gt_semantic"] = torch.where(
                    do_flip[:, None, None], flip_semantic(gs, image_hw), gs)
            if "gt_keypoints" in batch:
                gk = batch["gt_keypoints"].to(torch.float32)
                out["gt_keypoints"] = torch.where(
                    do_flip[:, None, None, None],
                    flip_keypoints(gk, image_hw, d.keypoint_flip_pairs), gk)
    mean = torch.tensor(d.pixel_mean, dtype=torch.float32, device=image.device)
    std = torch.tensor(d.pixel_std, dtype=torch.float32, device=image.device)
    normalized = (image - mean) / std
    if cfg.backbone.dtype == "bfloat16":
        normalized = normalized.to(torch.bfloat16)
    out["image"] = normalized
    return out
