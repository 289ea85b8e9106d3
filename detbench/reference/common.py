"""Plain PyTorch pieces shared by the references: the precision policy,
ResNet over a flat parameter dict, box geometry, greedy NMS and RoI Align.

Nothing here imports the program. Parameters are a dict ``name -> f32
tensor`` under the program's state-dict names, so the benchmark draws one
set of tensors and hands the same ones to both sides. Layers compute as the
configuration states: a layer of the model dtype casts its input and its
f32 weight to that dtype, as ``tpudet`` does over f32 parameters.

``Precision`` also gives the control of ``correct``: with ``lower=True``
every product's operands go one step below the stated precision (bf16 to
fp8 e4m3 with a per-tensor scale, f32 to bf16) before the product, and
their gradients likewise (fp8 e5m2, bf16).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
FP8_MAX = 448.0  # largest finite float8_e4m3fn
FP8_E5M2_MAX = 57344.0  # largest finite float8_e5m2


def _round(x: torch.Tensor, fmt: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``fmt`` under a per-tensor scale that maps its
    largest magnitude to ``top`` (no scale for bf16, ``top`` 0)."""
    if not top:
        return x.to(fmt).to(x.dtype)
    scale = x.abs().amax().float().clamp(min=1e-30) / top
    return ((x.float() / scale).to(fmt).float() * scale).to(x.dtype)


class _Lower(torch.autograd.Function):
    """The value rounded to the lower format (fp8 e4m3, or bf16 for an f32
    operand) and its gradient rounded to the lower format of gradients
    (fp8 e5m2, or bf16), each under its own per-tensor scale: the recipe
    of scaled fp8 training."""

    @staticmethod
    def forward(ctx, x, fmt, top, grad_fmt, grad_top):
        ctx.grad = (grad_fmt, grad_top)
        return _round(x, fmt, top)

    @staticmethod
    def backward(ctx, g):
        return _round(g, *ctx.grad), None, None, None, None


@dataclass(frozen=True)
class Precision:
    """The model dtype and whether the control's lower precision is on."""

    dtype: torch.dtype
    lower: bool = False

    def operand(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """``x`` as an operand of a product computed in ``dtype``; with
        ``lower`` rounded one step below, its gradient too."""
        x = x.to(dtype)
        if not self.lower:
            return x
        if dtype == torch.float32:
            return _Lower.apply(x, torch.bfloat16, 0.0, torch.bfloat16, 0.0)
        return _Lower.apply(x, torch.float8_e4m3fn, FP8_MAX,
                            torch.float8_e5m2, FP8_E5M2_MAX)


def conv(x, p: Params, name: str, prec: Precision, dtype: torch.dtype,
         stride: int = 1, padding=0) -> torch.Tensor:
    """2-D convolution of NCHW ``x`` with ``name.weight`` (OIHW) and
    ``name.bias`` when the dict has one, in ``dtype``. ``padding`` "same"
    is Flax's: an odd pad goes to the high side."""
    w = prec.operand(p[f"{name}.weight"], dtype)
    b = p.get(f"{name}.bias")
    b = None if b is None else b.to(dtype)
    x = prec.operand(x, dtype)
    if padding == "same":
        k = w.shape[-1]
        pads = []
        for size in (x.shape[3], x.shape[2]):
            out = -(-size // stride)
            total = max((out - 1) * stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        if pads[0] == pads[1] and pads[2] == pads[3]:
            padding = (pads[2], pads[0])
        else:
            x = F.pad(x, pads)
            padding = 0
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def dense(x, p: Params, name: str, prec: Precision,
          dtype: torch.dtype) -> torch.Tensor:
    """``x @ W.T + b`` in ``dtype`` (``W`` is ``[out, in]``)."""
    return F.linear(prec.operand(x, dtype), prec.operand(p[f"{name}.weight"],
                                                         dtype),
                    p[f"{name}.bias"].to(dtype))


def frozen_bn(x, p: Params, name: str) -> torch.Tensor:
    """``x * w + b`` with ``w = scale / sqrt(var + 1e-5)``, ``b = bias -
    mean * w`` made in f32 and cast to the input's dtype."""
    w = p[f"{name}.scale"] / torch.sqrt(p[f"{name}.var"] + 1e-5)
    b = p[f"{name}.bias"] - p[f"{name}.mean"] * w
    return x * w.to(x.dtype)[None, :, None, None] + b.to(x.dtype)[None, :,
                                                                   None, None]


RESNET_STAGES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
RESNET_WIDTHS = (256, 512, 1024, 2048)


def resnet_spec(name: str, blocks: Sequence[int]) -> List[Tuple[str, tuple,
                                                               str]]:
    """``(name, shape, kind)`` of a bottleneck ResNet's tensors, ``kind``
    "conv" (OIHW weight) or "bn" (a frozen norm's prefix)."""
    out = [(f"{name}.stem_conv.weight", (64, 3, 7, 7), "conv"),
           (f"{name}.norm_stem", (64,), "bn")]
    in_ch = 64
    for stage, (n, ch) in enumerate(zip(blocks, RESNET_WIDTHS)):
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            blk = f"{name}.stage{stage + 2}_block{i}"
            if in_ch != ch or stride != 1:
                out += [(f"{blk}.conv_proj.weight", (ch, in_ch, 1, 1), "conv"),
                        (f"{blk}.norm_proj", (ch,), "bn")]
            width = ch // 4
            out += [(f"{blk}.conv1.weight", (width, in_ch, 1, 1), "conv"),
                    (f"{blk}.norm1", (width,), "bn"),
                    (f"{blk}.conv2.weight", (width, width, 3, 3), "conv"),
                    (f"{blk}.norm2", (width,), "bn"),
                    (f"{blk}.conv3.weight", (ch, width, 1, 1), "conv"),
                    (f"{blk}.norm3", (ch,), "bn")]
            in_ch = ch
    return out


def resnet_draws(name: str, blocks: Sequence[int]) -> list:
    """The ResNet's ``(name, shape, draw)`` with Flax's init: lecun-normal
    kernels (untruncated) and the frozen norms at the identity."""
    out = []
    for tensor, shape, kind in resnet_spec(name, blocks):
        if kind == "conv":
            out.append(layer(tensor[:-len(".weight")], shape[0], shape[1],
                             shape[2])[0])
        else:
            out += [(f"{tensor}.{k}", shape, ("const", v)) for k, v in
                    (("scale", 1.0), ("bias", 0.0), ("mean", 0.0),
                     ("var", 1.0))]
    return out


def layer(name: str, out_ch: int, in_ch: int, k: int = 0,
          std: Optional[float] = None, bias=("const", 0.0)) -> list:
    """A dense (``k`` 0) or ``k x k`` conv layer's weight and bias with
    Flax's init: lecun-normal over the fan-in (``std`` overrides it) and
    ``bias``."""
    fan = in_ch * (k * k if k else 1)
    shape = (out_ch, in_ch, k, k) if k else (out_ch, in_ch)
    std = 1.0 / math.sqrt(fan) if std is None else std
    return [(f"{name}.weight", shape, ("normal", 0.0, std)),
            (f"{name}.bias", (out_ch,), bias)]


def resnet(x, p: Params, prec: Precision, blocks: Sequence[int],
           stop_at: int, name: str = "backbone") -> Dict[int, torch.Tensor]:
    """NCHW image -> ``{stage: map}`` for stages 2..``stop_at`` (c2..c5):
    7x7/2 stem, 3x3/2 max-pool, bottlenecks striding their first 1x1 (the
    caffe convention) and padding their 3x3 by one. No gradient reaches the
    stem and stage c2 (the configurations' ``freeze_stem``)."""
    dt = prec.dtype
    x = F.relu(frozen_bn(conv(x, p, f"{name}.stem_conv", prec, dt, 2, 3), p,
                         f"{name}.norm_stem"))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    feats = {}
    in_ch = 64
    for stage, (n, ch) in enumerate(zip(blocks, RESNET_WIDTHS)):
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            blk = f"{name}.stage{stage + 2}_block{i}"
            if in_ch != ch or stride != 1:
                short = frozen_bn(conv(x, p, f"{blk}.conv_proj", prec, dt,
                                       stride), p, f"{blk}.norm_proj")
            else:
                short = x
            y = F.relu(frozen_bn(conv(x, p, f"{blk}.conv1", prec, dt, stride),
                                 p, f"{blk}.norm1"))
            y = F.relu(frozen_bn(conv(y, p, f"{blk}.conv2", prec, dt, 1, 1),
                                 p, f"{blk}.norm2"))
            y = frozen_bn(conv(y, p, f"{blk}.conv3", prec, dt), p,
                          f"{blk}.norm3")
            x = F.relu(y + short)
            in_ch = ch
        if stage == 0:
            x = x.detach()
        feats[stage + 2] = x
        if stage + 2 == stop_at:
            break
    return feats


def normalize(image_u8: torch.Tensor, mean, std,
              dtype: torch.dtype) -> torch.Tensor:
    """uint8 NHWC canvases -> ``(x - mean) / std`` NCHW in ``dtype``."""
    x = image_u8.float()
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).to(dtype).permute(0, 3, 1, 2)


# ----------------------------------------------------------- box geometry
def decode(deltas, anchors, weights=(1.0, 1.0, 1.0, 1.0),
           clip=math.log(1000.0 / 16.0)):
    """Faster R-CNN deltas applied to xyxy ``anchors``."""
    wa = anchors[..., 2] - anchors[..., 0]
    ha = anchors[..., 3] - anchors[..., 1]
    xa = anchors[..., 0] + 0.5 * wa
    ya = anchors[..., 1] + 0.5 * ha
    x = deltas[..., 0] / weights[0] * wa + xa
    y = deltas[..., 1] / weights[1] * ha + ya
    w = torch.exp((deltas[..., 2] / weights[2]).clamp(max=clip)) * wa
    h = torch.exp((deltas[..., 3] / weights[3]).clamp(max=clip)) * ha
    return torch.stack([x - 0.5 * w, y - 0.5 * h, x + 0.5 * w, y + 0.5 * h],
                       dim=-1)


def clip_to(boxes, hw):
    """Clip xyxy boxes to ``[0, w] x [0, h]``; ``hw`` broadcasts against
    ``boxes[..., 0]`` as ``[..., 2]``."""
    h, w = hw[..., 0], hw[..., 1]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def box_iou(a, b):
    """``[..., N, 4]`` x ``[..., M, 4]`` -> ``[..., N, M]`` IoU, 0 where the
    union is empty."""
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0)
              * (a[..., 3] - a[..., 1]).clamp(min=0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0)
              * (b[..., 3] - b[..., 1]).clamp(min=0))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def greedy_nms(boxes, scores, candidate, threshold: float, max_out: int):
    """Exact greedy NMS per image of ``[B, N, 4]`` boxes: candidates in
    descending score (ties to the lower index), a box kept iff no kept box
    before it overlaps it by IoU above ``threshold``. Returns ``(indices
    [B, max_out], valid)``, the first ``max_out`` kept in score order,
    invalid slots pointing at 0."""
    b, n = scores.shape
    key = torch.where(candidate, scores, torch.full_like(scores, -1e10))
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    cand = torch.gather(candidate, 1, order)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(b, n, 4))
    over = torch.cat([box_iou(sboxes[:, r:r + 1024], sboxes) > threshold
                      for r in range(0, n, 1024)], dim=1)
    keep = torch.zeros_like(cand)
    removed = torch.zeros_like(cand)
    for i in range(n):
        k = cand[:, i] & ~removed[:, i]
        keep[:, i] = k
        removed |= over[:, i] & k[:, None]
    rank = torch.arange(n, 0, -1, device=boxes.device)
    top = torch.sort(torch.where(keep, rank, torch.zeros_like(rank)), dim=-1,
                     descending=True, stable=True)
    k = min(max_out, n)
    valid = top.values[:, :k] > 0
    idx = torch.where(valid, torch.gather(order, 1, top.indices[:, :k]), 0)
    if k < max_out:
        idx = F.pad(idx, (0, max_out - k))
        valid = F.pad(valid, (0, max_out - k))
    return idx, valid


def roi_align(fmap, boxes, image_index, size: int, ratio: int):
    """Aligned RoI Align (Detectron2's convention) of NHWC ``fmap`` at
    ``[K, 4]`` boxes in map cells: each of ``size x size`` bins averages
    ``ratio x ratio`` bilinear samples; a sample outside ``[-1, dim]`` adds
    zero, one inside is clamped into the map. -> ``[K, size, size, C]`` in
    the map's dtype, sampled in f32. Positions divide by tensors: on the
    card a division by a Python number is a multiply by its reciprocal."""
    _, h, w, c = fmap.shape
    k = boxes.shape[0]
    dev = fmap.device
    f32 = fmap.float()
    s_div = torch.tensor(float(size), device=dev)
    r_div = torch.tensor(float(ratio), device=dev)
    grid = (torch.arange(size, dtype=torch.float32, device=dev)[:, None]
            + (torch.arange(ratio, dtype=torch.float32, device=dev)[None, :]
               + 0.5) / r_div).reshape(-1)

    def axis(lo, hi, dim):
        pos = (lo - 0.5)[:, None] + grid[None, :] * (
            (hi - lo).clamp(min=1e-6) / s_div)[:, None]
        ok = (pos >= -1.0) & (pos <= dim)
        pos = pos.clamp(0, dim - 1)
        i0 = pos.floor().long().clamp(0, dim - 1)
        i1 = (i0 + 1).clamp(max=dim - 1)
        return i0, i1, pos - i0.float(), ok

    y0, y1, ly, oky = axis(boxes[:, 1], boxes[:, 3], h)
    x0, x1, lx, okx = axis(boxes[:, 0], boxes[:, 2], w)
    img = image_index.long()[:, None, None]

    def at(yi, xi):
        return f32[img, yi[:, :, None], xi[:, None, :]]

    ly, lx = ly[:, :, None, None], lx[:, None, :, None]
    top = at(y0, x0) * (1.0 - lx) + at(y0, x1) * lx
    bot = at(y1, x0) * (1.0 - lx) + at(y1, x1) * lx
    val = top * (1.0 - ly) + bot * ly
    val = torch.where((oky[:, :, None] & okx[:, None, :])[..., None], val,
                      torch.zeros_like(val))
    return val.reshape(k, size, ratio, size, ratio, c).mean(dim=(2, 4)).to(
        fmap.dtype)
