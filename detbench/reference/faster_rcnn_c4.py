"""Faster R-CNN on a single C4 map (Ren et al., arXiv:1506.01497), plain
PyTorch: ResNet to c4, a 1x1 neck, the RPN, proposals (exact top-k,
decode, clip, greedy NMS), RoI Align, the two-FC head, per-class decode and
one class-offset NMS over the flattened (box, class) candidates.

Sizes come from the configuration file's ``sizes`` (the program's dotted
config fields); every precision follows ``common.Precision``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from detbench.reference import common as C



def _sizes(cfg):
    s = cfg["sizes"]
    return dict(
        blocks=C.RESNET_STAGES[s["backbone.name"]],
        neck=s["backbone.neck_channels"], rpn=s["rpn.conv_channels"],
        scales=s["anchors.scales"], ratios=s["anchors.aspect_ratios"],
        stride=s["anchors.stride"], classes=s["data.num_classes"],
        pool=s["roi.output_size"], ratio=s["roi.sampling_ratio"],
        fc=s["roi.fc_dim"], pre=s["rpn.pre_nms_topk_test"],
        post=s["rpn.post_nms_topk_test"], rpn_nms=s["rpn.nms_thresh"],
        min_size=s["rpn.min_box_size"], score=s["roi.score_thresh"],
        nms=s["roi.nms_thresh"], dets=s["roi.max_detections"],
        cands=s["roi.max_nms_candidates"], reg=s["roi.box_reg_weights"],
        mean=s["data.pixel_mean"], std=s["data.pixel_std"],
        buckets=s["data.aspect_buckets"])


def spec(cfg) -> list:
    """Every tensor of the program's state dict, with Flax's init as the
    default draw: lecun-normal kernels (untruncated), zero biases, frozen
    norms at the identity. The configuration's ``draws`` widen the heads."""
    z = _sizes(cfg)
    a = len(z["scales"]) * len(z["ratios"])
    out = C.resnet_draws("backbone", z["blocks"])
    c4 = C.RESNET_WIDTHS[2]
    layer = C.layer
    out += layer("neck_conv", z["neck"], c4, 1)
    out += layer("rpn_head.conv", z["rpn"], z["neck"], 3)
    out += layer("rpn_head.objectness", a, z["rpn"], 1, 0.01)
    out += layer("rpn_head.deltas", 4 * a, z["rpn"], 1, 0.01)
    flat = z["pool"] * z["pool"] * z["neck"]
    out += layer("det_head.fc1", z["fc"], flat)
    out += layer("det_head.fc2", z["fc"], z["fc"])
    out += layer("det_head.cls", z["classes"] + 1, z["fc"], 0, 0.01)
    out += layer("det_head.bbox", 4 * z["classes"], z["fc"], 0, 0.001)
    return out


def anchors(z, h: int, w: int, device) -> torch.Tensor:
    """``[H*W*A, 4]`` over the ``ceil(h / stride) x ceil(w / stride)`` grid,
    (y, x, a) row-major, scale varying slowest within a cell."""
    base = []
    for s in z["scales"]:
        for r in z["ratios"]:
            bw, bh = s / np.sqrt(r), s * np.sqrt(r)
            base.append([-bw / 2, -bh / 2, bw / 2, bh / 2])
    base = np.asarray(base, np.float32)
    st = z["stride"]
    gh, gw = -(-h // st), -(-w // st)
    cx = (np.arange(gw, dtype=np.float32) + 0.5) * st
    cy = (np.arange(gh, dtype=np.float32) + 0.5) * st
    cxv, cyv = np.meshgrid(cx, cy)
    ctr = np.stack([cxv, cyv, cxv, cyv], -1)
    return torch.from_numpy((ctr[:, :, None] + base[None, None]).reshape(
        -1, 4)).to(device)


def features(p, image_u8, z, prec):
    """uint8 canvases -> the neck's c4 map, NCHW."""
    x = C.normalize(image_u8, z["mean"], z["std"], prec.dtype)
    c4 = C.resnet(x, p, prec, z["blocks"], stop_at=4)[4]
    return F.relu(C.conv(c4, p, "neck_conv", prec, prec.dtype))


@torch.no_grad()
def predict(p: Dict[str, torch.Tensor], image_u8: torch.Tensor,
            image_hw: torch.Tensor, cfg, prec: C.Precision) -> dict:
    """One batch of uint8 canvases ``[B, H, W, 3]`` and their valid
    ``(h, w)`` -> ``boxes [B, D, 4]``, ``scores``, ``classes`` (1..C, 0
    where invalid) and ``valid``."""
    z = _sizes(cfg)
    dt = prec.dtype
    b, h, w = image_u8.shape[:3]
    hw = image_hw.float()
    feat = features(p, image_u8, z, prec)
    x = F.relu(C.conv(feat, p, "rpn_head.conv", prec, dt, 1, "same"))
    logits = C.conv(x, p, "rpn_head.objectness", prec, dt).permute(
        0, 2, 3, 1).reshape(b, -1).float()
    deltas = C.conv(x, p, "rpn_head.deltas", prec, dt).permute(
        0, 2, 3, 1).reshape(b, -1, 4).float()
    anc = anchors(z, h, w, feat.device)
    k = min(anc.shape[0], z["pre"])
    top = torch.sort(logits, dim=-1, descending=True, stable=True)
    idx = top.indices[:, :k]
    scores = torch.sigmoid(top.values[:, :k])
    rows = torch.arange(b, device=feat.device)[:, None]
    boxes = C.clip_to(C.decode(deltas[rows, idx], anc[idx]), hw[:, None, :])
    wh = boxes[..., 2:] - boxes[..., :2]
    ok = (wh[..., 0] > z["min_size"]) & (wh[..., 1] > z["min_size"])
    keep, pvalid = C.greedy_nms(boxes, scores, ok, z["rpn_nms"], z["post"])
    props = boxes[rows, keep]
    n = props.shape[1]
    fmap = feat.permute(0, 2, 3, 1)
    image_index = torch.arange(b, device=feat.device).repeat_interleave(n)
    pooled = C.roi_align(fmap, (props / float(z["stride"])).reshape(-1, 4),
                         image_index, z["pool"], z["ratio"])
    y = F.relu(C.dense(pooled.reshape(b * n, -1), p, "det_head.fc1", prec, dt))
    y = F.relu(C.dense(y, p, "det_head.fc2", prec, dt))
    cls = C.dense(y, p, "det_head.cls", prec, dt).float().reshape(b, n, -1)
    box = C.dense(y, p, "det_head.bbox", prec, dt).float().reshape(
        b, n, -1, 4)
    probs = torch.softmax(cls, dim=-1)[..., 1:]
    c = probs.shape[-1]
    det = C.clip_to(C.decode(box, props[:, :, None, :].expand(b, n, c, 4),
                             z["reg"]), hw[:, None, None, :])
    flat_boxes = det.reshape(b, n * c, 4)
    flat_scores = probs.reshape(b, n * c)
    flat_cls = torch.arange(1, c + 1, device=feat.device).repeat(n)
    live = pvalid.repeat_interleave(c, dim=1) & (flat_scores > z["score"])
    cap = min(n * c, z["cands"] or 1024)
    order = torch.sort(torch.where(live, flat_scores, -1.0), dim=-1,
                       descending=True, stable=True)
    cs, ci = order.values[:, :cap], order.indices[:, :cap]
    cb = flat_boxes[rows, ci]
    cc = flat_cls[ci]
    offset = 4096.0
    while offset <= max(max(bh, bw) for bh, bw in z["buckets"]):
        offset *= 2.0
    shifted = cb + cc[..., None].float() * offset
    keep, valid = C.greedy_nms(shifted, cs, cs > 0, z["nms"], z["dets"])
    return {"boxes": cb[rows, keep],
            "scores": torch.where(valid, cs[rows, keep], 0.0),
            "classes": torch.where(valid, cc[rows, keep], 0),
            "valid": valid}


def kept(cfg):
    """``(max_detections, score_thresh)`` of the final selection."""
    z = _sizes(cfg)
    return z["dets"], z["score"]
