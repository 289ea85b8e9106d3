"""ViTDet Faster R-CNN (Li et al., arXiv:2203.16527), plain PyTorch: a plain
ViT with windowed and global attention and decomposed relative positions,
the simple feature pyramid p2..p6, the RPN shared over the levels,
proposals (per-level exact top-k, decode, clip, one greedy NMS over the
levels' union with each level's boxes shifted apart), RoI Align of each
proposal at its level, the two-FC head, per-class decode and one
class-offset NMS over the flattened (box, class) candidates.

The backbone follows detectron2's ``modeling/backbone/vit.py`` and
``utils.py`` (``window_partition`` with zero padding after ``norm1``,
``get_rel_pos``, ``add_decomposed_rel_pos``) and the pyramid its
``SimpleFeaturePyramid`` with LayerNorm. Departures from detectron2's
``mask_rcnn_vitdet_b_100ep.py``, each the configuration's ``assumed``:

* box-only Faster R-CNN (no mask branch), the 2fc-1024 box head in place of
  the 4conv1fc head with LayerNorm, one 3x3 RPN conv in place of two;
* RoI Align with 2 samples a bin side in place of an adaptive count, each
  RoI at the FPN paper's level bumped up until its longer side spans at
  most ``roi.window - 12`` cells of the level (the port's windowed
  pooler);
* the absolute position embedding held on a ``vit_pos_grid`` grid and
  resized to the token grid (detectron2 keeps a 14-grid from pretraining
  and interpolates it);
* no drop-path (inference), LayerNorm epsilon 1e-6 throughout.

Every layer computes as the configuration states (``common.Precision``):
products of the block dtype's operands with f32 sums, f32 attention logits
and their f32 relative-position terms, an f32 softmax whose
probabilities go back to the block dtype for the product with v, f32
LayerNorms. Sizes come from the configuration file's ``sizes``. Nothing
here imports the program; ``predict`` runs with TF32 off.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from detbench.reference import common as C

# name -> (width, depth, heads): the paper's variants and a test size.
VARIANTS = {"vit_s": (384, 12, 6), "vit_b": (768, 12, 12),
            "vit_l": (1024, 24, 16), "vit_tiny": (32, 2, 2)}
PATCH = 16
PYRAMID = 256  # the simple feature pyramid's width (detectron2's)
LEVELS = ("p2", "p3", "p4", "p5")
LN_EPS = 1e-6


def _sizes(cfg):
    s = cfg["sizes"]
    dim, depth, heads = VARIANTS[s["backbone.name"]]
    return dict(
        dim=dim, depth=depth, heads=heads, window=s["backbone.vit_window"],
        every=s["backbone.vit_global_attn_every"],
        grid=s["backbone.vit_pos_grid"], rel=s["backbone.vit_rel_pos"],
        strides=s["anchors.fpn_strides"], scales=s["anchors.fpn_scales"],
        octaves=s["anchors.fpn_octave_scales"],
        ratios=s["anchors.aspect_ratios"], classes=s["data.num_classes"],
        rpn=s["rpn.conv_channels"],
        pre=s["rpn.fpn_pre_nms_topk_per_level_test"],
        post=s["rpn.post_nms_topk_test"], rpn_nms=s["rpn.nms_thresh"],
        min_size=s["rpn.min_box_size"], pool=s["roi.output_size"],
        ratio=s["roi.sampling_ratio"], fit=s["roi.window"],
        fc=s["roi.fc_dim"], score=s["roi.score_thresh"],
        nms=s["roi.nms_thresh"], dets=s["roi.max_detections"],
        cands=s["roi.max_nms_candidates"], reg=s["roi.box_reg_weights"],
        mean=s["data.pixel_mean"], std=s["data.pixel_std"],
        buckets=s["data.aspect_buckets"])


def is_global(i: int, every: int) -> bool:
    return (i + 1) % every == 0


# ------------------------------------------------------------------ spec
def _norm(name: str, n: int) -> list:
    return [(f"{name}.weight", (n,), ("const", 1.0)),
            (f"{name}.bias", (n,), ("const", 0.0))]


def _deconv(name: str, cin: int, cout: int) -> list:
    """A 2x2 stride-2 transposed conv, torch's ``[in, out, 2, 2]`` weight,
    lecun-normal over the fan-in ``4 * in``."""
    return [(f"{name}.weight", (cin, cout, 2, 2),
             ("normal", 0.0, 1.0 / math.sqrt(4 * cin))),
            (f"{name}.bias", (cout,), ("const", 0.0))]


def spec(cfg) -> list:
    """Every tensor of the program's state dict, with Flax's init as the
    default draw: lecun-normal kernels (untruncated), zero biases,
    LayerNorms at the identity, the position embedding at 0.02 and the
    relative-position tables at zero (detectron2's). The configuration's
    ``draws`` widen the tables and the heads."""
    z = _sizes(cfg)
    d, hd = z["dim"], z["dim"] // z["heads"]
    layer = C.layer
    out = [("backbone.pos_embed", (1, z["grid"], z["grid"], d),
            ("normal", 0.0, 0.02))]
    out += layer("backbone.patch_embed", d, 3, PATCH)
    for i in range(z["depth"]):
        blk = f"backbone.block{i}"
        out += _norm(f"{blk}.norm1", d)
        if z["rel"]:
            side = z["grid"] if is_global(i, z["every"]) else z["window"]
            out += [(f"{blk}.attn.rel_pos_{a}", (2 * side - 1, hd),
                     ("const", 0.0)) for a in "hw"]
        for proj in ("query", "key", "value", "out"):
            out += layer(f"{blk}.attn.{proj}", d, d)
        out += _norm(f"{blk}.norm2", d)
        out += layer(f"{blk}.mlp_fc1", 4 * d, d)
        out += layer(f"{blk}.mlp_fc2", d, 4 * d)
    out += _norm("backbone.norm", d)
    out += _deconv("fpn.up4_deconv1", d, d // 2)
    out += _norm("fpn.up4_ln", d // 2)
    out += _deconv("fpn.up4_deconv2", d // 2, d // 4)
    out += _deconv("fpn.up2_deconv", d, d // 2)
    in_ch = {"p2": d // 4, "p3": d // 2, "p4": d, "p5": d}
    for name in LEVELS:
        out += layer(f"fpn.{name}_proj", PYRAMID, in_ch[name], 1)[:1]
        out += _norm(f"fpn.{name}_proj_ln", PYRAMID)
        out += layer(f"fpn.{name}_out", PYRAMID, PYRAMID, 3)[:1]
        out += _norm(f"fpn.{name}_out_ln", PYRAMID)
    a = len(z["octaves"]) * len(z["ratios"])
    out += layer("rpn_head.conv", z["rpn"], PYRAMID, 3)
    out += layer("rpn_head.objectness", a, z["rpn"], 1, 0.01)
    out += layer("rpn_head.deltas", 4 * a, z["rpn"], 1, 0.01)
    flat = z["pool"] * z["pool"] * PYRAMID
    out += layer("det_head.fc1", z["fc"], flat)
    out += layer("det_head.fc2", z["fc"], z["fc"])
    out += layer("det_head.cls", z["classes"] + 1, z["fc"], 0, 0.01)
    out += layer("det_head.bbox", 4 * z["classes"], z["fc"], 0, 0.001)
    return out


# -------------------------------------------------------------- backbone
def layer_norm(x, p, name: str) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (an f32 result)."""
    return F.layer_norm(x.float(), (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], LN_EPS)


def resize_pos(pos: torch.Tensor, hw) -> torch.Tensor:
    """``[1, g, g, D]`` -> ``[1, h, w, D]`` f32: bilinear with half-pixel
    centres, antialiased where it shrinks."""
    if tuple(pos.shape[1:3]) == tuple(hw):
        return pos.float()
    out = F.interpolate(pos.float().permute(0, 3, 1, 2), size=tuple(hw),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def resize_rows(table: torch.Tensor, rows: int) -> torch.Tensor:
    """``table`` ``[n, C]`` linearly resampled to ``rows`` rows, half-pixel
    centres, the edges clamped (``F.interpolate``'s "linear")."""
    n = table.shape[0]
    if n == rows:
        return table
    dev = table.device
    src = ((torch.arange(rows, dtype=torch.float32, device=dev) + 0.5)
           * (n / rows) - 0.5).clamp(min=0.0)
    lo = src.floor().long().clamp(max=n - 1)
    hi = (lo + 1).clamp(max=n - 1)
    frac = (src - lo.float())[:, None]
    return table[lo] * (1.0 - frac) + table[hi] * frac


def rel_table(q_size: int, k_size: int, table: torch.Tensor) -> torch.Tensor:
    """detectron2's ``get_rel_pos``: ``[q_size, k_size, C]``, each query
    and key position's row of the table resized to ``2 max(q, k) - 1``
    rows."""
    table = resize_rows(table, 2 * max(q_size, k_size) - 1)
    qs, ks = max(k_size / q_size, 1.0), max(q_size / k_size, 1.0)
    idx = [[int(i * qs - j * ks + (k_size - 1) * ks) for j in range(k_size)]
           for i in range(q_size)]
    return table[torch.tensor(idx, device=table.device)]


def attention(y, p, name: str, prec, z, hw) -> torch.Tensor:
    """``[N, L, D]`` tokens of an ``hw`` grid -> the attention's output,
    in the block dtype."""
    dt = prec.dtype
    n, l, d = y.shape
    heads = z["heads"]
    hd = d // heads

    def proj(which):
        return C.dense(y, p, f"{name}.{which}", prec, dt).reshape(
            n, l, heads, hd).transpose(1, 2)

    q, k, v = proj("query"), proj("key"), proj("value")
    qf = prec.operand(q, dt).float()
    logits = (qf * hd ** -0.5) @ prec.operand(k, dt).float().transpose(-1,
                                                                      -2)
    if z["rel"]:
        gh, gw = hw
        rq = prec.operand(qf, torch.float32).reshape(n, heads, gh, gw, hd)
        rh = prec.operand(rel_table(gh, gh, p[f"{name}.rel_pos_h"]),
                          torch.float32)
        rw = prec.operand(rel_table(gw, gw, p[f"{name}.rel_pos_w"]),
                          torch.float32)
        rel_h = torch.einsum("nhyxc,ykc->nhyxk", rq, rh)
        rel_w = torch.einsum("nhyxc,xkc->nhyxk", rq, rw)
        logits = (logits.view(n, heads, gh, gw, gh, gw)
                  + rel_h[..., :, None] + rel_w[..., None, :]).view(n, heads,
                                                                    l, l)
    probs = torch.softmax(logits, dim=-1)
    out = prec.operand(probs, dt) @ prec.operand(v, dt)
    return C.dense(out.transpose(1, 2).reshape(n, l, d), p, f"{name}.out",
                   prec, dt)


def block(x, p, i: int, prec, z) -> torch.Tensor:
    """One pre-LN block over the NHWC grid ``x`` (the block dtype)."""
    dt = prec.dtype
    b, h, w, d = x.shape
    name = f"backbone.block{i}"
    y = layer_norm(x, p, f"{name}.norm1").to(dt)
    if is_global(i, z["every"]):
        y = attention(y.reshape(b, h * w, d), p, f"{name}.attn", prec, z,
                      (h, w)).reshape(b, h, w, d)
    else:
        s = z["window"]
        ph, pw = (-h) % s, (-w) % s
        y = F.pad(y, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        win = y.reshape(b, hp // s, s, wp // s, s, d).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, s * s, d)
        win = attention(win, p, f"{name}.attn", prec, z, (s, s))
        y = win.reshape(b, hp // s, wp // s, s, s, d).permute(
            0, 1, 3, 2, 4, 5).reshape(b, hp, wp, d)[:, :h, :w]
    x = x + y
    y = layer_norm(x, p, f"{name}.norm2").to(dt)
    y = F.gelu(C.dense(y, p, f"{name}.mlp_fc1", prec, dt))
    return x + C.dense(y, p, f"{name}.mlp_fc2", prec, dt)


def vit(p, x, z, prec) -> torch.Tensor:
    """NCHW image in the block dtype -> the NHWC stride-16 token grid."""
    dt = prec.dtype
    x = C.conv(x, p, "backbone.patch_embed", prec, dt, PATCH, "same")
    x = x.permute(0, 2, 3, 1)
    x = x + resize_pos(p["backbone.pos_embed"], x.shape[1:3]).to(dt)
    for i in range(z["depth"]):
        x = block(x, p, i, prec, z)
    return layer_norm(x, p, "backbone.norm").to(dt)


def pyramid(p, grid, prec) -> Dict[str, torch.Tensor]:
    """detectron2's simple feature pyramid: ``{"p2".."p6"}`` NCHW maps."""
    dt = prec.dtype

    def ln(name, y):  # over the channels of an NCHW map
        return layer_norm(y.permute(0, 2, 3, 1), p, name).to(dt).permute(
            0, 3, 1, 2)

    def deconv(name, y):
        return F.conv_transpose2d(prec.operand(y, dt),
                                  prec.operand(p[f"{name}.weight"], dt),
                                  p[f"{name}.bias"].to(dt), stride=2)

    x = grid.permute(0, 3, 1, 2)
    scaled = {
        "p2": deconv("fpn.up4_deconv2",
                     F.gelu(ln("fpn.up4_ln", deconv("fpn.up4_deconv1", x)))),
        "p3": deconv("fpn.up2_deconv", x),
        "p4": x,
        "p5": F.max_pool2d(x, 2, 2, ceil_mode=True),
    }
    out = {}
    for name, y in scaled.items():
        y = ln(f"fpn.{name}_proj_ln", C.conv(y, p, f"fpn.{name}_proj", prec,
                                             dt))
        out[name] = ln(f"fpn.{name}_out_ln",
                       C.conv(y, p, f"fpn.{name}_out", prec, dt, 1, 1))
    out["p6"] = F.max_pool2d(out["p5"], 1, 2)
    return out


# -------------------------------------------------------------- detector
def anchors(z, h: int, w: int, device) -> List[torch.Tensor]:
    """Per level ``[H*W*A, 4]`` over its ``ceil(h / s) x ceil(w / s)`` grid,
    (y, x, a) row-major, one scale per level times the octaves, every
    ratio."""
    out = []
    for st, scale in zip(z["strides"], z["scales"]):
        base = []
        for o in z["octaves"]:
            for r in z["ratios"]:
                s = scale * o
                bw, bh = s / np.sqrt(r), s * np.sqrt(r)
                base.append([-bw / 2, -bh / 2, bw / 2, bh / 2])
        base = np.asarray(base, np.float32)
        gh, gw = -(-h // st), -(-w // st)
        cx = (np.arange(gw, dtype=np.float32) + 0.5) * st
        cy = (np.arange(gh, dtype=np.float32) + 0.5) * st
        cxv, cyv = np.meshgrid(cx, cy)
        ctr = np.stack([cxv, cyv, cxv, cyv], -1)
        out.append(torch.from_numpy(
            (ctr[:, :, None] + base[None, None]).reshape(-1, 4)).to(device))
    return out


def _offset(z) -> float:
    offset = 4096.0
    while offset <= max(max(bh, bw) for bh, bw in z["buckets"]):
        offset *= 2.0
    return offset


def levels_of(boxes, fit: int) -> torch.Tensor:
    """The FPN paper's level ``floor(4 + log2(sqrt(area) / 224))`` in
    2..5, raised until the box's longer side spans at most ``fit - 12``
    cells of its level."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0)
    k = torch.floor(4 + torch.log2(torch.sqrt(w * h) / 224 + 1e-8))
    need = torch.ceil(torch.log2(torch.maximum(w, h).clamp(min=1.0)
                                 / (fit - 12)))
    return torch.maximum(k.clamp(2, 5), need).clamp(2, 5).long()


def proposals(logits, deltas, anc, hw, z):
    """Per level the top ``pre`` logits, decoded and clipped, then one
    greedy NMS over the levels' union, each level's boxes shifted apart ->
    ``(boxes [B, post, 4], valid)``."""
    b = logits[0].shape[0]
    rows = torch.arange(b, device=hw.device)[:, None]
    boxes, scores, level = [], [], []
    for li, (lg, dl, a) in enumerate(zip(logits, deltas, anc)):
        k = min(a.shape[0], z["pre"])
        top = torch.sort(lg, dim=-1, descending=True, stable=True)
        idx = top.indices[:, :k]
        boxes.append(C.clip_to(C.decode(dl[rows, idx], a[idx]),
                               hw[:, None, :]))
        scores.append(torch.sigmoid(top.values[:, :k]))
        level.append(torch.full((b, k), li + 1.0, device=hw.device))
    boxes, scores = torch.cat(boxes, 1), torch.cat(scores, 1)
    level = torch.cat(level, 1)
    wh = boxes[..., 2:] - boxes[..., :2]
    ok = (wh[..., 0] > z["min_size"]) & (wh[..., 1] > z["min_size"])
    keep, valid = C.greedy_nms(boxes + level[..., None] * _offset(z), scores,
                               ok, z["rpn_nms"], z["post"])
    return boxes[rows, keep], valid


def pool(feats, props, z) -> torch.Tensor:
    """Each proposal's RoI Align at its level -> ``[B * N, S, S, C]``."""
    b, n = props.shape[:2]
    flat = props.reshape(-1, 4)
    image_index = torch.arange(b, device=props.device).repeat_interleave(n)
    level = levels_of(flat, z["fit"])
    out = None
    for li, name in enumerate(LEVELS):
        pick = torch.nonzero(level == li + 2).flatten()
        if not len(pick):
            continue
        fmap = feats[name].permute(0, 2, 3, 1)
        got = C.roi_align(fmap, flat[pick] / float(2 ** (li + 2)),
                          image_index[pick], z["pool"], z["ratio"])
        if out is None:
            out = got.new_zeros((b * n,) + got.shape[1:])
        out[pick] = got
    return out


@torch.no_grad()
def predict(p: Dict[str, torch.Tensor], image_u8: torch.Tensor,
            image_hw: torch.Tensor, cfg, prec: C.Precision) -> dict:
    """One batch of uint8 canvases ``[B, H, W, 3]`` and their valid
    ``(h, w)`` -> ``boxes [B, D, 4]``, ``scores``, ``classes`` (1..C, 0
    where invalid) and ``valid``; TF32 off, as it was found after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _predict(p, image_u8, image_hw, cfg, prec)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _predict(p, image_u8, image_hw, cfg, prec):
    z = _sizes(cfg)
    dt = prec.dtype
    b, h, w = image_u8.shape[:3]
    hw = image_hw.float()
    x = C.normalize(image_u8, z["mean"], z["std"], dt)
    feats = pyramid(p, vit(p, x, z, prec), prec)
    logits, deltas = [], []
    for name in ("p2", "p3", "p4", "p5", "p6"):
        y = F.relu(C.conv(feats[name], p, "rpn_head.conv", prec, dt, 1,
                          "same"))
        logits.append(C.conv(y, p, "rpn_head.objectness", prec, dt).permute(
            0, 2, 3, 1).reshape(b, -1).float())
        deltas.append(C.conv(y, p, "rpn_head.deltas", prec, dt).permute(
            0, 2, 3, 1).reshape(b, -1, 4).float())
    props, pvalid = proposals(logits, deltas, anchors(z, h, w, hw.device),
                              hw, z)
    n = props.shape[1]
    pooled = pool(feats, props, z)
    y = F.relu(C.dense(pooled.reshape(b * n, -1), p, "det_head.fc1", prec,
                       dt))
    y = F.relu(C.dense(y, p, "det_head.fc2", prec, dt))
    cls = C.dense(y, p, "det_head.cls", prec, dt).float().reshape(b, n, -1)
    box = C.dense(y, p, "det_head.bbox", prec, dt).float().reshape(
        b, n, -1, 4)
    probs = torch.softmax(cls, dim=-1)[..., 1:]
    c = probs.shape[-1]
    det = C.clip_to(C.decode(box, props[:, :, None, :].expand(b, n, c, 4),
                             z["reg"]), hw[:, None, None, :])
    rows = torch.arange(b, device=hw.device)[:, None]
    flat_boxes = det.reshape(b, n * c, 4)
    flat_scores = probs.reshape(b, n * c)
    flat_cls = torch.arange(1, c + 1, device=hw.device).repeat(n)
    live = pvalid.repeat_interleave(c, dim=1) & (flat_scores > z["score"])
    cap = min(n * c, z["cands"] or 1024)
    order = torch.sort(torch.where(live, flat_scores, -1.0), dim=-1,
                       descending=True, stable=True)
    cs, ci = order.values[:, :cap], order.indices[:, :cap]
    cb = flat_boxes[rows, ci]
    cc = flat_cls[ci]
    shifted = cb + cc[..., None].float() * _offset(z)
    keep, valid = C.greedy_nms(shifted, cs, cs > 0, z["nms"], z["dets"])
    return {"boxes": cb[rows, keep],
            "scores": torch.where(valid, cs[rows, keep], 0.0),
            "classes": torch.where(valid, cc[rows, keep], 0),
            "valid": valid}


def kept(cfg):
    """``(max_detections, score_thresh)`` of the final selection."""
    z = _sizes(cfg)
    return z["dets"], z["score"]
