"""Deformable DETR with iterative box refinement (Zhu et al.,
arXiv:2010.04159), plain PyTorch: ResNet to c5, 1x1 projections of c3..c5
and 3x3/2 extra levels with GroupNorm over the valid positions, the sine
position embedding, a post-norm encoder of multi-scale deformable
self-attention, a decoder of dense self-attention and deformable
cross-attention, per-layer class and box heads, and the top-k over the
(query, class) sigmoid scores.

The deformable sampling is ``F.grid_sample`` per level, the official
implementation's plain form (``ms_deform_attn_core_pytorch``), and shares
nothing with the program's gather. Sizes come from the configuration's
``sizes``; precisions follow ``common.Precision``: the value, output, FFN,
dense-attention and first two box layers in the model dtype, the offset,
attention-weight, reference-point, class and last box layers in f32, the
norms' statistics in f32 and the residual stream f32 after the first norm.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from detbench.reference import common as C

F32 = torch.float32


def _sizes(cfg):
    s = cfg["sizes"]
    d = {k.split(".", 1)[1]: v for k, v in s.items()
         if k.startswith("deformable_detr.")}
    return dict(
        blocks=C.RESNET_STAGES[s["backbone.name"]], d=d["d_model"],
        heads=d["num_heads"], enc=d["enc_layers"], dec=d["dec_layers"],
        ffn=d["ffn_dim"], queries=d["num_queries"], levels=d["num_levels"],
        points=d["num_points"], refine=d["with_box_refine"],
        classes=s["data.num_classes"], dets=d["max_detections"],
        score=d["score_thresh"], mean=s["data.pixel_mean"],
        std=s["data.pixel_std"])


def offset_probe(heads: int, levels: int, points: int) -> torch.Tensor:
    """The official sampling-offset bias: head k looks along 2πk/H at radius
    p + 1 for its p-th point, at every level."""
    t = torch.arange(heads, dtype=F32) * (2.0 * math.pi / heads)
    g = torch.stack([torch.cos(t), torch.sin(t)], -1)
    g = g / g.abs().amax(-1, keepdim=True)
    g = g[:, None, None, :].repeat(1, levels, points, 1)
    return (g * torch.arange(1, points + 1, dtype=F32)[None, None, :, None]
            ).reshape(-1)


def spec(cfg) -> list:
    """Every tensor of the program's state dict with Flax's init as the
    default draw (the configuration's ``draws`` widen the degenerate ones)."""
    z = _sizes(cfg)
    d, h, lv, pt = z["d"], z["heads"], z["levels"], z["points"]
    out = C.resnet_draws("backbone", z["blocks"])

    def lin(name, o, i, k=0, bias=("const", 0.0), std=None):
        return C.layer(name, o, i, k, std, bias)

    def norm(name, n):
        return [(f"{name}.weight", (n,), ("const", 1.0)),
                (f"{name}.bias", (n,), ("const", 0.0))]

    widths = C.RESNET_WIDTHS
    for i in range(3):
        out += lin(f"input_proj{i}", d, widths[i + 1], 1)
        out += norm(f"input_norm{i}", d)
    in_ch = widths[3]
    for i in range(lv - 3):
        out += lin(f"extra_proj{i}", d, in_ch, 3)
        out += norm(f"extra_norm{i}", d)
        in_ch = d
    out.append(("level_embed", (lv, d), ("normal", 0.0, 1.0)))
    probe = ("values", offset_probe(h, lv, pt))

    def deform(name):
        return (lin(f"{name}.value", d, d)
                + lin(f"{name}.sampling_offsets", h * lv * pt * 2, d,
                      bias=probe, std=0.0)
                + lin(f"{name}.attention_weights", h * lv * pt, d, std=0.0)
                + lin(f"{name}.out", d, d))

    for i in range(z["enc"]):
        out += deform(f"enc{i}.deform_attn") + norm(f"enc{i}.norm1", d)
        out += lin(f"enc{i}.ffn.fc1", z["ffn"], d) + lin(f"enc{i}.ffn.fc2", d,
                                                         z["ffn"])
        out += norm(f"enc{i}.norm2", d)
    for i in range(z["dec"]):
        for part in ("query", "key", "value", "out"):
            out += lin(f"dec{i}.self_attn.{part}", d, d)
        out += norm(f"dec{i}.norm1", d) + deform(f"dec{i}.cross_attn")
        out += norm(f"dec{i}.norm2", d)
        out += lin(f"dec{i}.ffn.fc1", z["ffn"], d) + lin(f"dec{i}.ffn.fc2", d,
                                                         z["ffn"])
        out += norm(f"dec{i}.norm3", d)
    out.append(("query_embed", (z["queries"], 2 * d), ("normal", 0.0, 1.0)))
    out += lin("ref_point_head", 2, d)
    prior = -math.log((1.0 - 0.01) / 0.01)
    for i in range(z["dec"] if z["refine"] else 1):
        out += lin(f"class_head{i}", z["classes"], d, bias=("const", prior))
        out += lin(f"bbox_head{i}.fc0", d, d) + lin(f"bbox_head{i}.fc1", d, d)
        out += lin(f"bbox_head{i}.out", 4, d, std=0.0)
    return out


def layer_norm(x, p, name):
    """Flax's LayerNorm: f32 statistics as ``E[x^2] - E[x]^2``, eps 1e-6, an
    f32 output."""
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp(min=0)
    return ((x - mean) * (torch.rsqrt(var + 1e-6) * p[f"{name}.weight"])
            + p[f"{name}.bias"])


def masked_group_norm(x, valid, p, name, groups):
    """GroupNorm over the valid positions of NHWC ``x`` (eps 1e-5), f32
    statistics, output in ``x``'s dtype."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, groups, c // groups)
    m = valid.reshape(b, h * w, 1, 1).float()
    n = (m.sum(1, keepdim=True) * (c // groups)).clamp(min=1.0)
    mean = (xf * m).sum((1, 3), keepdim=True) / n
    var = ((xf - mean).square() * m).sum((1, 3), keepdim=True) / n
    y = ((xf - mean) * torch.rsqrt(var + 1e-5)).reshape(b, h, w, c)
    return (y * p[f"{name}.weight"] + p[f"{name}.bias"]).to(x.dtype)


def sine_embedding(valid, d, temperature=10000.0):
    """``[B, H, W]`` validity -> ``[B, H, W, d]`` f32: cumulative valid
    positions scaled to 2π, y then x, sin/cos over a geometric ladder."""
    m = valid.float()
    y = torch.cumsum(m, 1)
    x = torch.cumsum(m, 2)
    y = y / (y[:, -1:, :] + 1e-6) * (2 * math.pi)
    x = x / (x[:, :, -1:] + 1e-6) * (2 * math.pi)
    half = d // 2
    steps = torch.arange(half, device=m.device) // 2
    dim_t = temperature ** (2.0 * steps.float() / half)
    py, px = y[..., None] / dim_t, x[..., None] / dim_t
    shape = valid.shape + (half,)
    py = torch.stack([py[..., 0::2].sin(), py[..., 1::2].cos()], -1).reshape(
        shape)
    px = torch.stack([px[..., 0::2].sin(), px[..., 1::2].cos()], -1).reshape(
        shape)
    return torch.cat([py, px], -1)


def sample(value, shapes, loc, attn, chunk=4096):
    """Multi-scale deformable attention by ``F.grid_sample``: ``value [B, N,
    H, D]``, ``loc [B, Q, H, L, P, 2]`` (x, y) in [0, 1] of each level's
    grid, ``attn [B, Q, H, L, P]`` -> ``[B, Q, H, D]`` f32."""
    b, n, h, d = value.shape
    q, lv, pt = loc.shape[1], loc.shape[3], loc.shape[4]
    out = value.new_zeros((b, h, d, q), dtype=F32)
    start = 0
    for li, (hl, wl) in enumerate(shapes):
        v = value[:, start:start + hl * wl].float().permute(0, 2, 3, 1)
        v = v.reshape(b * h, d, hl, wl)
        start += hl * wl
        for q0 in range(0, q, chunk):
            g = loc[:, q0:q0 + chunk, :, li] * 2.0 - 1.0  # [B, q, H, P, 2]
            g = g.permute(0, 2, 1, 3, 4).reshape(b * h, -1, pt, 2)
            s = F.grid_sample(v, g.float(), mode="bilinear",
                              padding_mode="zeros", align_corners=False)
            a = attn[:, q0:q0 + chunk, :, li].permute(0, 2, 1, 3).reshape(
                b * h, 1, -1, pt)
            out[:, :, :, q0:q0 + chunk] += (s * a).sum(-1).reshape(b, h, d, -1)
    return out.permute(0, 3, 1, 2)


def deform_attn(p, name, query, ref_xy, ref_wh, memory, valid, shapes, z,
                prec):
    dt = prec.dtype
    h, lv, pt = z["heads"], z["levels"], z["points"]
    b, nq, d = query.shape
    value = C.dense(memory, p, f"{name}.value", prec, dt)
    value = value.masked_fill(~valid[..., None], 0.0).reshape(b, -1, h,
                                                              d // h)
    q32 = query.float()
    attn = C.dense(q32, p, f"{name}.attention_weights", prec, F32)
    attn = torch.softmax(attn.reshape(b, nq, h, lv * pt), -1).reshape(
        b, nq, h, lv, pt)
    off = C.dense(q32, p, f"{name}.sampling_offsets", prec, F32).reshape(
        b, nq, h, lv, pt, 2)
    ref = ref_xy[:, :, None, :, None, :]
    if ref_wh is None:
        norm = torch.tensor([[wl, hl] for hl, wl in shapes], dtype=F32,
                            device=query.device)
        loc = ref + off / norm[None, None, None, :, None, :]
    else:
        loc = ref + off / float(pt) * ref_wh[:, :, None, :, None, :] * 0.5
    out = sample(value, shapes, loc, attn)
    return C.dense(out.reshape(b, nq, d).to(dt), p, f"{name}.out", prec, dt)


def ffn(p, name, x, prec, gen=None, rate=0.0):
    dt = prec.dtype
    y = F.relu(C.dense(x, p, f"{name}.fc1", prec, dt))
    return C.dense(dropout(y, rate, gen), p, f"{name}.fc2", prec, dt)


def dropout(x, rate, gen):
    """Flax's dropout over an explicit generator (None: off)."""
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def self_attention(p, name, q_in, v_in, z, prec, gen=None, rate=0.0):
    dt = prec.dtype
    b, nq, d = q_in.shape
    h = z["heads"]
    hd = d // h
    q = C.dense(q_in, p, f"{name}.query", prec, dt).reshape(b, nq, h, hd)
    k = C.dense(q_in, p, f"{name}.key", prec, dt).reshape(b, nq, h, hd)
    v = C.dense(v_in, p, f"{name}.value", prec, dt).reshape(b, nq, h, hd)
    root = torch.full((), float(np.float32(math.sqrt(hd))), dtype=dt,
                      device=q.device)
    logits = torch.einsum("bqhd,bkhd->bhqk", prec.operand(q / root, dt),
                          prec.operand(k, dt))
    attn = torch.softmax(logits, -1)
    if gen is not None and rate > 0.0:
        keep = torch.rand((1, 1) + attn.shape[-2:], generator=gen,
                          device=attn.device) < 1.0 - rate
        attn = attn * (keep.to(attn.dtype) / torch.full(
            (), 1.0 - rate, dtype=attn.dtype, device=attn.device))
    x = torch.einsum("bhqk,bkhd->bqhd", prec.operand(attn, dt),
                     prec.operand(v, dt))
    return C.dense(x.reshape(b, nq, d), p, f"{name}.out", prec, dt)


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps)) - torch.log((1.0 - x).clamp(min=eps))


def forward(p, image, image_hw, cfg, prec, gen: Optional[torch.Generator]
            = None):
    """Normalized NCHW ``image`` and ``[B, 2]`` (h, w) -> per decoder layer
    ``[L, B, Q, C]`` logits and ``[L, B, Q, 4]`` (cx, cy, w, h) boxes.
    ``gen`` draws the dropout masks, in the program's order."""
    z = _sizes(cfg)
    dt, d = prec.dtype, z["d"]
    rate = (cfg["sizes"]["deformable_detr.dropout"] if gen is not None
            else 0.0)
    feats = C.resnet(image, p, prec, z["blocks"], stop_at=5)
    maps = [C.conv(feats[i + 3], p, f"input_proj{i}", prec, dt)
            for i in range(3)]
    x = feats[5]
    for i in range(z["levels"] - 3):
        x = C.conv(x, p, f"extra_proj{i}", prec, dt, 2, 1)
        maps.append(x)
    names = ([f"input_norm{i}" for i in range(3)]
             + [f"extra_norm{i}" for i in range(z["levels"] - 3)])
    b = image.shape[0]
    dev = image.device
    shapes, tokens, poss, valids, ratios = [], [], [], [], []
    for li, m in enumerate(maps):
        m = m.permute(0, 2, 3, 1)
        hf, wf = m.shape[1:3]
        shapes.append((hf, wf))
        stride = 8 * 2 ** li
        ys = torch.arange(hf, dtype=F32, device=dev) * stride
        xs = torch.arange(wf, dtype=F32, device=dev) * stride
        valid = ((ys[None, :, None] < image_hw[:, 0, None, None])
                 & (xs[None, None, :] < image_hw[:, 1, None, None]))
        m = masked_group_norm(m, valid, p, names[li], min(32, d))
        pos = sine_embedding(valid, d).to(dt) + p["level_embed"][li].to(dt)
        tokens.append(m.reshape(b, -1, d))
        poss.append(pos.reshape(b, -1, d))
        valids.append(valid.reshape(b, -1))
        vh = (image_hw[:, 0] / float(stride * hf)).clamp(max=1.0)
        vw = (image_hw[:, 1] / float(stride * wf)).clamp(max=1.0)
        ratios.append(torch.stack([vw, vh], -1))
    src, pos = torch.cat(tokens, 1), torch.cat(poss, 1)
    valid, ratios = torch.cat(valids, 1), torch.stack(ratios, 1)
    centers = []
    for hl, wl in shapes:
        gy, gx = torch.meshgrid((torch.arange(hl, device=dev) + 0.5) / hl,
                                (torch.arange(wl, device=dev) + 0.5) / wl,
                                indexing="ij")
        centers.append(torch.stack([gx, gy], -1).reshape(-1, 2))
    own = torch.cat([ratios[:, li:li + 1].expand(b, hl * wl, 2)
                     for li, (hl, wl) in enumerate(shapes)], 1)
    enc_ref = (torch.cat(centers)[None] / own.clamp(min=1e-6))[:, :, None,
                                                                :] * ratios[
        :, None]
    for i in range(z["enc"]):
        n = f"enc{i}"
        a = deform_attn(p, f"{n}.deform_attn", src + pos, enc_ref, None, src,
                        valid, shapes, z, prec)
        src = layer_norm(src + dropout(a, rate, gen), p, f"{n}.norm1")
        y = ffn(p, f"{n}.ffn", src, prec, gen, rate)
        src = layer_norm(src + dropout(y, rate, gen), p, f"{n}.norm2")
    qe = p["query_embed"]
    qpos = qe[None, :, :d].expand(b, -1, -1).to(dt)
    tgt = qe[None, :, d:].expand(b, -1, -1).to(dt)
    ref = torch.sigmoid(C.dense(qpos.float(), p, "ref_point_head", prec, F32))
    all_logits, all_boxes = [], []
    for i in range(z["dec"]):
        n = f"dec{i}"
        if ref.shape[-1] == 2:
            ref_xy, ref_wh = ref[:, :, None, :] * ratios[:, None], None
        else:
            scaled = ref[:, :, None, :] * torch.cat([ratios, ratios],
                                                    -1)[:, None]
            ref_xy, ref_wh = scaled[..., :2], scaled[..., 2:]
        q = tgt + qpos
        a = self_attention(p, f"{n}.self_attn", q, tgt, z, prec, gen, rate)
        tgt = layer_norm(tgt + dropout(a, rate, gen), p, f"{n}.norm1")
        a = deform_attn(p, f"{n}.cross_attn", tgt + qpos, ref_xy, ref_wh, src,
                        valid, shapes, z, prec)
        tgt = layer_norm(tgt + dropout(a, rate, gen), p, f"{n}.norm2")
        y = ffn(p, f"{n}.ffn", tgt, prec, gen, rate)
        tgt = layer_norm(tgt + dropout(y, rate, gen), p, f"{n}.norm3")
        hi = i if z["refine"] else 0
        logits = C.dense(tgt.float(), p, f"class_head{hi}", prec, F32)
        y = F.relu(C.dense(tgt, p, f"bbox_head{hi}.fc0", prec, dt))
        y = F.relu(C.dense(y, p, f"bbox_head{hi}.fc1", prec, dt))
        delta = C.dense(y.float(), p, f"bbox_head{hi}.out", prec, F32)
        anchor = (torch.cat([inverse_sigmoid(ref), torch.zeros_like(ref)], -1)
                  if ref.shape[-1] == 2 else inverse_sigmoid(ref))
        boxes = torch.sigmoid(delta + anchor)
        all_logits.append(logits)
        all_boxes.append(boxes)
        if z["refine"]:
            ref = boxes.detach()
    return torch.stack(all_logits), torch.stack(all_boxes)


def normalized(image_u8, cfg, prec):
    z = _sizes(cfg)
    return C.normalize(image_u8, z["mean"], z["std"], prec.dtype)


@torch.no_grad()
def predict(p: Dict[str, torch.Tensor], image_u8: torch.Tensor,
            image_hw: torch.Tensor, cfg, prec: C.Precision) -> dict:
    """uint8 canvases -> the top ``max_detections`` (query, class) pairs by
    sigmoid score, boxes in pixels clipped to each image, no NMS."""
    z = _sizes(cfg)
    hw = image_hw.float()
    logits, boxes_n = forward(p, normalized(image_u8, cfg, prec), hw, cfg,
                              prec)
    b = logits.shape[1]
    flat = torch.sigmoid(logits[-1]).reshape(b, -1)
    top = torch.sort(flat, dim=-1, descending=True, stable=True)
    scores, idx = top.values[:, :z["dets"]], top.indices[:, :z["dets"]]
    query = idx // z["classes"]
    classes = idx % z["classes"] + 1
    norm = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], -1)
    pb = torch.gather(boxes_n[-1], 1, query[..., None].expand(-1, -1, 4))
    cx, cy, w, h = pb.unbind(-1)
    xyxy = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], -1) * norm[:, None]
    boxes = C.clip_to(xyxy, hw[:, None, :])
    valid = scores > z["score"]
    return {"boxes": boxes, "scores": torch.where(valid, scores, 0.0),
            "classes": torch.where(valid, classes, 0), "valid": valid}


def kept(cfg):
    """``(max_detections, score_thresh)`` of the final selection."""
    z = _sizes(cfg)
    return z["dets"], z["score"]


# ------------------------------------------------------------- training
def step_seed(seed: int, step: int, words: int, which: int) -> int:
    """The program's per-step generator seeds (``train/step.py``): word
    ``which`` of ``SeedSequence([seed, step, 0])``; word 0 seeds the
    dropout masks, word 1 of two the augmentation."""
    return int(np.random.SeedSequence([seed, step, 0]).generate_state(
        words, np.uint64)[which])


def flip(image, boxes, hw):
    """Mirror each image's valid columns and its boxes about its width."""
    b, h, w, c = image.shape
    wi = hw[:, 1]
    cols = torch.arange(w, device=image.device, dtype=wi.dtype)[None, :]
    src = torch.where(cols < wi[:, None], wi[:, None] - 1 - cols,
                      cols).long()
    image = torch.gather(image, 2, src[:, None, :, None].expand(b, h, w, c))
    boxes = torch.stack([wi[:, None] - boxes[..., 2], boxes[..., 1],
                         wi[:, None] - boxes[..., 0], boxes[..., 3]], -1)
    return image, boxes


def cxcywh(b):
    return torch.stack([(b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3])
                        / 2, b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]],
                       -1)


def xyxy(b):
    return torch.stack([b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2,
                        b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2],
                       -1)


def giou(a, b):
    """Generalized IoU of broadcast xyxy pairs."""
    area = lambda x: ((x[..., 2] - x[..., 0]).clamp(min=0)  # noqa: E731
                      * (x[..., 3] - x[..., 1]).clamp(min=0))
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    union = area(a) + area(b) - inter
    iou = inter / union.clamp(min=1e-9)
    hull = (torch.maximum(a[..., 2:], b[..., 2:])
            - torch.minimum(a[..., :2], b[..., :2])).clamp(min=0).prod(-1)
    return iou - (hull - union) / hull.clamp(min=1e-9)


def set_loss(logits, boxes, gt, classes, valid, s):
    """Deformable DETR's set loss over ``[L, B, Q, ...]`` predictions: per
    layer and image the Hungarian matching (scipy) of the valid ground
    truth under the focal class cost plus L1 and -GIoU, then the sigmoid
    focal loss over every (query, class), L1 and 1 - GIoU over the matched
    pairs, each divided by the batch's count of boxes and weighted."""
    from scipy.optimize import linear_sum_assignment

    pre = "deformable_detr."
    alpha, gamma = s[pre + "focal_alpha"], s[pre + "focal_gamma"]
    layers, b, q, c = logits.shape
    logits = logits.float()
    p = torch.sigmoid(logits)
    with torch.no_grad():
        pos = alpha * (1 - p) ** gamma * (-torch.log(p + 1e-8))
        neg = (1 - alpha) * p ** gamma * (-torch.log(1 - p + 1e-8))
        cls_cost = (pos - neg)                              # [L, B, Q, C]
        l1_cost = (gt[None, :, :, None] - boxes[:, :, None]).abs().sum(-1)
        g_cost = -giou(xyxy(gt)[None, :, :, None], xyxy(boxes)[:, :, None])
    target = torch.zeros_like(logits)
    l1 = boxes.new_zeros(())
    gi = boxes.new_zeros(())
    for layer in range(layers):
        for i in range(b):
            rows = torch.nonzero(valid[i]).flatten()
            cols = classes[i, rows].long() - 1
            cost = (s[pre + "cost_class"] * cls_cost[layer, i][:, cols].T
                    + s[pre + "cost_bbox"] * l1_cost[layer, i, rows]
                    + s[pre + "cost_giou"] * g_cost[layer, i, rows])
            r, qi = linear_sum_assignment(cost.double().cpu().numpy())
            r = rows[torch.from_numpy(r).to(rows.device)]
            qi = torch.from_numpy(qi).to(rows.device)
            target[layer, i, qi, classes[i, r].long() - 1] = 1.0
            pb, tb = boxes[layer, i, qi], gt[i, r]
            l1 = l1 + (pb - tb).abs().sum()
            gi = gi + (1 - giou(xyxy(pb), xyxy(tb))).sum()
    bce = (torch.clamp(logits, min=0) - logits * target
           + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * target + (1 - p) * (1 - target)
    a_t = alpha * target + (1 - alpha) * (1 - target)
    focal = (a_t * (1 - p_t) ** gamma * bce).sum()
    count = valid.sum().clamp(min=1).float()
    return (s[pre + "loss_weight_class"] * focal
            + s[pre + "loss_weight_bbox"] * l1
            + s[pre + "loss_weight_giou"] * gi) / count


def buffers(cfg) -> set:
    """The frozen norms' statistics: tensors of the state dict that no
    optimizer moves."""
    return {f"{name}.{k}" for name, _, kind in C.resnet_spec(
        "backbone", _sizes(cfg)["blocks"]) if kind == "bn"
        for k in ("scale", "bias", "mean", "var")}


def lr_at(s, step: int) -> float:
    """The step schedule's rate at update ``step`` with its linear warm-up
    from ``warmup_factor``."""
    lr = s["train.learning_rate"]
    warm, f = s["train.warmup_steps"], s["train.warmup_factor"]
    if step < warm:
        lr *= f + (1.0 - f) * step / max(warm, 1)
    return lr


def train(p0: Dict[str, torch.Tensor], batches, cfg, prec: C.Precision,
          steps: int = 3) -> dict:
    """``steps`` AdamW updates from the weights ``p0`` on ``batches`` (one
    per step: uint8 canvases, their extents and the padded ground truth),
    with the program's flips and dropout masks drawn again from its
    per-step seeds -> the losses and gradient norms before clipping, each
    leaf's clipped first gradient norm, its change's norm after the last
    step, and the first forward's per-query outputs (``outputs``: the
    decoder layers' logits and boxes, f32 on the host)."""
    s = cfg["sizes"]
    z = _sizes(cfg)
    seed = s.get("train.seed", 0)
    dev = next(iter(p0.values())).device
    frozen = buffers(cfg)
    params = {k: (v.clone().requires_grad_(True) if k not in frozen
                  else v) for k, v in p0.items()}
    trainable = [k for k in params if k not in frozen]
    groups: Dict[tuple, list] = {}
    for k in trainable:
        decay = params[k].ndim >= 2 or (".self_attn." in k and k.split(".")[
            -2] in ("query", "key", "value"))
        groups.setdefault((decay, k.startswith("backbone.")), []).append(
            params[k])
    opt_groups = [{"params": v, "weight_decay": s["train.weight_decay"]
                   if decay else 0.0,
                   "factor": s["train.backbone_lr_factor"] if bb else 1.0}
                  for (decay, bb), v in sorted(groups.items())]
    opt = torch.optim.AdamW(opt_groups, lr=s["train.learning_rate"])
    losses, norms, first, outputs = [], [], {}, {}
    for step in range(steps):
        batch = {k: v.to(dev) for k, v in batches[step].items()}
        hw = batch["image_hw"].float()
        aug = torch.Generator(device=dev).manual_seed(
            step_seed(seed, step, 2, 1))
        torch.rand(hw.shape[0], 4, generator=aug, device=dev)  # jitter
        flips = torch.rand(hw.shape[0], generator=aug, device=dev) < 0.5
        image = batch["image"].float()
        f_img, f_box = flip(image, batch["gt_boxes"].float(), hw)
        image = torch.where(flips[:, None, None, None], f_img, image)
        gt = torch.where(flips[:, None, None], f_box,
                         batch["gt_boxes"].float())
        m = torch.tensor(z["mean"], device=dev)
        sd = torch.tensor(z["std"], device=dev)
        image = ((image - m) / sd).to(prec.dtype).permute(0, 3, 1, 2)
        gen = torch.Generator(device=dev).manual_seed(
            step_seed(seed, step, 1, 0))
        logits, boxes = forward(params, image, hw, cfg, prec, gen)
        if step == 0:
            outputs = {"logits": logits.detach().float().cpu(),
                       "boxes": boxes.detach().float().cpu()}
        norm = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], -1)
        loss = set_loss(logits, boxes, cxcywh(gt) / norm[:, None],
                        batch["gt_classes"], batch["gt_valid"].bool(), s)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = []
        for k in trainable:
            if params[k].grad is None:
                params[k].grad = torch.zeros_like(params[k])
            grads.append(params[k].grad)
        total = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        norms.append(float(total))
        clip = s["train.grad_clip_norm"]
        if clip > 0 and float(total) >= clip:
            for g in grads:
                g.mul_(clip / total)
        if step == 0:
            first = {k: float(params[k].grad.norm()) for k in trainable}
        for g in opt.param_groups:
            g["lr"] = lr_at(s, step) * g["factor"]
        opt.step()
        losses.append(float(loss.detach()))
    change = {k: float((params[k].detach() - p0[k]).norm())
              for k in trainable}
    return {"losses": losses, "grad_norms": norms, "grad": first,
            "change": change, "outputs": outputs}
