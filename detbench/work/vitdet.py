"""Model FLOPs of a ViTDet Faster R-CNN predict from the configuration's
sizes and the batch's shape, at two FLOPs per multiply-add: every
convolution and matrix product. The patch embedding; per block the q, k, v
and out projections (over the zero-padded windows in a window block), both
attention products over those windows or over the whole token grid, the
relative-position products and the MLP; the simple feature pyramid's
transposed and plain convolutions; the RPN over p2..p6; the head over
``rpn.post_nms_topk_test`` RoIs per image (every slot is pooled and
classified, valid or not). Norms, activations, the softmax and RoI Align
are not products and are not counted."""

from __future__ import annotations

from detbench.reference.vitdet import PATCH, PYRAMID, VARIANTS
from detbench.work import vit_attn as A


def _conv(b, cin, cout, k, hw):
    return 2 * b * cin * cout * k * k * hw[0] * hw[1]


def flops(cfg, b: int, h: int, w: int, train: bool = False) -> int:
    if train:
        raise ValueError("vitdet: no train cell counts its work yet")
    s = cfg["sizes"]
    dim, _, _ = VARIANTS[s["backbone.name"]]
    g = (-(-h // PATCH), -(-w // PATCH))
    total = _conv(b, 3, dim, PATCH, g)
    for kind, core in A.cores(cfg, b, h, w).items():
        tokens = core["n"] * core["l"]  # the projections' tokens
        per = 4 * 2 * tokens * dim * dim + A.core_work(cfg, core)[1]
        total += core["count"] * per
    total += len(A.block_kinds(cfg)) * 2 * 2 * b * g[0] * g[1] * dim * 4 * dim
    # The pyramid: 2x2 stride-2 transposed convs count per input cell.
    g2 = (2 * g[0], 2 * g[1])
    total += _conv(b, dim, dim // 2, 2, g) + _conv(b, dim // 2, dim // 4, 2,
                                                   g2)
    total += _conv(b, dim, dim // 2, 2, g)
    g5 = (-(-g[0] // 2), -(-g[1] // 2))
    levels = {"p2": (dim // 4, (4 * g[0], 4 * g[1])), "p3": (dim // 2, g2),
              "p4": (dim, g), "p5": (dim, g5)}
    for cin, hw in levels.values():
        total += _conv(b, cin, PYRAMID, 1, hw) + _conv(b, PYRAMID, PYRAMID,
                                                       3, hw)
    grids = [hw for _, hw in levels.values()]
    grids.append((-(-g5[0] // 2), -(-g5[1] // 2)))
    a = len(s["anchors.fpn_octave_scales"]) * len(s["anchors.aspect_ratios"])
    rpn = s["rpn.conv_channels"]
    for hw in grids:
        total += _conv(b, PYRAMID, rpn, 3, hw) + _conv(b, rpn, 5 * a, 1, hw)
    rois = b * s["rpn.post_nms_topk_test"]
    fc, c = s["roi.fc_dim"], s["data.num_classes"]
    flat = s["roi.output_size"] ** 2 * PYRAMID
    total += 2 * rois * (flat * fc + fc * fc + fc * (c + 1) + fc * 4 * c)
    return total
