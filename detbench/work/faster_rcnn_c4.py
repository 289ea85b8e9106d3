"""Model FLOPs of a Faster R-CNN C4 step from the configuration's sizes and
the batch's shape: every convolution and matrix product at two FLOPs per
multiply-add, the RPN over the whole c4 grid, the head over
``rpn.post_nms_topk_test`` RoIs per image (every slot is pooled and
classified, valid or not). In training the backward counts twice the
forward of every layer above the stage where ``freeze_stem`` stops the
gradient."""

from __future__ import annotations

from detbench.work import resnet as R

BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


def flops(cfg, b: int, h: int, w: int, train: bool = False) -> int:
    s = cfg["sizes"]
    if train:
        raise ValueError("faster_rcnn_c4: no train cell counts its work yet")
    by_stage, shapes = R.resnet(b, h, w, BLOCKS[s["backbone.name"]], 4)
    grid = shapes[4]
    a = len(s["anchors.scales"]) * len(s["anchors.aspect_ratios"])
    neck, rpn = s["backbone.neck_channels"], s["rpn.conv_channels"]
    total = sum(by_stage.values())
    total += R.conv_flops(b, R.WIDTHS[2], neck, 1, grid)
    total += R.conv_flops(b, neck, rpn, 3, grid)
    total += R.conv_flops(b, rpn, 5 * a, 1, grid)
    rois = b * s["rpn.post_nms_topk_test"]
    fc, c = s["roi.fc_dim"], s["data.num_classes"]
    flat = s["roi.output_size"] ** 2 * neck
    total += 2 * rois * (flat * fc + fc * fc + fc * (c + 1) + fc * 4 * c)
    return total
