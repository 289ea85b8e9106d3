"""Model FLOPs of a Deformable DETR step from the configuration's sizes and
the batch's shape: every convolution and matrix product at two FLOPs per
multiply-add (the deformable sampling itself is a weighted gather, not a
product, and is not counted), 300 queries, every decoder layer's heads. In
training the backward counts twice the forward of every layer above the
stage where ``freeze_stem`` stops the gradient."""

from __future__ import annotations

from detbench.work import resnet as R

BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


def flops(cfg, b: int, h: int, w: int, train: bool = False) -> int:
    s = cfg["sizes"]
    pre = "deformable_detr."
    d, heads = s[pre + "d_model"], s[pre + "num_heads"]
    ffn, q = s[pre + "ffn_dim"], s[pre + "num_queries"]
    lv, pt = s[pre + "num_levels"], s[pre + "num_points"]
    enc, dec = s[pre + "enc_layers"], s[pre + "dec_layers"]
    classes = s["data.num_classes"]
    by_stage, shapes = R.resnet(b, h, w, BLOCKS[s["backbone.name"]], 5)
    frozen = by_stage[1] + by_stage[2]
    total = sum(by_stage.values())
    tokens = 0
    for i, stage in enumerate((3, 4, 5)):
        total += R.conv_flops(b, R.WIDTHS[stage - 2], d, 1, shapes[stage])
        tokens += shapes[stage][0] * shapes[stage][1]
    grid, in_ch = shapes[5], R.WIDTHS[3]
    for _ in range(lv - 3):
        grid = (R.conv_out(grid[0], 3, 2, 1), R.conv_out(grid[1], 3, 2, 1))
        total += R.conv_flops(b, in_ch, d, 3, grid)
        tokens += grid[0] * grid[1]
        in_ch = d
    samples = heads * lv * pt

    def deform(nq):  # value over the memory, then per query
        return 2 * b * (tokens * d * d
                        + nq * (d * 3 * samples + d * d))

    total += enc * (deform(tokens) + 2 * b * tokens * 2 * d * ffn)
    total += 2 * b * q * d * 2  # the reference-point head
    per_dec = (2 * b * q * 4 * d * d        # query, key, value, out
               + 2 * 2 * b * q * q * d      # q.k and attn.v over the heads
               + deform(q) + 2 * b * q * 2 * d * ffn
               + 2 * b * q * (d * classes + 2 * d * d + d * 4))
    total += dec * per_dec
    if train:
        total += 2 * (total - frozen)
    return total
