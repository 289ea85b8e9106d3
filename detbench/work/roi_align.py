"""The least time a RoI Align forward could take on the card, from the
shapes of one ``tpudet::roi_align_fwd`` call: the features, the RoIs (boxes
and image indices) read once and the pooled output written once, at the
HBM rate; or its f32 arithmetic, ten operations per bilinear sample per
channel (two horizontal lerps and a vertical one at three each, and the
accumulate), outside the tensor cores, whichever is larger."""

from __future__ import annotations

from math import prod

OPS_PER_SAMPLE = 10
BYTES = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4, "int": 4,
         "long int": 8}


def bound_s(shapes, dtypes, scalars, peaks, size=7, ratio=2) -> float:
    feats, boxes, index = shapes[:3]
    if len(scalars) >= 5 and isinstance(scalars[3], int):
        size, ratio = scalars[3], scalars[4]
    elt = BYTES.get(dtypes[0], 2)
    k, c = boxes[0], feats[-1]
    out = k * size * size * c
    moved = (prod(feats) * elt + prod(boxes) * BYTES.get(dtypes[1], 4)
             + prod(index) * BYTES.get(dtypes[2], 4) + out * elt)
    ops = out * ratio * ratio * OPS_PER_SAMPLE
    return max(moved / peaks["hbm_bytes"], ops / peaks["f32_flops"])
