"""Multiply-add work of a bottleneck ResNet from its input shape, at two
FLOPs per multiply-add (convolutions only; norms and activations are
elementwise and not counted)."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

WIDTHS = (256, 512, 1024, 2048)


def conv_out(size: int, k: int, s: int, pad: int) -> int:
    return (size + 2 * pad - k) // s + 1


def conv_flops(b: int, cin: int, cout: int, k: int, hw: Tuple[int, int]
               ) -> int:
    """2 x multiply-adds of a dense ``k x k`` convolution whose output is
    ``hw`` per image."""
    return 2 * b * cin * cout * k * k * hw[0] * hw[1]


def resnet(b: int, h: int, w: int, blocks: Sequence[int], stop_at: int
           ) -> Tuple[Dict[int, int], Dict[int, Tuple[int, int]]]:
    """``({stage: FLOPs}, {stage: (h, w)})`` for the stem (stage 1) and the
    stages 2..``stop_at``: 7x7/2 stem, 3x3/2 pool, bottlenecks striding
    their first 1x1."""
    hw = (conv_out(h, 7, 2, 3), conv_out(w, 7, 2, 3))
    flops = {1: conv_flops(b, 3, 64, 7, hw)}
    hw = (conv_out(hw[0], 3, 2, 1), conv_out(hw[1], 3, 2, 1))
    shapes = {}
    in_ch = 64
    for stage, (n, ch) in enumerate(zip(blocks, WIDTHS)):
        total = 0
        for i in range(n):
            stride = 2 if (i == 0 and stage > 0) else 1
            out = (conv_out(hw[0], 1, stride, 0),
                   conv_out(hw[1], 1, stride, 0))
            width = ch // 4
            if in_ch != ch or stride != 1:
                total += conv_flops(b, in_ch, ch, 1, out)
            total += (conv_flops(b, in_ch, width, 1, out)
                      + conv_flops(b, width, width, 3, out)
                      + conv_flops(b, width, ch, 1, out))
            hw, in_ch = out, ch
        flops[stage + 2] = total
        shapes[stage + 2] = hw
        if stage + 2 == stop_at:
            break
    return flops, shapes
