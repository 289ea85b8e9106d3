"""The least time ViTDet's attention cores could take on the card per
batch, from the configuration's sizes and the canvas alone, so that it
divides the same work whatever implements the cores (the plain products
or a fused kernel). A core is one block's attention from q, k and v after
their projections to the heads' output before ``out``: window blocks over
the zero-padded windows of each image, global blocks over its whole token
grid.

Per core the larger of two bounds:

* bytes: q, k, v read once and the output written once in the block
  dtype, and the block's two f32 relative-position tables read once, at
  the HBM rate;
* operations: the two products (``q.k`` and ``p.v``, two FLOPs per
  multiply-add over every head) and the two relative-position products
  (q against the gathered table rows of each key row and column), at the
  bf16 tensor-core rate.

The logits, the probabilities and the bias are intermediates that a fused
kernel need never write, so they are not counted."""

from __future__ import annotations

from typing import Dict, List

from detbench.reference.vitdet import PATCH, VARIANTS

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def block_kinds(cfg) -> List[str]:
    """``"global"`` or ``"window"`` for each block, in order."""
    s = cfg["sizes"]
    depth = VARIANTS[s["backbone.name"]][1]
    every = s["backbone.vit_global_attn_every"]
    return ["global" if (i + 1) % every == 0 else "window"
            for i in range(depth)]


def cores(cfg, b: int, h: int, w: int) -> Dict[str, dict]:
    """Each kind's shape: ``count`` blocks of ``n`` sequences of ``l``
    tokens, the grid side ``side`` (rows, columns) each query meets, and
    the table's side ``table``."""
    s = cfg["sizes"]
    gh, gw = -(-h // PATCH), -(-w // PATCH)
    win = s["backbone.vit_window"]
    kinds = block_kinds(cfg)
    nwin = (-(-gh // win)) * (-(-gw // win))
    return {"global": {"count": kinds.count("global"), "n": b,
                       "l": gh * gw, "side": (gh, gw),
                       "table": s["backbone.vit_pos_grid"]},
            "window": {"count": kinds.count("window"), "n": b * nwin,
                       "l": win * win, "side": (win, win), "table": win}}


def core_work(cfg, core: dict) -> tuple:
    """``(bytes, FLOPs)`` of one core of the shape ``core``."""
    s = cfg["sizes"]
    dim, _, heads = VARIANTS[s["backbone.name"]]
    elt = BYTES[s["backbone.dtype"]]
    n, l = core["n"], core["l"]
    moved = 4 * n * l * dim * elt
    flops = 2 * 2 * n * l * l * dim
    if s.get("backbone.vit_rel_pos"):
        moved += 2 * (2 * core["table"] - 1) * (dim // heads) * 4
        flops += 2 * n * l * sum(core["side"]) * dim
    return moved, flops


def bound_s(cfg, b: int, h: int, w: int, peaks, kind: str = "") -> float:
    """Seconds per batch of the cores of ``kind`` ("global", "window", or
    both where empty)."""
    total = 0.0
    for name, core in cores(cfg, b, h, w).items():
        if kind and name != kind:
            continue
        moved, flops = core_work(cfg, core)
        total += core["count"] * max(moved / peaks["hbm_bytes"],
                                     flops / peaks["bf16_flops"])
    return total
