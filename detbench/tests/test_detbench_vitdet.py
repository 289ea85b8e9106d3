"""ViTDet's work counters and attention readers: the model FLOPs against
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference and
against a count by hand; the attention bound counted by hand at a small
shape and at the cell's, and dividing the same work as the products of the
plain path (the program's attention cores under the counter); the span
readers on hand-made event lists, None where a step holds another number
of spans than the configuration's blocks."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from detbench import trace
from detbench.harness import Readings
from detbench.tests.test_detbench_trace import dev, op, reader
from detbench.tests.test_detbench_work import H100, counted
from detbench.reference import vitdet
from detbench.work import vit_attn, vitdet as work

HERE = Path(__file__).resolve().parents[1]


def config(**sizes):
    cfg = json.loads((HERE / "configs" / "coco_vitdet_b.json").read_text())
    cfg["sizes"].update(sizes)
    return cfg


TINY = {"backbone.name": "vit_tiny", "backbone.vit_window": 4,
        "backbone.vit_global_attn_every": 2, "backbone.vit_pos_grid": 8,
        "rpn.conv_channels": 64, "roi.fc_dim": 64, "data.num_classes": 3,
        "rpn.post_nms_topk_test": 10}


@pytest.mark.parametrize("sizes,shape", [({}, (1, 128, 160)),
                                          (TINY, (2, 96, 64))])
def test_model_flops_match_the_reference(sizes, shape):
    cfg = config(**sizes)
    assert work.flops(cfg, *shape) == counted(vitdet, cfg, *shape)


def test_model_flops_by_hand():
    """vit_tiny (width 32, window 4, block 1 global) on one 64x64 canvas:
    a 4x4 grid, one unpadded window."""
    cfg = config(**TINY)
    d, t = 32, 16
    vit = 2 * 3 * d * 256 * t                      # the patch embedding
    per_block = (4 * 2 * t * d * d                 # q, k, v, out
                 + 2 * 2 * t * t * d               # q.k and p.v
                 + 2 * t * (4 + 4) * d             # rel_h and rel_w
                 + 2 * 2 * t * d * 4 * d)          # the MLP
    pyramid = (2 * d * 16 * 4 * t + 2 * 16 * 8 * 4 * 4 * t  # up4
               + 2 * d * 16 * 4 * t                          # up2
               + 2 * 256 * t * (8 * 16 + 16 * 4 + d + d / 4)  # 1x1s
               + 2 * 256 * 256 * 9 * t * (16 + 4 + 1 + 0.25))  # 3x3s
    cells = t * (16 + 4 + 1 + 1 / 4 + 1 / 16)      # p2..p6
    rpn = 2 * cells * (256 * 64 * 9 + 64 * 15)
    head = 2 * 10 * (49 * 256 * 64 + 64 * 64 + 64 * 4 + 64 * 12)
    assert work.flops(cfg, 1, 64, 64) == vit + 2 * per_block + pyramid \
        + rpn + head


def test_attention_bound_by_hand():
    cfg = config(**TINY)
    # Per block 16 tokens of width 32 in bf16: q, k, v and out 4 * 16 *
    # 32 * 2 bytes, the f32 tables (2 * 4 - 1) * 16 * 4 bytes each in the
    # window block and (2 * 8 - 1) * 16 * 4 in the global one.
    window = 4 * 16 * 32 * 2 + 2 * 7 * 16 * 4
    glob = 4 * 16 * 32 * 2 + 2 * 15 * 16 * 4
    assert vit_attn.core_work(cfg, vit_attn.cores(cfg, 1, 64, 64)["window"]
                              ) == (window, 4 * 16 * 16 * 32
                                    + 2 * 16 * 8 * 32)
    assert vit_attn.bound_s(cfg, 1, 64, 64, H100) == pytest.approx(
        (window + glob) / H100["hbm_bytes"])
    # The cell: 8 x 4,096 tokens in 4 global blocks, 8 x 25 windows of 196
    # in 8 window blocks, each kind's products over the bf16 rate.
    cell = config()
    g = 2 * 2 * 8 * 4096 ** 2 * 768 + 2 * 8 * 4096 * 128 * 768
    w = 4 * 200 * 196 * 768 * 2 + 2 * 27 * 64 * 4
    assert vit_attn.bound_s(cell, 8, 1024, 1024, H100) == pytest.approx(
        4 * g / H100["bf16_flops"] + 8 * w / H100["hbm_bytes"])
    assert vit_attn.bound_s(cell, 8, 1024, 1024, H100) * 1e3 == \
        pytest.approx(2.2689, abs=5e-5)


@pytest.mark.parametrize("kind,grid", [("window", (4, 4)),
                                       ("global", (8, 10))])
def test_attention_bound_counts_the_plain_path(kind, grid):
    """The FLOPs the bound divides are those of the program's plain cores:
    the products and the relative-position terms, the projections left
    out."""
    from tpudet_torch.models.vit import Attention

    cfg = config(**TINY)
    window = 4 if kind == "window" else 0
    attn = Attention(32, 2, torch.float32, rel_pos=4 if window else 8,
                     window=window)
    n = 3
    x = torch.randn(n, grid[0] * grid[1], 32)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        attn(x, grid)
    core = {"n": n, "l": grid[0] * grid[1], "side": grid,
            "table": 4 if window else 8}
    projections = 4 * 2 * n * grid[0] * grid[1] * 32 * 32
    assert counter.get_total_flops() - projections == vit_attn.core_work(
        cfg, core)[1]


def attention_events(globals_per_step=4):
    """Two steps, each with ``globals_per_step`` global spans of one 10 us
    kernel and 8 window spans of one 2 us kernel."""
    ev = [op(trace.WINDOW, 0, 1000, 1)]
    at, ids = 0, 100
    for _ in range(2):
        ev.append(op("tpudet/step", at + 1, at + 450, ids))
        ids += 1
        t = at + 2
        for kind, count, us in (("window", 8, 2), ("global",
                                                   globals_per_step, 10)):
            for _ in range(count):
                ev += [op(f"tpudet/attn_{kind}", t, t + 3, ids),
                       op("aten::mm", t + 1, t + 2, ids + 1),
                       dev("gemm", t + 1, t + 1 + us, ids + 1)]
                ids += 2
                t += 20
        at += 500
    return ev


def ctx(ev):
    cell = SimpleNamespace(config=config(), traffic={"batch": 8,
                                                     "canvas": [1024, 1024]})
    return Readings(ev, (0, 1000), {}, 0.0, H100, cell)


def test_attention_readers():
    ev = attention_events()
    assert reader("global_attn_ms").read(ctx(ev)) == pytest.approx(0.040)
    assert reader("window_attn_ms").read(ctx(ev)) == pytest.approx(0.016)
    bound = vit_attn.bound_s(config(), 8, 1024, 1024, H100)
    assert reader("vit_attn_roofline_pct").read(ctx(ev)) == pytest.approx(
        100 * bound / 56e-6)


def test_attention_readers_refuse_a_wrong_span_count():
    ev = attention_events(globals_per_step=3)
    assert reader("global_attn_ms").read(ctx(ev)) is None
    assert reader("window_attn_ms").read(ctx(ev)) == pytest.approx(0.016)
    assert reader("vit_attn_roofline_pct").read(ctx(ev)) is None
    # A program without the spans reads nothing.
    bare = [e for e in attention_events()
            if not e["name"].startswith("tpudet/attn_")]
    for name in ("global_attn_ms", "window_attn_ms",
                 "vit_attn_roofline_pct"):
        assert reader(name).read(ctx(bare)) is None
