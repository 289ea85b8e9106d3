"""The work counters: each configuration's FLOPs against
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference at a
small size (convolutions and matrix products), and the kernels' bytes
against the bounds of PERF.md's kernel table at its shapes."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from detbench import generator, weights as W
from detbench.reference import deformable_detr, faster_rcnn_c4
from detbench.reference.common import Precision
from detbench.work import deform_attn, faster_rcnn_c4 as work_frcnn
from detbench.work import deformable_detr as work_ddetr
from detbench.work import roi_align

HERE = Path(__file__).resolve().parents[1]
H100 = {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12}


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def counted(reference, cfg, b, h, w):
    spec = W.apply_draws(reference.spec(cfg), cfg["draws"])
    p = W.draw(spec, 5, "cpu")
    traffic = {"pool": 1, "batch": b, "canvas": [h, w],
               "valid_frac": [0.8, 1.0]}
    batch = generator.make_pool(traffic, 5, "cpu")[0]
    with FlopCounterMode(display=False) as counter:
        reference.predict(p, batch["image"], batch["image_hw"], cfg,
                          Precision(torch.float32))
    return counter.get_total_flops()


@pytest.mark.parametrize("name,reference,work,shape", [
    ("voc_r50", faster_rcnn_c4, work_frcnn, (2, 96, 128)),
    ("coco_deformable_detr_r50", deformable_detr, work_ddetr, (1, 96, 160)),
])
def test_model_flops_match_the_reference(name, reference, work, shape):
    cfg = config(name)
    assert work.flops(cfg, *shape) == counted(reference, cfg, *shape)


def test_training_counts_the_backward_above_the_frozen_stem():
    cfg = config("coco_deformable_detr_r50")
    fwd = work_ddetr.flops(cfg, 8, 832, 1120)
    train = work_ddetr.flops(cfg, 8, 832, 1120, train=True)
    assert fwd < train < 3 * fwd


def test_roi_align_bound_is_the_kernel_tables():
    shapes = [[32, 40, 40, 256], [9600, 4], [9600], [], []]
    bf16 = roi_align.bound_s(shapes, ["c10::BFloat16", "float", "int"],
                             ["", "", "", 7, 2], H100)
    f32 = roi_align.bound_s(shapes, ["float", "float", "int"],
                            ["", "", "", 7, 2], H100)
    assert bf16 * 1e3 == pytest.approx(0.0798, abs=5e-5)
    assert f32 * 1e3 == pytest.approx(0.1595, abs=5e-5)


def test_deform_attn_bounds_are_the_kernel_tables():
    """The encoder layer at b=8 832x832 (Q = N = 14,365), where nearly
    every value row is touched, reads the table's bounds; the decoder
    (Q = 300) counts every row, more than the table's touched rows."""
    n, d = 14365, 32
    enc = [[8, n, 8, d], [8, n, 8, 4, 4, 2], [8, n, 8, 4, 4]]
    dec = [[8, n, 8, d], [8, 300, 8, 4, 4, 2], [8, 300, 8, 4, 4]]
    types = ["c10::BFloat16", "float", "float"]
    assert deform_attn.forward_s(enc, types, H100) * 1e3 == pytest.approx(
        0.1054, abs=5e-5)
    assert deform_attn.backward_s(enc, types, H100) * 1e3 == pytest.approx(
        0.1756, abs=5e-5)
    total = (deform_attn.forward_s(enc, types, H100)
             + deform_attn.forward_s(dec, types, H100))
    assert total * 1e3 >= 0.1152
