"""The port's layer spans (``utils.profiling.span``), on the CPU.

Without a profiler a span is one shared no-op that enters no
``record_function``. Under a profiler each step of the tiny Faster R-CNN
and the tiny Deformable DETR, inference and training, opens every
``tpudet/<layer>`` span once, nested as the steps and the models open them
(``train/step.py``, ``models/faster_rcnn.py``, ``models/deformable_detr.py``,
``ops/hungarian.py``). An exported serving program carries none of them.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpudet_torch import config as tconfig
from tpudet_torch.models import build_model
from tpudet_torch.serving import export_model
from tpudet_torch.train.state import create_train_state
from tpudet_torch.train.step import make_eval_step, make_train_step
from tpudet_torch.utils import profiling

torch.set_num_threads(2)
STEPS = 2


@pytest.fixture
def entered(monkeypatch):
    """The names of the ``record_function`` ranges entered from here on."""
    names = []
    enter = torch.autograd.profiler.record_function.__enter__

    def counting(self):
        names.append(self.name)
        return enter(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        counting)
    return names


def test_span_without_a_profiler_is_the_shared_no_op(entered):
    assert profiling.span("tpudet/step") is profiling._NO_SPAN
    with profiling.span("tpudet/step"):
        with profiling.span("tpudet/predict"):
            pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("tpudet/step"):
            pass
    assert entered == ["tpudet/step"]


def batch(cfg, seed=0, b=2):
    """Loader batches: uint8 canvases, the second image's true extent
    smaller, 3 and 5 ground-truth boxes padded to ``max_gt_boxes``."""
    rng = np.random.default_rng(seed)
    h = w = cfg.data.canvas_height
    g = cfg.data.max_gt_boxes
    hw = np.array([[h, w], [h * 0.75, w * 0.875]], np.float32)[:b]
    gt = np.zeros((b, g, 4), np.float32)
    classes = np.zeros((b, g), np.int32)
    valid = np.zeros((b, g), bool)
    for i, k in enumerate((3, 5)[:b]):
        size = rng.uniform(0.15, 0.5, (k, 2)) * hw[i, ::-1]
        x1y1 = rng.uniform(0, 1, (k, 2)) * (hw[i, ::-1] - size)
        gt[i, :k] = np.concatenate([x1y1, x1y1 + size], -1)
        classes[i, :k] = rng.integers(1, cfg.data.num_classes + 1, k)
        valid[i, :k] = True
    return {"image": rng.integers(0, 255, (b, h, w, 3), np.uint8),
            "image_hw": hw, "gt_boxes": gt, "gt_classes": classes,
            "gt_valid": valid}


STEP = {"tpudet/step": None, "tpudet/preprocess": "tpudet/step"}
PREDICT = dict(STEP, **{"tpudet/predict": "tpudet/step",
                        "tpudet/backbone": "tpudet/predict",
                        "tpudet/postprocess": "tpudet/predict"})
TRAIN = dict(STEP, **{"tpudet/forward": "tpudet/step",
                      "tpudet/backward": "tpudet/step",
                      "tpudet/optimizer": "tpudet/step",
                      "tpudet/backbone": "tpudet/forward"})
# Each span -> the span it opens in (None: outside any).
NESTING = {
    "faster_rcnn_predict": dict(PREDICT, **{
        "tpudet/rpn": "tpudet/predict", "tpudet/roi_head": "tpudet/predict"}),
    "faster_rcnn_train": dict(TRAIN, **{
        "tpudet/rpn": "tpudet/forward", "tpudet/roi_head": "tpudet/forward"}),
    "deformable_detr_predict": dict(PREDICT, **{
        "tpudet/encoder": "tpudet/predict",
        "tpudet/decoder": "tpudet/predict"}),
    "deformable_detr_train": dict(TRAIN, **{
        "tpudet/encoder": "tpudet/forward",
        "tpudet/decoder": "tpudet/forward",
        "tpudet/set_loss": "tpudet/forward",
        "tpudet/matcher": "tpudet/set_loss",
        "tpudet/matcher/fetch": "tpudet/matcher"}),
}


def enclosing_span(event):
    parent = event.cpu_parent
    while parent is not None and not parent.name.startswith("tpudet/"):
        parent = parent.cpu_parent
    return None if parent is None else parent.name


@pytest.mark.parametrize("case", sorted(NESTING))
def test_steps_open_each_layer_span_once_nested(case):
    family, mode = case.rsplit("_", 1)
    cfg = (tconfig.tiny_test_config() if family == "faster_rcnn"
           else tconfig.tiny_deformable_detr_config())
    model = build_model(cfg, device="cpu").init(0)
    if mode == "train":
        state = create_train_state(model, cfg.train, seed=None, device="cpu")
        step = make_train_step(model, cfg, device="cpu", fused_preprocess=True)

        def call(b):
            return step(state, b)[1]["loss"]
    else:
        call = make_eval_step(model, cfg, fused_preprocess=True)
    batches = [batch(cfg, seed=s) for s in range(STEPS)]
    call(batches[0])  # lazy set-up (anchor caches) outside the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for b in batches:
            call(b)
    spans = [e for e in prof.events() if e.name.startswith("tpudet/")]
    want = NESTING[case]
    counts = {name: sum(e.name == name for e in spans) for name in want}
    assert counts == {name: STEPS for name in want}
    assert {e.name for e in spans} == set(want)
    assert {e.name: enclosing_span(e) for e in spans} == want


def test_an_exported_program_holds_no_profiler_op():
    cfg = tconfig.tiny_test_config()
    model = build_model(cfg, device="cpu").init(0)
    program = export_model(cfg, model, 1, ["cpu"])
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t]
