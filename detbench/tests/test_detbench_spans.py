"""The readers of the program's layer spans against hand-made event lists:
the matcher's solve is its span less its fetch child, runtime calls count
per step on any thread inside a step, nothing reads without steps, and the
spans leave the readers that were there before them unchanged."""

from types import SimpleNamespace

import pytest

from detbench import trace
from detbench.tests.test_detbench_trace import ctx, events, op, reader

BACKWARD = 2  # the autograd engine's thread


def call(name, start, tid=1):
    """A runtime call of 1 us, as ``trace.from_profiler`` gives one."""
    return dict(name=name, kind="launch", start=start, end=start + 1, id=0,
                link=99, tid=tid)


def two_steps():
    """Two steps in a 100 us stretch: each a matcher span of 10 us with a
    4 us fetch (and the first another 2 us fetch), an optimizer span, two
    launches and a sync on the main thread and a launch from the backward
    thread inside the step; a launch and a sync between the steps."""
    ev = [op(trace.WINDOW, 0, 100, 1)]
    for k, at in enumerate((0, 50)):
        ev += [op("tpudet/step", at + 1, at + 40, 10 + k),
               op("tpudet/matcher", at + 5, at + 15, 20 + k),
               op("tpudet/matcher/fetch", at + 6, at + 10, 30 + k),
               op("tpudet/optimizer", at + 30, at + 38, 40 + k),
               call("cudaLaunchKernel", at + 2), call("cuLaunchKernel",
                                                      at + 3),
               call("cudaStreamSynchronize", at + 7),
               call("cudaLaunchKernel", at + 20, tid=BACKWARD)]
    ev += [op("tpudet/matcher/fetch", 11, 13, 50),
           call("cudaLaunchKernel", 45), call("cudaMemcpy", 46),
           call("cudaLaunchKernel_ptsz", 44, tid=BACKWARD)]
    return ev


def test_the_matcher_reads_its_solve_per_step():
    # (10 - 4 - 2) + (10 - 4) us over two steps.
    assert reader("matcher_ms").read(ctx(two_steps())) == pytest.approx(
        0.005)
    assert reader("optimizer_ms").read(ctx(two_steps())) == pytest.approx(
        0.008)


def test_calls_count_inside_steps_on_any_thread():
    ev = two_steps()
    assert reader("launches_per_step").read(ctx(ev)) == 3.0
    assert reader("syncs_per_step").read(ctx(ev)) == 1.0
    # A third step, with no calls, divides them by three; the calls
    # between the steps still count for none.
    ev.append(op("tpudet/step", 90, 95, 60))
    assert reader("launches_per_step").read(ctx(ev)) == 2.0
    ev.append(call("cudaDeviceSynchronize", 92, tid=BACKWARD))
    assert reader("syncs_per_step").read(ctx(ev)) == 1.0


def test_nothing_reads_without_a_step():
    ev = [e for e in two_steps() if e["name"] != "tpudet/step"]
    for name in ("matcher_ms", "optimizer_ms", "syncs_per_step",
                 "launches_per_step"):
        assert reader(name).read(ctx(ev)) is None
    # A step outside the stretch is not one of its steps.
    ev.append(op("tpudet/step", 120, 130, 70))
    assert reader("launches_per_step").read(ctx(ev)) is None


def with_spans(ev):
    """``events()`` inside the program's spans, as the steps and the models
    open them."""
    return ev + [op("tpudet/step", 0.5, 99, 80),
                 op("tpudet/predict", 0.6, 98, 81),
                 op("tpudet/backbone", 0.7, 21, 82),
                 op("tpudet/roi_head", 40, 47, 83),
                 op("tpudet/postprocess", 55, 95, 84)]


def test_spans_leave_the_other_readers_unchanged():
    for name in ("device_idle_pct", "backbone_ms", "roi_align_roofline_pct",
                 "deform_attn_roofline_pct"):
        assert (reader(name).read(ctx(with_spans(events())))
                == reader(name).read(ctx(events())))


class Kineto:
    """A ``torch.profiler`` event of the kineto results."""

    def __init__(self, name, start, end, device, corr=0, link=0,
                 annotation=False):
        self._v = (name, start, end, device, corr, link, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1] * 1000

    def duration_ns(self):
        return (self._v[2] - self._v[1]) * 1000

    def start_thread_id(self):
        return 1

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[6]


def test_the_spans_device_copies_stay_out_of_the_busy_time():
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    raw = [Kineto(trace.WINDOW, 0, 100, cpu),
           Kineto("tpudet/step", 1, 99, cpu),
           Kineto("aten::add", 2, 4, cpu, corr=3),
           Kineto("cudaLaunchKernel", 2.5, 3.5, cpu, corr=7, link=3),
           # The profiler's device-side copy of the host range spans the
           # whole step; the kernel runs 10 us of it.
           Kineto("tpudet/step", 5, 90, cuda),
           Kineto("add_kernel", 10, 20, cuda, corr=7, link=3)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: raw)))
    ev = trace.from_profiler(prof)
    assert [e["name"] for e in ev if e["kind"] == "device"] == ["add_kernel"]
    assert reader("device_idle_pct").read(ctx(ev)) == pytest.approx(90.0)
    assert reader("launches_per_step").read(ctx(ev)) == 1.0


def tiny_predict(family, device):
    """The tiny Faster R-CNN or Deformable DETR's eval step on ``device``
    and a batch of two uint8 canvases."""
    import numpy as np
    import torch

    from tpudet_torch import config
    from tpudet_torch.models import build_model
    from tpudet_torch.train.step import make_eval_step

    cfg = (config.tiny_test_config() if family == "faster_rcnn"
           else config.tiny_deformable_detr_config())
    model = build_model(cfg, device=device).init(0)
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.integers(
                 0, 255, (2, 128, 128, 3), np.uint8)),
             "image_hw": torch.tensor([[128.0, 128.0], [96.0, 112.0]])}
    return make_eval_step(model, cfg), batch


def kernel_launches():
    from tpudet_torch.kernels import deform_attn, nms, roi_align
    from tpudet_torch.kernels import roi_align_window

    return (nms.LAUNCHES + roi_align.LAUNCHES + roi_align_window.LAUNCHES
            + deform_attn.LAUNCHES)


# The most the card's clock may sit from the host's in a trace: under it a
# 2 s traced stretch's device_idle_pct moves by less than 0.25 points.
CLOCK_US = 5000.0


@pytest.mark.cuda
@pytest.mark.parametrize("family,layer", [("faster_rcnn", "tpudet/roi_head"),
                                          ("deformable_detr",
                                           "tpudet/encoder")])
def test_spans_launches_and_kernels_on_the_card(family, layer):
    """On the card: the launch calls of the kernels under a layer's span
    start inside it, on the host's clock; the kernels' clock sits within
    ``CLOCK_US`` of it (each kernel starts after its launch call, less an
    offset that the profiler's conversion of the card's timestamps leaves
    and that differs from session to session); and the launches counted
    per step hold at least the program's own kernel launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runtime calls and kernels of a "
                    "traced step exist only there")
    step, batch = tiny_predict(family, torch.device("cuda"))
    step(batch)  # builds the kernels
    torch.cuda.synchronize()
    before = kernel_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            for _ in range(2):
                step(batch)
            torch.cuda.synchronize()
    own = kernel_launches() - before
    ev = trace.from_profiler(prof)
    readings = ctx(ev)
    readings.span = trace.window(ev)
    launches = reader("launches_per_step").read(readings)
    syncs = reader("syncs_per_step").read(readings)
    ops = {e["id"]: e for e in ev if e["kind"] == "op"}
    calls = {e["id"]: e for e in ev if e["kind"] == "launch"}
    kernels = [(d, calls[d["id"]]) for d in ev
               if d["kind"] == "device" and d["id"] in calls]
    offset = min(d["start"] - c["start"] for d, c in kernels)
    under = []
    for r in (e for e in ev if e["name"] == layer):
        for d, c in kernels:
            o = ops.get(d["link"])
            if (o is not None and o["tid"] == r["tid"]
                    and r["start"] <= o["start"] <= r["end"]):
                under.append((c["start"] - r["start"], r["end"] - c["start"],
                              d["start"] - r["start"]))
    print(f"{family}: {launches} launches and {syncs} syncs per step, "
          f"{own / 2} of the program's kernels; {len(under)} kernels under "
          f"{layer}, the first launched {min(u[0] for u in under)} us and "
          f"starting {min(u[2] for u in under)} us after it opens; the "
          f"card's clock {offset} us from the host's")
    assert launches is not None and launches * 2 >= own > 0
    assert under and min(min(u[0], u[1]) for u in under) >= 0
    assert offset > -CLOCK_US
