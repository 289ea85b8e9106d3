"""Benchmark CLI (``tpudet.cli.benchmark``).

Modes:
  infer         batched inference throughput (images/s), batch on the card
  infer_stream  the same fed by the loader's stream (host prep included)
  train         train step throughput
  nms           NMS µs per image at 6,000 proposals -> 300 (device time
                of CUDA-graph replays on the card)
  host          the host image front end: PIL vs the native C++ decoder

Prints one JSON line per run, ``{"metric", "value", "unit", ...}``, and
``main(argv)`` returns it. Each line names its device. Runs on the CUDA
card unless ``--device cpu`` is passed; without a card it fails rather than
run on the CPU. Examples:

  python -m tpudet_torch.cli.benchmark --preset voc_r50 --mode infer \\
      --set backbone.dtype=bfloat16
  python -m tpudet_torch.cli.benchmark --preset tiny --mode infer \\
      --batch-size 2 --iters 2 --device cpu

The JAX package's version also appends every hardware result to
``BENCH_PROVENANCE.jsonl`` and divides the infer rate by a TPU target
(``vs_baseline``); this one does neither.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import time

import numpy as np
import torch

from tpudet_torch.cli.common import add_common_args, config_from_args
from tpudet_torch.data import DataLoader, SyntheticDataset
from tpudet_torch.models import build_model
from tpudet_torch.train.state import create_train_state
from tpudet_torch.train.step import make_eval_step, make_train_step
from tpudet_torch.utils.profiling import device_timeit, sync, trace

# Untimed calls before each timed span.
WARMUP = 2
# Batches that infer_stream times, and the most that it keeps in flight.
STREAM_BATCHES = 20
STREAM_IN_FLIGHT = 4
# NMS calls in the many-calls span of the nms mode.
NMS_REPS = 128


def _family(cfg) -> str:
    """Benchmark family label: the model name, except that ViT-backbone
    Faster R-CNN configs report as their own ``vitdet`` family."""
    if cfg.model == "faster_rcnn" and cfg.backbone.name.startswith("vit"):
        return "vitdet"
    return cfg.model


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def resolve_device(name: str) -> torch.device:
    """``--device``'s torch device; a CUDA device must exist."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: torch.cuda.is_available() is False; the "
            "benchmark runs on the card (--device cpu times the plain "
            "versions on the CPU)")
    return device


def _make_batch(cfg, batch_size: int, device) -> dict:
    """The first loader batch of ``batch_size`` synthetic images on
    ``device``."""
    ds = SyntheticDataset(num_classes=cfg.data.num_classes,
                          num_examples=batch_size,
                          image_size=min(cfg.data.canvas_height, 512))
    loader = DataLoader(cfg, ds, batch_size, shuffle=False, num_workers=8)
    batches = loader.batches(0)
    raw = next(batches)
    batches.close()
    return {k: torch.from_numpy(v).to(device) for k, v in raw.items()}


class Timer:
    """The timed spans of one run. With a trace directory, the first span
    (never model build or warm-up) runs under ``profiling.trace``."""

    def __init__(self, trace_dir: str = ""):
        self.trace_dir = trace_dir
        self.traced = False

    def span(self):
        if self.trace_dir and not self.traced:
            self.traced = True
            return trace(self.trace_dir)
        return contextlib.nullcontext()

    def timeit(self, fn, iters: int) -> float:
        """Median seconds of a synced call (``WARMUP`` calls inside the
        span, after the caller's own warm-up)."""
        with self.span():
            return device_timeit(fn, iters, warmup=WARMUP)

    def timeit_pipelined(self, fn, iters: int) -> float:
        """Steady-state seconds per call: enqueue ``iters`` calls, sync
        once, so that the host's dispatch of a call overlaps the card's
        work on the ones before it (what a serving pipeline sees)."""
        for _ in range(WARMUP):
            sync(fn())
        with self.span():
            t0 = time.perf_counter()
            out = None
            for _ in range(iters):
                out = fn()
            sync(out)
            return (time.perf_counter() - t0) / iters

    def calls_timeit(self, fn, calls: int, iters: int, device) -> float:
        """Median seconds of ``calls`` back-to-back calls of ``fn``, over
        ``iters`` samples. On the card the calls are captured in one CUDA
        graph and each replay is timed between CUDA events: device time,
        without the host's launch path (Python, the dispatcher, ctypes),
        as the JAX package's one jitted program of the calls is. On the
        CPU, the host clock of eager calls."""
        if device.type != "cuda":
            for _ in range(WARMUP):
                fn()
            times = []
            with self.span():
                for _ in range(iters):
                    t0 = time.perf_counter()
                    for _ in range(calls):
                        fn()
                    times.append(time.perf_counter() - t0)
            return float(np.median(times))
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
            for _ in range(WARMUP):
                fn()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()  # the first replay uploads the graph
        torch.cuda.synchronize(device)
        times = []
        with self.span():
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(main)
                graph.replay()
                end.record(main)
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
        return float(np.median(times))


def bench_infer(cfg, batch_size: int, iters: int, device,
                timer: Timer) -> dict:
    model = build_model(cfg, device=device).init(0)
    step = make_eval_step(model, cfg, fused_preprocess=True)
    batch = _make_batch(cfg, batch_size, device)
    sec = timer.timeit_pipelined(lambda: step(batch), iters)
    sec_latency = timer.timeit(lambda: step(batch), iters)
    ips = batch_size / sec
    return {
        "metric": f"{_family(cfg)}_infer_images_per_sec_per_chip",
        "value": round(ips, 2),
        "unit": "images/sec/chip",
        "batch_size": batch_size,
        "sec_per_batch": round(sec, 5),
        "sec_per_batch_synced": round(sec_latency, 5),
        "total_images_per_sec": round(ips, 2),
        "backend": device.type,
        "device": _device_name(device),
        "num_devices": 1,
    }


def bench_infer_stream(cfg, batch_size: int, device, timer: Timer,
                       num_batches: int = STREAM_BATCHES) -> dict:
    """Sustained inference fed by the loader: host prep on its threads, the
    pinned copy on a side stream and the predict, overlapped. At most
    ``STREAM_IN_FLIGHT`` batches are queued on the card: each batch records
    a CUDA event and the host waits on the oldest."""
    model = build_model(cfg, device=device).init(0)
    step = make_eval_step(model, cfg, fused_preprocess=True)
    ds = SyntheticDataset(num_classes=cfg.data.num_classes,
                          num_examples=batch_size * (num_batches + 2),
                          image_size=min(cfg.data.canvas_height, 512))
    loader = DataLoader(cfg, ds, batch_size, shuffle=False, num_workers=8)
    stream = loader.device_stream(device)

    def done(out):
        """A CUDA event after ``out``'s work; None on the CPU, where the
        work is done when the call returns."""
        if device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        return event

    try:
        sync(step(next(stream)))  # warm the pipeline
        in_flight = []
        with timer.span():
            t0 = time.perf_counter()
            for _ in range(num_batches):
                in_flight.append(done(step(next(stream))))
                if len(in_flight) > STREAM_IN_FLIGHT:
                    event = in_flight.pop(0)
                    if event is not None:
                        event.synchronize()
            for event in in_flight:
                if event is not None:
                    event.synchronize()
            sec = (time.perf_counter() - t0) / num_batches
    finally:
        stream.close()
    ips = batch_size / sec
    return {
        "metric": f"{_family(cfg)}_infer_stream_images_per_sec_per_chip",
        "value": round(ips, 2),
        "unit": "images/sec/chip",
        "batch_size": batch_size,
        "num_batches": num_batches,
        "sec_per_batch": round(sec, 5),
        "backend": device.type,
        "device": _device_name(device),
        "num_devices": 1,
    }


def bench_train(cfg, batch_size: int, iters: int, device,
                timer: Timer) -> dict:
    # The step checks accum_steps against the benched batch, not the
    # preset's.
    cfg = cfg.replace(
        train=dataclasses.replace(cfg.train, batch_size=batch_size))
    model = build_model(cfg, device=device)
    state = create_train_state(model, cfg.train, seed=0, device=device)
    step_fn = make_train_step(model, cfg, device=device, fused_preprocess=True)
    batch = _make_batch(cfg, batch_size, device)

    def run():
        _, metrics = step_fn(state, batch)  # updates state in place
        return metrics["loss"]

    sync(run())  # warm up outside the traced span
    sec = timer.timeit(run, iters)
    ips = batch_size / sec
    return {
        "metric": f"{_family(cfg)}_train_images_per_sec",
        "value": round(ips, 2),
        "unit": "images/sec",
        "batch_size": batch_size,
        "sec_per_step": round(sec, 5),
        "backend": device.type,
        "device": _device_name(device),
    }


def nms_inputs(num_boxes: int, device) -> tuple:
    """The nms mode's proposals: ``num_boxes`` boxes of 20-200 px over a
    900 px field and uniform scores, from seed 0."""
    rng = np.random.default_rng(0)
    xy1 = rng.uniform(0, 900, (num_boxes, 2)).astype(np.float32)
    wh = rng.uniform(20, 200, (num_boxes, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy1, xy1 + wh], -1)).to(device)
    scores = torch.from_numpy(
        rng.uniform(0, 1, num_boxes).astype(np.float32)).to(device)
    return boxes, scores


def bench_nms(cfg, iters: int, device, timer: Timer, num_boxes: int = 6000,
              max_out: int = 300) -> dict:
    """The tracked 'NMS kernel µs/img' metric on realistic proposal counts:
    one call and ``NMS_REPS`` calls, each timed whole; the difference over
    ``NMS_REPS - 1`` is one call's share. On the card both are CUDA-graph
    replays (``Timer.calls_timeit``), so this is the device time of the
    dispatch (sort, gather, the NMS kernels, the output's mask). The
    wrappers count their launches while the graphs are captured (and in
    the warm-up calls), not in the replays."""
    from tpudet_torch.kernels import nms_dispatch

    boxes, scores = nms_inputs(num_boxes, device)
    reps = NMS_REPS

    def one():
        return nms_dispatch(boxes, scores, 0.7, max_out)

    t_one = timer.calls_timeit(one, 1, iters, device)
    t_many = timer.calls_timeit(one, reps, iters, device)
    diff = t_many - t_one
    sec = diff / (reps - 1)
    # Not resolved: a difference at or below 0, or under 2% of one call.
    below_noise = diff <= 0 or diff < 0.02 * t_one
    return {
        "metric": "nms_kernel_us_per_img",
        "value": round(max(sec, 0.0) * 1e6, 3),
        "unit": "us/img",
        "below_noise": below_noise,
        "t_one_call_us": round(t_one * 1e6, 1),
        "t_many_calls_us": round(t_many * 1e6, 1),
        "reps": reps,
        "num_boxes": num_boxes,
        "max_out": max_out,
        "route": "cuda" if device.type == "cuda" else "plain",
        "clock": "cuda_graph" if device.type == "cuda" else "host",
        "backend": device.type,
        "device": _device_name(device),
    }


def host_jpegs(num_images: int = 64, seed: int = 0) -> list:
    """VOC-sized JPEGs (350-500 x 450-640, smooth noise, quality 90), the
    JAX package's recipe with PIL: a bilinear upscale of noise, saved at
    quality 90."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    jpegs = []
    for _ in range(num_images):
        h, w = int(rng.integers(350, 500)), int(rng.integers(450, 640))
        small = rng.integers(0, 255, (h // 8, w // 8, 3), np.uint8)
        img = np.asarray(Image.fromarray(small).resize((w, h), Image.BILINEAR))
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=90)
        jpegs.append(buf.getvalue())
    return jpegs


def bench_host(cfg, device, num_images: int = 64, num_threads: int = 0
               ) -> dict:
    """The host image front end on VOC-sized JPEGs: PIL's decode and the
    port's resize; where the native library builds (g++ and libjpeg), also
    the native fused decode + resize + pad per image (exact, and with
    libjpeg's DCT scaling) and batched on ``num_threads`` threads. Host
    work only."""
    from PIL import Image

    from tpudet_torch.data.preprocess import (
        prepare_example,
        prepare_example_jpeg,
    )
    from tpudet_torch.native import native_available

    if num_threads <= 0:
        num_threads = os.cpu_count() or 1
    jpegs = host_jpegs(num_images)
    no_boxes = (np.zeros((0, 4), np.float32), np.zeros(0, np.int32))
    d = cfg.data

    def run(fn):
        t0 = time.perf_counter()
        for data in jpegs:
            fn(data)
        return num_images / (time.perf_counter() - t0)

    pil_ips = run(lambda data: prepare_example(
        d, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), *no_boxes))
    result = {
        "metric": "host_front_end_images_per_sec",
        "unit": "images/sec",
        "pil_images_per_sec": round(pil_ips, 2),
        "value": round(pil_ips, 2),
        "canvas": [d.canvas_height, d.canvas_width],
        "num_threads": num_threads,
        "cpu_count": os.cpu_count(),
        "device": _device_name(device),
    }
    if native_available():
        from tpudet_torch.data import native_decode as nd

        d_exact = dataclasses.replace(d, fast_jpeg_scale=False)
        result["native_exact_images_per_sec"] = round(run(
            lambda data: prepare_example_jpeg(d_exact, data, *no_boxes)), 2)
        result["native_images_per_sec"] = round(run(
            lambda data: prepare_example_jpeg(d, data, *no_boxes)), 2)

        def batch_all():
            t0 = time.perf_counter()
            nd.decode_batch(jpegs, d.min_size, d.max_size, d.canvas_height,
                            d.canvas_width, fast_dct_scale=d.fast_jpeg_scale,
                            num_threads=num_threads)
            return num_images / (time.perf_counter() - t0)

        batch_all()  # warm (thread spawn, page faults)
        result["native_batch_images_per_sec"] = round(batch_all(), 2)
        result["value"] = result["native_batch_images_per_sec"]
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(p)
    p.add_argument("--mode", default="infer",
                   choices=["infer", "infer_stream", "train", "nms", "host"])
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--trace-dir", default="",
                   help="write a torch.profiler Chrome trace of the first "
                        "measured span into this directory")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True  # fixed shapes throughout
    timer = Timer(args.trace_dir)
    if args.mode == "infer":
        result = bench_infer(cfg, args.batch_size, args.iters, device, timer)
    elif args.mode == "infer_stream":
        result = bench_infer_stream(cfg, args.batch_size, device, timer)
    elif args.mode == "train":
        result = bench_train(cfg, args.batch_size, args.iters, device, timer)
    elif args.mode == "host":
        result = bench_host(cfg, device)
    else:
        result = bench_nms(cfg, args.iters, device, timer)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
