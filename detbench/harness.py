"""One run of one cell: set up the program from the seed, warm up every
shape the cell's traffic uses, run the measured window, check what the
timed path produced against the plain reference, and print the result.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name in ``BENCHMARK.json``: the
configuration's file (the program's preset and the dotted config fields it
runs with, the weight draws, the reference and work modules), the mix's
``traffic/<mix>.json``, each metric's reader ``metrics/<name>.py`` (the
name up to its first dot), and the cell's limits ``limits/<cell>.json``,
searched under each of the benchmark's ``paths``.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import gc
import hashlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpudet")
BACKBONE = "detbench::backbone"


class NoChip(RuntimeError):
    """The cell asks for cards this machine does not have."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]
    bench: "Bench"


class Bench:
    """``BENCHMARK.json`` and the files under its ``paths``."""

    def __init__(self, root):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.paths = [self.root / p for p in self.spec["paths"]]

    def find(self, kind: str, name: str, suffix: str) -> Path:
        for base in self.paths:
            path = base / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                                f"{self.spec['paths']}")

    def module(self, relative: str):
        return load_module(self.root / relative)

    def reader(self, metric: str):
        return load_module(self.find("metrics", metric.split(".")[0], ".py"))

    def cell(self, name: str) -> Cell:
        work = {w["name"]: w for w in self.spec["workloads"]}
        if name not in work:
            raise ValueError(f"no workload {name!r}: {sorted(work)}")
        w = work[name]
        conf = {c["name"]: c for c in self.spec["configs"]}[w["config"]]
        config = json.loads((self.root / conf["file"]).read_text())
        traffic = json.loads(self.find("traffic", w["traffic"],
                                       ".json").read_text())

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]

        limits = json.loads(self.find("limits", name, ".json").read_text())
        return Cell(name, w["chips"], config, traffic,
                    mine(self.spec["end_to_end"]),
                    mine(self.spec["per_layer"]), limits["limits"], self)


def load_module(path: Path):
    path = Path(path).resolve()
    tag = hashlib.sha1(str(path).encode()).hexdigest()[:12]
    name = f"detbench_file_{path.stem.replace('.', '_')}_{tag}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _tuples(value):
    if isinstance(value, list):
        return tuple(_tuples(v) for v in value)
    return value


def port_config(config: dict):
    """The program's ``Config``: the preset with the file's ``sizes`` set
    on it, each read back to prove the program runs what the file says."""
    from tpudet_torch.cli.common import preset_config
    from tpudet_torch.config import apply_overrides

    sizes = {k: _tuples(v) for k, v in config["sizes"].items()}
    cfg = apply_overrides(preset_config(config["preset"]), sizes)
    for key, want in sizes.items():
        got = functools.reduce(getattr, key.split("."), cfg)
        if got != want:
            raise ValueError(f"{key}: the program runs {got!r}, the "
                             f"configuration file says {want!r}")
    return cfg


def require_chips(count: int):
    import torch

    if not torch.cuda.is_available():
        raise NoChip("no CUDA device: the benchmark measures the card and "
                     "never falls back to the CPU")
    if torch.cuda.device_count() < count:
        raise NoChip(f"the cell asks for {count} cards, this machine has "
                     f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the run must not hold, each
    compared whole (``tpudet_torch`` is not ``tpudet``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Setup:
    """What set-up hands the window: the program's entry, the pool, the
    weights (for the reference) and the cell's sizes."""

    cfg: Any
    model: Any
    weights: Dict[str, Any]
    pool: List[Dict[str, Any]]
    reference: Any
    work: Any
    device: Any


def set_up(cell: Cell, seed: int, device) -> Setup:
    """Build the program from the configuration, draw every weight from the
    seed and load the same tensors into it, and make the traffic's pool."""
    import torch

    from detbench import generator, weights as W
    from tpudet_torch.models import build_model

    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True  # as cli/benchmark.py sets it
    cfg = port_config(cell.config)
    reference = cell.bench.module(cell.config["reference"])
    work = cell.bench.module(cell.config["work"])
    model = build_model(cfg, device=device)
    spec = W.apply_draws(reference.spec(cell.config),
                         cell.config.get("draws", {}))
    weights = W.draw(spec, generator.stream(seed, "weights"), device)
    W.load_into(model.core, weights)
    sync(device)
    mark("model built, weights drawn and loaded")
    pool = generator.make_pool(cell.traffic, seed, device,
                               cfg.data.max_gt_boxes, cfg.data.num_classes)
    mark("traffic pool made")
    return Setup(cfg, model, weights, pool, reference, work, device)


_LAST = [time.perf_counter()]


def mark(what: str) -> None:
    """Seconds since the previous mark, on standard error (set-up's
    parts)."""
    now = time.perf_counter()
    print(f"detbench: {what}: {now - _LAST[0]:.3f} s", file=sys.stderr,
          flush=True)
    _LAST[0] = now


# ------------------------------------------------------------ inference
class InferLoop:
    """Closed loop over the pool with ``in_flight`` batches outstanding:
    each call copies a pinned batch to the card, preprocesses and predicts
    (``make_eval_step(fused_preprocess=True)``), and copies the detections
    back to pinned host buffers; a batch is done when its copy back has
    landed. Keeps the host outputs of the pool batches in ``keep``."""

    OUTPUTS = ("boxes", "scores", "classes", "valid")

    def __init__(self, setup: Setup, in_flight: int, keep):
        from tpudet_torch.train.step import make_eval_step

        self.setup = setup
        self.step = make_eval_step(setup.model, setup.cfg,
                                   fused_preprocess=True)
        self.in_flight = in_flight
        self.keep = {k: [] for k in keep}
        self.slots = []
        self.pending = collections.deque()
        self.i = 0

    def _buffers(self, out):
        import torch

        pin = self.setup.device.type == "cuda"
        return {k: torch.empty(out[k].shape, dtype=out[k].dtype,
                               pin_memory=pin) for k in self.OUTPUTS}

    def call(self):
        import torch

        k = self.i % len(self.setup.pool)
        batch = self.setup.pool[k]
        t_call = time.perf_counter()
        out = self.step({"image": batch["image"],
                         "image_hw": batch["image_hw"]})
        t_ret = time.perf_counter()
        slot = self.i % self.in_flight
        if len(self.slots) <= slot:
            self.slots.append(self._buffers(out))
        for name, buf in self.slots[slot].items():
            buf.copy_(out[name], non_blocking=True)
        event = None
        if self.setup.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self.pending.append((k, slot, t_call, t_ret, event))
        self.i += 1
        done = []
        while len(self.pending) >= self.in_flight:
            done.append(self._finish())
        return done

    def _finish(self):
        k, slot, t_call, t_ret, event = self.pending.popleft()
        if event is not None:
            event.synchronize()
        t_done = time.perf_counter()
        if k in self.keep:
            self.keep[k].append({n: b.numpy().copy()
                                 for n, b in self.slots[slot].items()})
        return {"batch": k, "call": t_call, "returned": t_ret,
                "done": t_done}

    def drain(self):
        return [self._finish() for _ in range(len(self.pending))]

    def run(self, seconds: float) -> List[dict]:
        """Calls until ``seconds`` have passed, then waits for the rest."""
        end = time.perf_counter() + seconds
        done = []
        while time.perf_counter() < end:
            done += self.call()
        return done + self.drain()


def infer_metrics(records: List[dict], images_per_batch: int,
                  start: float) -> Dict[str, float]:
    """The end-to-end readings of a window's batches."""
    last = max(r["done"] for r in records)
    lat = [(r["done"] - r["call"]) * 1e3 for r in records]
    p95 = (statistics.quantiles(lat, n=100)[94] if len(lat) > 1
           else lat[0])
    return {"infer_img_per_s": len(records) * images_per_batch
            / (last - start), "infer_p95_ms": p95}


class TrainLoop:
    """One training step at a time over the pool, each a call of
    ``make_train_step(fused_preprocess=True)`` on a pinned batch of uint8
    canvases and padded ground truth; a step is done when its loss has
    reached the host."""

    def __init__(self, setup: Setup):
        from tpudet_torch.train.state import create_train_state
        from tpudet_torch.train.step import make_train_step

        self.setup = setup
        self.state = create_train_state(setup.model, setup.cfg.train,
                                        seed=None, device=setup.device)
        self.step = make_train_step(setup.model, setup.cfg, setup.device,
                                    fused_preprocess=True)
        self.i = 0

    def call(self):
        k = self.i % len(self.setup.pool)
        t_call = time.perf_counter()
        self.state, metrics = self.step(self.state, self.setup.pool[k])
        t_ret = time.perf_counter()
        loss = float(metrics["loss"])
        self.metrics = metrics
        self.i += 1
        return [{"batch": k, "call": t_call, "returned": t_ret,
                 "done": time.perf_counter(), "loss": loss}]

    def run(self, seconds: float) -> List[dict]:
        end = time.perf_counter() + seconds
        done = []
        while time.perf_counter() < end:
            done += self.call()
        return done

    def first_steps(self, steps: int) -> dict:
        """The set-up's first ``steps`` steps through the window's own call,
        on pool batches that all differ -> each step's loss and gradient
        norm before clipping (as the step reports them), each leaf's first
        gradient as the optimizer got it (AdamW's first moment after one
        step over ``1 - beta1``), each leaf's change after the last step,
        and what the model's core returned in the first step's forward
        (``outputs``: its tensors in order, f32 on the host), taken by a
        forward hook inside the step's own call."""
        import torch

        core = self.setup.model.core
        named = dict(core.named_parameters())
        opt = self.state.optimizer
        out = {"losses": [], "grad_norms": [], "outputs": []}

        def keep(module, args, result):
            out["outputs"] = [t.detach().float().cpu() for t in result]

        for s in range(steps):
            hook = core.register_forward_hook(keep) if s == 0 else None
            try:
                out["losses"].append(self.call()[0]["loss"])
            finally:
                if hook is not None:
                    hook.remove()
            out["grad_norms"].append(float(self.metrics["grad_norm"]))
            if s == 0:
                beta1 = opt.param_groups[0]["betas"][0]
                norms = torch.stack([opt.state[p]["exp_avg"].norm()
                                     for p in named.values()]) / (1 - beta1)
                out["grad"] = dict(zip(named, norms.tolist()))
        change = torch.stack([(p.detach() - self.setup.weights[n]).norm()
                              for n, p in named.items()])
        out["change"] = dict(zip(named, change.tolist()))
        return out


def train_metrics(records: List[dict], images_per_step: int,
                  start: float) -> Dict[str, float]:
    last = max(r["done"] for r in records)
    return {"train_img_per_s": len(records) * images_per_step
            / (last - start)}


def check_train(setup: Setup, cell: Cell, program: dict,
                control: bool = False, detail: Optional[dict] = None):
    """The program's first steps against the reference following them from
    the same weights on the same batches -> the compared numbers; with
    ``control`` also the reference one step below the stated precision
    against the same reference."""
    import torch

    from detbench import compare
    from detbench.reference.common import Precision

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, cell.config["sizes"]["backbone.dtype"])
    steps = len(program["losses"])
    batches = setup.pool[:steps]
    ref = setup.reference.train(setup.weights, batches, cell.config,
                                Precision(dtype), steps)
    program = dict(program, outputs=dict(zip(ref["outputs"],
                                             program["outputs"])))
    numbers = compare.training(program, ref)
    if detail is not None:
        detail.update(ref_losses=ref["losses"],
                      grad_norms=program["grad_norms"],
                      ref_grad_norms=ref["grad_norms"],
                      worst=compare.worst_leaves(program, ref),
                      outputs=compare.output_stats(program["outputs"],
                                                   ref["outputs"]))
    if not control:
        return numbers
    lower = setup.reference.train(setup.weights, batches, cell.config,
                                  Precision(dtype, lower=True), steps)
    if detail is not None:
        detail.update(control_losses=lower["losses"],
                      control_grad_norms=lower["grad_norms"],
                      control_worst=compare.worst_leaves(lower, ref),
                      control_outputs=compare.output_stats(
                          lower["outputs"], ref["outputs"]))
    return numbers, compare.training(lower, ref)


def check_infer(setup: Setup, cell: Cell, seed: int, outputs: dict,
                control: bool = False):
    """The detections of the sampled pool batches, every time the window
    produced them, against the reference run on the same canvases and
    weights -> the compared numbers; with ``control`` also the numbers of
    the reference one step below the stated precision, held against the
    same reference (the control, which has to fail).

    The reference convolves without cuDNN (PyTorch's own im2col and GEMM,
    in the same precision), so its rounding never depends on which
    algorithm cuDNN's timing picked in this process: every run compares
    two independent roundings, as the limits were set from."""
    import numpy as np
    import torch

    from detbench import compare
    from detbench.reference.common import Precision

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cell.config
    dtype = getattr(torch, cfg["sizes"]["backbone.dtype"])
    block = cell.traffic.get("reference_block", 8)
    dets, thresh = setup.reference.kept(cfg)
    totals = [compare.empty(), compare.empty()]
    cudnn = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        for k in sorted(outputs):
            batch = setup.pool[k]

            def run(prec):
                parts = []
                for s in range(0, batch["image"].shape[0], block):
                    img = batch["image"][s:s + block].to(setup.device)
                    hw = batch["image_hw"][s:s + block].to(setup.device)
                    out = setup.reference.predict(setup.weights, img, hw,
                                                  cfg, prec)
                    parts.append({n: v.cpu().numpy()
                                  for n, v in out.items()})
                return {n: np.concatenate([p[n] for p in parts])
                        for n in parts[0]}

            ref = run(Precision(dtype))
            compare.merge(totals[0], compare.detections(
                _unique(outputs[k]), ref, dets, thresh))
            if control:
                compare.merge(totals[1], compare.detections(
                    [run(Precision(dtype, lower=True))], ref, dets, thresh))
    finally:
        torch.backends.cudnn.enabled = cudnn
    if control:
        return compare.summary(totals[0]), compare.summary(totals[1])
    return compare.summary(totals[0])


def _unique(outputs: List[dict]) -> List[dict]:
    seen, out = set(), []
    for o in outputs:
        key = hashlib.sha1(b"".join(v.tobytes() for v in o.values())
                           ).hexdigest()
        if key not in seen:
            seen.add(key)
            out.append(o)
    return out


def check_sample(cell: Cell, seed: int) -> List[int]:
    """The pool batches whose detections are checked, drawn from the
    seed."""
    import numpy as np

    from detbench.generator import stream

    rng = np.random.default_rng(stream(seed, "check"))
    pool = cell.traffic["pool"]
    return sorted(int(k) for k in rng.choice(
        pool, min(cell.traffic["check_batches"], pool), replace=False))


# ---------------------------------------------------------------- tracing
class Traced:
    """A ``torch.profiler`` session over the stretch, with the
    ``detbench::window`` range around it and the backbone range opened and
    closed by forward hooks."""

    def __init__(self, model):
        self.model = model
        self.hooks = []

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, record_shapes=True)
        self.prof.__enter__()
        self.range = torch.profiler.record_function("detbench::window")
        self.range.__enter__()
        backbone = self.model.core.backbone
        opened = []

        def pre(module, args):
            r = torch.profiler.record_function(BACKBONE)
            r.__enter__()
            opened.append(r)

        def post(module, args, out):
            opened.pop().__exit__(None, None, None)

        self.hooks = [backbone.register_forward_pre_hook(pre),
                      backbone.register_forward_hook(post)]
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()
        self.range.__exit__(None, None, None)
        self.prof.__exit__(*exc)
        return False


@dataclasses.dataclass
class Readings:
    """What a per-layer reader reads: the traced stretch's events and span,
    the untraced part of the window, the cell's sizes and the card's
    peaks."""

    events: List[dict]
    span: tuple
    untraced: Dict[str, Any]
    flops_per_step: float
    peaks: Optional[Dict[str, float]]
    cell: Cell


def read_trace(cell: Cell, traced: Traced, untraced: dict, setup: Setup,
               kind: str):
    from detbench import peaks as P
    from detbench import trace

    events = trace.from_profiler(traced.prof)
    mark(f"trace: {len(events)} events read")
    span = trace.window(events)
    b = cell.traffic["batch"]
    h, w = cell.traffic["canvas"]
    flops = setup.work.flops(cell.config, b, h, w,
                             train=cell.traffic["mode"] == "train")
    ctx = Readings(events, span, untraced, flops, P.peaks(kind), cell)
    metrics = {}
    for m in cell.per_layer:
        value = cell.bench.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    busy = trace.busy_us(events, span) / 1e6
    breakdown = {"device_ops": trace.top_device_ops(events, span),
                 "idle_gaps": trace.idle_gaps(events, span)}
    mark("trace: metrics and breakdown")
    return metrics, busy, (span[1] - span[0]) / 1e6, breakdown


# ------------------------------------------------------------------- run
def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        start: float, program_hook: Optional[Callable] = None) -> dict:
    """One run -> the result's dict (``checks`` last). ``program_hook``
    wraps the program's entry after set-up (the tests break it there)."""
    import torch

    tr = cell.traffic
    if tr["mode"] not in ("infer", "train"):
        raise ValueError(f"traffic mode {tr['mode']!r}")
    _LAST[0] = start
    mark("interpreter and imports")
    setup = set_up(cell, seed, device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if tr["mode"] == "train":
        loop = TrainLoop(setup)
        if program_hook is not None:
            loop.step = program_hook(loop.step)
        first = loop.first_steps(tr["check_steps"])
        sync(device)
        mark("first steps (kernel builds, cuDNN autotuning)")
    else:
        loop = InferLoop(setup, tr["in_flight"], check_sample(cell, seed))
        if program_hook is not None:
            loop.step = program_hook(loop.step)
        for i in range(tr.get("warmup_passes", 1) * len(setup.pool)):
            loop.call()
            if i == 0:
                loop.drain()
                mark("first call (kernel builds, cuDNN autotuning)")
        loop.drain()
        sync(device)
        mark("warm-up")
        for k in loop.keep:
            loop.keep[k].clear()
    setup_s = time.perf_counter() - start
    trace_s = min(tr["trace_seconds"], seconds / 2) if traced else 0.0
    t0 = time.perf_counter()
    records = loop.run(seconds - trace_s)
    untraced = {"seconds": max(r["done"] for r in records) - t0,
                "steps": len(records),
                "host_ms": [(r["returned"] - r["call"]) * 1e3
                            for r in records]}
    result: Dict[str, Any] = {}
    if traced:
        with Traced(setup.model) as session:
            records_t = loop.run(trace_s)
            sync(device)
        mark("traced stretch and profiler stop")
        attempted = (len(records) + len(records_t)) * tr["batch"]
    else:
        attempted = len(records) * tr["batch"]
    failed = sum(tr["batch"] for r in records if r.get("loss") is not None
                 and not math.isfinite(r["loss"]))
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"the run holds {bad} in sys.modules")
    if traced:
        metrics, busy, window, breakdown = read_trace(
            cell, session, untraced, setup, kind)
        del session
    else:
        e2e = (train_metrics if tr["mode"] == "train" else infer_metrics)(
            records, tr["batch"], t0)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    outputs = getattr(loop, "keep", None)
    del loop
    setup.model = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    mark("window and trace reading")
    if tr["mode"] == "train":
        numbers = check_train(setup, cell, first)
    else:
        numbers = check_infer(setup, cell, seed, outputs)
    mark("reference check")
    from detbench import compare

    verdicts = compare.judge(numbers, cell.limits)
    result["correct"] = all(ok for *_, ok in verdicts)
    result["attempted"] = attempted
    result["failed"] = failed
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if device.type == "cuda" else "cpu",
                        "kind": kind, "count": 1,
                        "memory_peak_bytes": int(peak)}
    if traced:
        result["device"].update(busy_s=busy, window_s=window)
        result["breakdown"] = breakdown
    for name, value, limit, ok in verdicts:
        print(f"check {name}: {value!r} (limit {limit!r}) "
              f"{'pass' if ok else 'FAIL'}", file=sys.stderr, flush=True)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit, _ in verdicts}
    return result


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, start: Optional[float] = None, root=None,
         device=None) -> dict:
    """Run the cell and print its result as the last line of standard
    output. ``device`` None asks for the card (the command's path); the
    tests pass the CPU."""
    start = time.perf_counter() if start is None else start
    args = parse(argv)
    root = Path(root) if root else Path(__file__).resolve().parents[1]
    cell = Bench(root).cell(args.workload)
    if device is None:
        device = require_chips(cell.chips)
    else:
        import torch

        device = torch.device(device)
    result = run(cell, args.seed, args.seconds, bool(args.trace), device,
                 start)
    print(json.dumps(result), flush=True)
    return result
