"""Timing and tracing helpers (``tpudet.utils.profiling``).

CUDA work is asynchronous: a call returns once its kernels are queued.
``sync`` waits for them, ``device_timeit`` is the benchmark's timing of
synced calls, and ``trace`` records a ``torch.profiler`` trace of the host
and the card, viewable in Perfetto or ``chrome://tracing``.

``span`` marks a layer of the program in such a trace: the steps
(``train/step.py``) and the models open ``tpudet/<layer>`` ranges
(``tpudet/step``, ``tpudet/backbone``, ``tpudet/matcher``, ...), which land
in the profiler's trace on the clock of the card's kernels. The names keep
clear of the ``tpudet::`` operator namespace, which names the kernels'
operators.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import numpy as np
import torch


# What ``span`` returns while no profiler runs: one shared context manager
# that does nothing (``nullcontext`` may be entered again and nested).
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` around the
    block while a profiler runs; otherwise the shared no-op ``_NO_SPAN``,
    after one check of the profiler's state: a ``record_function`` entered
    with no profiler running still allocates and dispatches its range,
    about a hundred times the check's host time."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def first_tensor(out) -> Optional[torch.Tensor]:
    """The first tensor leaf of ``out`` (nested dicts, lists and tuples)."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            found = first_tensor(item)
            if found is not None:
                return found
    return None


def sync(out) -> None:
    """Wait for the work that produces ``out``: the current CUDA stream of
    its first tensor leaf's device. Nothing to wait for on the CPU."""
    leaf = first_tensor(out)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.current_stream(leaf.device).synchronize()


def device_timeit(fn: Callable[[], object], iters: int = 10,
                  warmup: int = 2) -> float:
    """Median seconds per call of ``fn``, each call synced, after
    ``warmup`` calls."""
    for _ in range(warmup):
        sync(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        sync(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (host, and the card where CUDA is available) and
    write ``logdir/trace_<pid>_<ns>.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
