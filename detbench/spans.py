"""The program's own layer spans in a traced stretch, and the CUDA runtime
calls made inside its steps.

``tpudet_torch.utils.profiling.span`` opens ``tpudet/<layer>`` host ranges
while a profiler runs: ``tpudet/step`` around each call of the program's
step, and ranges for the step's phases, the models' layers and the matcher
inside it (``PERF.md`` section 3 lists them). A reading "per step" is over
the ``tpudet/step`` ranges that lie inside the traced stretch; a program
without them (a checkout older than the spans) gives none, and the readers
built on this module then read nothing.

The runtime calls are counted by time, on every host thread: the autograd
engine runs a step's backward on a thread of its own, whose launches fall
inside the main thread's ``tpudet/step`` range but under none of its ops.
"""

from __future__ import annotations

import bisect
import re
from typing import List, Optional, Sequence

from detbench import trace

STEP = "tpudet/step"
# CUDA API calls (cuda*, cu*) that block the host until the card is done.
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
# CUDA API calls that launch a kernel or a graph.
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch")
# CUPTI may name a call's per-thread-stream or versioned entry point.
_SUFFIX = re.compile(r"(_ptsz|_ptds|_v\d+)+$")


def inside(events: Sequence[dict], name: str, span) -> List[dict]:
    """The host ranges named ``name`` that lie within ``span``."""
    lo, hi = span
    return [e for e in events if e["kind"] != "device" and e["name"] == name
            and e["start"] >= lo and e["end"] <= hi]


def steps(ctx) -> List[dict]:
    return inside(ctx.events, STEP, ctx.span)


def ms_per_step(ctx, name: str, less: Optional[str] = None
                ) -> Optional[float]:
    """Host milliseconds per step of the ranges named ``name``, less the
    part of each that its ranges named ``less`` (on its thread, within it)
    cover; None without steps."""
    count = len(steps(ctx))
    if not count:
        return None
    children = inside(ctx.events, less, ctx.span) if less else []
    total = 0.0
    for r in inside(ctx.events, name, ctx.span):
        covered = trace.union(
            (c["start"], c["end"]) for c in children
            if c["tid"] == r["tid"] and c["start"] >= r["start"]
            and c["end"] <= r["end"])
        total += (r["end"] - r["start"]) - sum(e - s for s, e in covered)
    return total / count / 1e3


def calls_per_step(ctx, names: Sequence[str]) -> Optional[float]:
    """Host calls per step whose name (less a CUPTI suffix) is one of
    ``names`` and that start inside a step, on any thread; None without
    steps."""
    ranges = sorted((s["start"], s["end"]) for s in steps(ctx))
    if not ranges:
        return None
    starts = [s for s, _ in ranges]
    calls = 0
    for e in ctx.events:
        if e["kind"] == "device" or _SUFFIX.sub("", e["name"]) not in names:
            continue
        k = bisect.bisect_right(starts, e["start"]) - 1
        calls += k >= 0 and e["start"] <= ranges[k][1]
    return calls / len(ranges)
