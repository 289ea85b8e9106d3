"""The traced stretch of a window, read in memory: ``torch.profiler``'s
events as plain records, and the reductions that the per-layer readers
share. Nothing is written to disk.

An event is a dict with ``name``, ``kind`` ("op": an operator or a
``record_function`` range on a host thread; "launch": a host call into the
CUDA runtime; "device": a kernel, copy or fill on the card), ``start`` and
``end`` in microseconds on one clock, ``tid`` (host thread), ``id`` (an
op's correlation id), ``link`` (for a launch or device event: the id of the
op that was innermost when it was launched), and for the program's kernel
operators (``SHAPED``) ``shapes``, ``dtypes`` and ``scalars`` (the inputs'
shapes, dtypes and constant values).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

WINDOW = "detbench::window"
# Ops whose input shapes the records keep (the program's kernel operators).
SHAPED = ("tpudet::",)


def from_profiler(prof) -> List[dict]:
    """The events of a finished ``torch.profiler.profile`` (run with
    ``record_shapes=True``) as records. The device-side copies of host
    ranges (the profiler's user annotations, which span every kernel of
    their range and the gaps between) are left out: a device event that
    bears the name of a host event is one."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    raw = prof.profiler.kineto_results.events()
    annotations = {ev.name() for ev in raw if ev.device_type() != cuda}
    for ev in raw:
        start = ev.start_ns() / 1e3
        rec = {"name": ev.name(), "start": start,
               "end": start + ev.duration_ns() / 1e3,
               "tid": ev.start_thread_id(), "id": ev.correlation_id(),
               "link": ev.linked_correlation_id()}
        if ev.device_type() == cuda:
            if _user_range(ev) or ev.name() in annotations:
                continue
            rec["kind"] = "device"
        elif rec["link"] > 0:
            rec["kind"] = "launch"
        else:
            rec["kind"] = "op"
            if rec["name"].startswith(SHAPED):
                rec["shapes"] = [list(s) for s in ev.shapes()]
                rec["dtypes"] = list(ev.dtypes())
                try:
                    rec["scalars"] = list(ev.concrete_inputs())
                except (AttributeError, RuntimeError):
                    rec["scalars"] = []
        out.append(rec)
    return out


def _user_range(ev) -> bool:
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


def window(events: Sequence[dict], name: str = WINDOW) -> Tuple[float,
                                                                float]:
    """``(start, end)`` of the host range ``name`` (the traced stretch)."""
    spans = [e for e in events if e["kind"] == "op" and e["name"] == name]
    if not spans:
        raise ValueError(f"no {name} range in the trace")
    return min(e["start"] for e in spans), max(e["end"] for e in spans)


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float,
                                                                  float]]:
    """Sorted disjoint cover of ``intervals``."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy(events: Sequence[dict], span: Tuple[float, float]
         ) -> List[Tuple[float, float]]:
    """The union of the device events' intervals, clipped to ``span``:
    overlapping kernels count once."""
    lo, hi = span
    return [(max(s, lo), min(e, hi)) for s, e in union(
        (e["start"], e["end"]) for e in events if e["kind"] == "device")
        if e > lo and s < hi]


def busy_us(events: Sequence[dict], span: Tuple[float, float]) -> float:
    return sum(e - s for s, e in busy(events, span))


def under(events: Sequence[dict], name: str) -> List[Tuple[dict, float]]:
    """Each host range or op named ``name``, with the device time (us) of
    the work launched inside it: the device events whose launching op
    started within the range, on its thread."""
    by_tid: Dict[int, List[dict]] = defaultdict(list)
    for e in events:
        if e["kind"] == "op":
            by_tid[e["tid"]].append(e)
    starts = {}
    for tid, ops in by_tid.items():
        ops.sort(key=lambda e: e["start"])
        starts[tid] = [e["start"] for e in ops]
    device_by_link: Dict[int, float] = defaultdict(float)
    for e in events:
        if e["kind"] == "device":
            device_by_link[e["link"]] += e["end"] - e["start"]
    out = []
    for tid, ops in by_tid.items():
        for r in ops:
            if r["name"] != name:
                continue
            lo = bisect.bisect_left(starts[tid], r["start"])
            hi = bisect.bisect_right(starts[tid], r["end"])
            out.append((r, sum(device_by_link.get(o["id"], 0.0)
                               for o in ops[lo:hi])))
    return out


def top_device_ops(events: Sequence[dict], span, n: int = 10
                   ) -> List[list]:
    """The ``n`` device operations that took most time in ``span``, as
    ``[name, seconds]``."""
    lo, hi = span
    total: Dict[str, float] = defaultdict(float)
    for e in events:
        if e["kind"] == "device" and e["end"] > lo and e["start"] < hi:
            total[e["name"]] += min(e["end"], hi) - max(e["start"], lo)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e6] for k, v in ranked]


def idle_gaps(events: Sequence[dict], span, n: int = 10) -> List[list]:
    """The device's idle time in ``span`` by what the host was doing: each
    gap between busy intervals is named after the innermost host op or
    runtime call open at its middle on any thread (``"host python"`` where
    none is), and the gaps of one name are summed; the ``n`` largest, as
    ``[name, seconds]``."""
    lo, hi = span
    gaps, at = [], lo
    for s, e in busy(events, span):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < hi:
        gaps.append((at, hi))
    mids = sorted((0.5 * (s + e), e - s) for s, e in gaps)
    best: List[Optional[dict]] = [None] * len(mids)
    threads: Dict[int, List[dict]] = defaultdict(list)
    for e in events:
        if e["kind"] in ("op", "launch") and e["name"] != WINDOW:
            threads[e["tid"]].append(e)
    for ops in threads.values():
        ops.sort(key=lambda e: (e["start"], -e["end"]))
        stack: List[dict] = []
        j = 0
        for k, (m, _) in enumerate(mids):
            while j < len(ops) and ops[j]["start"] <= m:
                while stack and stack[-1]["end"] < ops[j]["start"]:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and stack[-1]["end"] < m:
                stack.pop()
            if stack and (best[k] is None or _length(stack[-1])
                          < _length(best[k])):
                best[k] = stack[-1]
    total: Dict[str, float] = defaultdict(float)
    for (_, length), op in zip(mids, best):
        total["host python" if op is None else op["name"]] += length
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e6] for k, v in ranked]


def _length(e: dict) -> float:
    return e["end"] - e["start"]
