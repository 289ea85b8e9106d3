"""The trace reductions and the per-layer readers against hand-made event
lists: overlapping kernels count once, device time goes to the range whose
ops launched it, idle gaps are named by the innermost host op."""

import importlib.util
from pathlib import Path

import pytest

from detbench import trace
from detbench.harness import Readings

HERE = Path(__file__).resolve().parents[1]


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def op(name, start, end, id_, tid=1, **kw):
    return dict(name=name, kind="op", start=start, end=end, id=id_, link=0,
                tid=tid, shapes=kw.get("shapes", []),
                dtypes=kw.get("dtypes", []), scalars=kw.get("scalars", []))


def dev(name, start, end, link):
    return dict(name=name, kind="device", start=start, end=end, id=0,
                link=link, tid=0)


def events():
    """A 100 us stretch: the backbone range (ops 2, 3) launches a conv
    (10-30) and an add (25-40, overlapping it); the RoI Align operator (4)
    launches its kernel (50-60); a sync (5) waits from 60 to 90 while a
    copy runs (80-90)."""
    return [
        op(trace.WINDOW, 0, 100, 1),
        op("detbench::backbone", 1, 20, 2),
        op("aten::convolution", 2, 4, 3),
        op("aten::add", 6, 8, 6),
        op("tpudet::roi_align_fwd", 41, 45, 4,
           shapes=[[32, 40, 40, 256], [9600, 4], [9600], [], []],
           dtypes=["c10::BFloat16", "float", "int", "Scalar", "Scalar"],
           scalars=["", "", "", 7, 2]),
        op("cudaStreamSynchronize", 60, 90, 5),
        dev("conv_kernel", 10, 30, 3),
        dev("add_kernel", 25, 40, 6),
        dev("roi_align_fwd_kernel", 50, 60, 4),
        dev("Memcpy DtoH", 80, 90, 5),
    ]


def test_busy_counts_overlap_once():
    ev = events()
    assert trace.busy(ev, (0, 100)) == [(10, 40), (50, 60), (80, 90)]
    assert trace.busy_us(ev, (0, 100)) == 50
    assert trace.busy_us(ev, (35, 85)) == 5 + 10 + 5


def test_device_time_under_a_range():
    ev = events()
    (rng, us), = trace.under(ev, "detbench::backbone")
    assert us == 20 + 15  # the conv and the overlapping add, each in full
    (call, us), = trace.under(ev, "tpudet::roi_align_fwd")
    assert us == 10 and call["scalars"][3] == 7


def test_idle_gaps_named_by_the_innermost_host_op():
    ev = events()
    gaps = dict(trace.idle_gaps(ev, (0, 100)))
    assert gaps["cudaStreamSynchronize"] == pytest.approx(20e-6)
    assert gaps["detbench::backbone"] == pytest.approx(10e-6)
    assert gaps["tpudet::roi_align_fwd"] == pytest.approx(10e-6)
    assert gaps["host python"] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(50e-6)
    top = trace.top_device_ops(ev, (0, 100))
    assert top[0] == ["conv_kernel", pytest.approx(20e-6)]


def ctx(ev, untraced=None):
    return Readings(ev, (0, 100), untraced or {}, 80e9,
                    {"bf16_flops": 989e12, "f32_flops": 67e12,
                     "hbm_bytes": 3.35e12}, None)


def test_readers():
    ev = events()
    assert reader("device_idle_pct").read(ctx(ev)) == pytest.approx(50.0)
    assert reader("backbone_ms").read(ctx(ev)) == pytest.approx(0.035)
    # The bytes of this shape (PERF.md's 0.0798 ms bound) over 10 us.
    roofline = reader("roi_align_roofline_pct").read(ctx(ev))
    assert roofline == pytest.approx(100 * 267251200 / 3.35e12 / 10e-6)
    assert reader("deform_attn_roofline_pct").read(ctx(ev)) is None
    u = {"steps": 10, "seconds": 2.0, "host_ms": [1.0, 3.0]}
    assert reader("mfu").read(ctx(ev, u)) == pytest.approx(
        100 * 80e9 * 10 / 2.0 / 989e12)
    assert reader("host_ms").read(ctx(ev, u)) == 2.0
    assert reader("host_ms").read(ctx(ev)) is None


def test_a_stretch_without_device_work_reads_nothing():
    ev = [op(trace.WINDOW, 0, 100, 1)]
    assert reader("device_idle_pct").read(ctx(ev)) is None
    assert reader("backbone_ms").read(ctx(ev)) is None
