"""The port's benchmark CLI (``tpudet_torch.cli.benchmark``) on the CPU:
each of the five modes on the tiny preset at tiny sizes with ``--device
cpu``, each line with the JAX package's fields (read from the source of
``tpudet/cli/benchmark.py``) less ``vs_baseline``, plus ``device``; the
benchmark batch and the host mode's JPEGs equal the JAX package's; the
trace; the timing helpers. No run writes ``BENCH_PROVENANCE.jsonl``."""

import ast
import io
import json
import math
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

from tpudet import config as jconfig
from tpudet.cli import benchmark as jbench
from tpudet_torch import config as tconfig
from tpudet_torch.cli import benchmark as bench
from tpudet_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROVENANCE = ROOT / "BENCH_PROVENANCE.jsonl"
TINY = ["--preset", "tiny", "--device", "cpu", "--batch-size", "2",
        "--iters", "2"]
MODES = {"infer": "bench_infer", "infer_stream": "bench_infer_stream",
         "train": "bench_train", "nms": "bench_nms", "host": "bench_host"}


def jax_fields(function: str) -> set:
    """The string keys that ``tpudet/cli/benchmark.py``'s ``function``
    puts in its result: dict literals' keys and ``result[...] =``
    targets."""
    tree = ast.parse(pathlib.Path(jbench.__file__).read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == function)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant) and isinstance(k.value, str)}
        elif (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
              and isinstance(node.slice, ast.Constant)
              and isinstance(node.slice.value, str)):
            keys.add(node.slice.value)
    return keys


def rates(line: dict) -> list:
    return [v for k, v in line.items()
            if k == "value" or k.endswith("per_sec")]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_line_has_jax_fields(mode, capsys):
    before = PROVENANCE.read_bytes()
    if mode == "nms":
        # The CLI's 6,000 boxes take ~0.3 s a call in the plain NMS here.
        line = bench.bench_nms(tconfig.tiny_test_config(), 2,
                               torch.device("cpu"), bench.Timer(),
                               num_boxes=64)
    else:
        line = bench.main(TINY + ["--mode", mode])
        assert json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]) == line
    want = jax_fields(MODES[mode]) | {"device"}
    assert "vs_baseline" not in line and "vs_baseline" not in want
    if mode == "nms":
        # The JAX package's "pallas" flag is the route that ran here, and
        # the line says which clock timed it.
        want = (want - {"pallas"}) | {"route", "clock"}
        assert line["route"] == "plain" and line["clock"] == "host"
    assert set(line) == want
    assert line["device"] == "cpu"
    assert all(isinstance(v, float) and math.isfinite(v) and v > 0
               for v in rates(line) if v is not None), line
    assert PROVENANCE.read_bytes() == before


def test_host_mode_rates():
    line = bench.main(TINY + ["--mode", "host"])
    assert line["value"] == line["native_batch_images_per_sec"] > 0
    assert line["pil_images_per_sec"] > 0
    assert line["canvas"] == [128, 128]


def test_host_mode_without_the_native_library_times_pil(monkeypatch):
    """Without g++ or libjpeg the line has PIL's rate alone, as the JAX
    package's has."""
    import tpudet_torch.native

    monkeypatch.setattr(tpudet_torch.native, "native_available",
                        lambda: False)
    line = bench.bench_host(tconfig.tiny_test_config(), torch.device("cpu"),
                            num_images=4)
    assert not any(k.startswith("native") for k in line)
    assert line["value"] == line["pil_images_per_sec"] > 0


def test_make_batch_equals_jax():
    port = bench._make_batch(tconfig.tiny_test_config(), 4, "cpu")
    ref = jbench._make_batch(jconfig.tiny_test_config(), 4)
    assert set(port) == set(ref)
    for k in ref:
        assert port[k].device.type == "cpu"
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


def test_host_jpegs_are_the_jax_recipe():
    """The JAX package's recipe with PIL: a bilinear upscale of noise saved
    at quality 90."""
    rng = np.random.default_rng(0)
    jpegs = bench.host_jpegs(3)
    for data in jpegs:
        h, w = int(rng.integers(350, 500)), int(rng.integers(450, 640))
        small = rng.integers(0, 255, (h // 8, w // 8, 3), np.uint8)
        img = np.asarray(Image.fromarray(small).resize((w, h), Image.BILINEAR))
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=90)
        assert data == buf.getvalue()


def test_trace_dir_writes_a_chrome_trace(tmp_path):
    bench.main(TINY + ["--mode", "infer", "--trace-dir", str(tmp_path)])
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    # The measured span's predict ran under the profiler.
    assert any(str(e.get("name", "")).startswith("aten::conv")
               for e in events)


def test_cuda_device_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main(["--preset", "tiny", "--mode", "infer"])


def test_profiling_helpers():
    calls = []

    def fn():
        calls.append(1)
        return {"a": [torch.ones(3)], "b": 2}

    assert profiling.device_timeit(fn, iters=5, warmup=2) > 0
    assert len(calls) == 7
    assert torch.equal(profiling.first_tensor(fn()), torch.ones(3))
    assert profiling.first_tensor({"x": (1, "y")}) is None
    profiling.sync({"x": 1})  # nothing to wait for
