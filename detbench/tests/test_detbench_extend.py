"""A configuration, a traffic mix and a per-layer metric are added with new
files and new entries in ``BENCHMARK.json`` only: a throwaway set of them
in a directory of its own runs through the harness unedited."""

import json
import shutil

from detbench.tests.tiny import REPO, dry_run, tiny_root

READER = '''
def read(ctx):
    """Batches of the window outside the traced stretch."""
    return float(ctx.untraced["steps"])
'''


def test_new_files_only(tmp_path):
    root = tiny_root(tmp_path)
    extra = root / "extra"
    for sub in ("configs", "traffic", "metrics", "limits"):
        (extra / sub).mkdir(parents=True)
    config = json.loads((REPO / "detbench/configs/voc_r50.json").read_text())
    config["name"] = "voc_r50_wide_heads"
    config["draws"]["det_head.cls.weight"] = ["normal", 0.0, 0.2]
    (extra / "configs" / "voc_r50_wide_heads.json").write_text(
        json.dumps(config))
    (extra / "traffic" / "one_wide.json").write_text(json.dumps(
        {"mode": "infer", "batch": 1, "canvas": [96, 192], "pool": 2,
         "in_flight": 1, "valid_frac": [0.9, 1.0], "check_batches": 1,
         "trace_seconds": 0.5}))
    (extra / "metrics" / "window_batches.py").write_text(READER)
    cell = "voc_r50_wide_heads.one_wide"
    shutil.copy(root / "detbench/limits/voc_r50.infer_b32.json",
                extra / "limits" / f"{cell}.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["paths"].append("extra")
    spec["configs"].append({"name": "voc_r50_wide_heads", "source": "x",
                            "file": "extra/configs/voc_r50_wide_heads.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": cell, "config": "voc_r50_wide_heads",
                              "traffic": "one_wide", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"][1]["workloads"].append(cell)
    spec["per_layer"].append({"name": "window_batches", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "a test", "moves": "infer_img_per_s",
                              "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    before = {p: p.read_bytes() for p in (root / "detbench").rglob("*")
              if p.is_file()}
    result, err = dry_run(root, cell, trace=1)
    assert result["correct"] is True, err[-2000:]
    assert result["metrics"]["window_batches"]["value"] >= 1
    result, _ = dry_run(root, cell)
    assert set(result["metrics"]) == {"setup_s", "infer_img_per_s"}
    assert before == {p: p.read_bytes() for p in (root / "detbench").rglob(
        "*") if p.is_file() and "__pycache__" not in p.parts}
