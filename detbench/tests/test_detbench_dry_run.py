"""The contract's last line from a CPU dry run of each cell at sizes a test
can hold, with no JAX module loaded; and no result without a card."""

import json
import subprocess
import sys

import pytest

from detbench.tests.tiny import REPO, dry_run, tiny_root

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
TRAIN_CELLS = [w["name"] for w in SPEC["workloads"] if json.loads(
    (REPO / "detbench" / "traffic" / f"{w['traffic']}.json").read_text()
)["mode"] == "train"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("dry"))


def cell_metrics(name, kind):
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    return {m["name"] for m in spec[kind] if name in m.get("workloads",
                                                           [name])}


@pytest.mark.parametrize("cell", CELLS)
def test_last_line(root, cell):
    result, err = dry_run(root, cell)
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(
        result)
    assert result["correct"] is True, err[-2000:]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == cell_metrics(cell, "end_to_end")
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["device"]["platform"] == "cpu"
    for name, check in result["checks"].items():
        assert check["value"] <= check["limit"]
        assert f"check {name}: " in err
    assert "forbidden []" in err


def test_traced_line(root):
    result, err = dry_run(root, CELLS[0], trace=1)
    assert set(result["metrics"]) <= cell_metrics(CELLS[0], "per_layer")
    assert "host_ms.infer" in result["metrics"]  # the CPU has no device
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_training_line(root, cell):
    result, err = dry_run(root, cell, seconds=3.0)
    assert result["correct"] is True, err[-2000:]
    assert set(result["metrics"]) == {"setup_s", "train_img_per_s"}
    limits = json.loads((REPO / "detbench" / "limits" / f"{cell}.json"
                         ).read_text())["limits"]
    assert set(result["checks"]) == set(limits)
    assert {"first_logits_gap", "first_boxes_gap"} <= set(limits)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: the command would measure it")
    proc = subprocess.run(
        [sys.executable, str(REPO / "detbench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
