"""``correct`` comes out false when the timed path is broken, and the
control (the reference one step below the configuration's precision, bf16
to fp8 and f32 to bf16) reads past the program.

The CPU tests drive the rest of a run with the look for a card skipped, at
sizes a test can hold. The ``cuda`` test reads the control at each cell's
own size on the card, on three seeds: it has to fail the cell's limits
there, where the program passes them."""

import json

import pytest
import torch

from detbench import harness
from detbench.control import readings
from detbench.faults import half_batch, moved_answer, unchanged_state
from detbench.tests.tiny import REPO, tiny_root

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
TRAIN = [w["name"] for w in SPEC["workloads"] if json.loads(
    (REPO / "detbench" / "traffic" / f"{w['traffic']}.json").read_text()
)["mode"] == "train"]
INFER = [c for c in CELLS if c not in TRAIN]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell,fault", [(c, moved_answer) for c in INFER]
                         + [(c, f) for c in TRAIN
                            for f in (unchanged_state, half_batch)])
def test_a_broken_timed_path_is_not_correct(root, cell, fault):
    bench = harness.Bench(root).cell(cell)
    device = torch.device("cpu")
    ok = harness.run(bench, 11, 1.0, False, device, 0.0)
    bad = harness.run(bench, 11, 1.0, False, device, 0.0,
                      program_hook=fault)
    assert ok["correct"] is True
    assert bad["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_past_the_program(root, cell):
    bench = harness.Bench(root).cell(cell)
    got = readings(bench, 12, 0.5, True, torch.device("cpu"))
    assert any(got["control"][k] > 3 * got["program"][k] + 1e-4
               for k in bench.limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control is read at the cell's "
                    "own size")
    bench = harness.Bench(REPO).cell(cell)
    for seed in (101, 202, 303):
        got = readings(bench, seed, 3.0, True, torch.device("cuda"))
        assert all(v <= bench.limits[k] for k, v in got["program"].items()
                   if k in bench.limits)
        assert any(v > bench.limits[k] for k, v in got["control"].items()
                   if k in bench.limits)
