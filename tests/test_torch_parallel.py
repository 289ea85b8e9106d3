"""Data parallelism of the PyTorch port on the CPU: two real processes in a
gloo group (``tpudet_torch.parallel``) against one process on the joined
batch, the port's twin of ``tests/test_multiprocess.py``.

The workers (``tests/_torch_dp_worker.py``) each get a hard timeout
(``TIMEOUT``), so a hung collective fails the test instead of stalling
the suite. They check:

* the loader: both ranks plan the same global batches, buckets included,
  and load disjoint rows whose union is the one-process loader's batch;
* with one and with two accumulated microbatches, each rank's
  microbatch is its share of the global microbatch;
* one ``tiny`` Faster R-CNN step at global b=4, one
  ``deformable_detr_tiny`` step (dropout 0: the set loss divides by the
  group's positive count) and one ``detr_tiny`` step (its CE also by the
  group's sum of class weights), each also in two accumulated
  microbatches: the
  loss, every gradient and every updated
  parameter equal the one-process step on the joined batch within
  ``1e-6`` relative (the mean of two half-batch gradients against one
  full-batch gradient: f32 summation order; relative to each tensor's
  largest magnitude, floored at ``1e-6`` of the model's largest for the
  ones that are zero in exact arithmetic, such as a conv bias before a
  GroupNorm);
* checkpoints: rank 0 saves, then both ranks restore into a state drawn
  from another seed, to the same step and parameter fingerprint;
* the train CLI under torchrun's environment: two gloo processes of
  ``python -m tpudet_torch.cli.train --device cpu`` train ``tiny`` as one
  process does at the same global batch, rank 0 alone writes; a global
  batch the world size does not divide is refused.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import _torch_dp_worker as worker
from tpudet_torch.cli import train as ttrain
from tpudet_torch.config import apply_overrides
from tpudet_torch.data import DataLoader
from tpudet_torch.train.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # seconds for each spawned process
torch.set_num_threads(2)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argvs, envs=None):
    """Run one process per argv, each with ``TIMEOUT``; a process still
    running then is killed and fails the test with everyone's output."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=dict(env, **(envs[i] if envs else {})))
             for i, argv in enumerate(argvs)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n[killed at the timeout]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    blob = "\n".join(f"--- process {i} (rc {p.returncode}) ---\n{o}"
                     for i, (p, o) in enumerate(zip(procs, outs)))
    assert all(p.returncode == 0 for p in procs), blob
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    init = f"tcp://127.0.0.1:{free_port()}"
    spawn([[sys.executable, os.path.join(ROOT, "tests", "_torch_dp_worker.py"),
            "--rank", str(r), "--world", "2", "--init", init,
            "--out", str(out)] for r in range(2)])
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def test_loader_ranks_share_the_plan_and_split_its_rows(ranks):
    one = DataLoader(worker.loader_config(), worker.SizedDataset(),
                     worker.GLOBAL_BATCH, seed=3, num_workers=1,
                     drop_last=False)
    joined = list(one.batches(1))
    a, b = (r["loader"] for r in ranks)
    assert len(a) == len(b) == len(joined) >= 4
    canvases = set()
    for ra, rb, full in zip(a, b, joined):
        assert ra["canvas"] == rb["canvas"] == list(full["image"].shape[1:3])
        canvases.add(tuple(ra["canvas"]))
        if "batch_valid" not in full:  # a padded tail repeats its last
            assert not set(ra["index"]) & set(rb["index"])
        np.testing.assert_array_equal(ra["index"], full["example_index"][0::2])
        np.testing.assert_array_equal(rb["index"], full["example_index"][1::2])
        valid = full.get("batch_valid", np.ones(4, bool))
        np.testing.assert_array_equal(ra["valid"], valid[0::2])
        np.testing.assert_array_equal(rb["valid"], valid[1::2])
        np.testing.assert_array_equal(ra["gt_boxes"], full["gt_boxes"][0::2])
        np.testing.assert_array_equal(rb["gt_boxes"], full["gt_boxes"][1::2])
    assert canvases == {(64, 96), (96, 64)}
    # A bucket's padded tail: its valid rows split over the ranks too.
    tails = [i for i, full in enumerate(joined) if "batch_valid" in full]
    assert tails and all(not all(a[i]["valid"]) or not all(b[i]["valid"])
                         for i in tails)


@pytest.mark.parametrize("accum", [1, 2])
def test_each_ranks_microbatch_is_its_share_of_the_global_one(accum):
    cfg = apply_overrides(worker.loader_config(),
                          {"train.accum_steps": accum})

    def batches(**kw):
        return list(DataLoader(cfg, worker.SizedDataset(), worker.GLOBAL_BATCH,
                               seed=3, num_workers=1, drop_last=False,
                               **kw).batches(1))

    joined = batches()
    ranks = [batches(process_index=r, process_count=2) for r in range(2)]
    assert len(ranks[0]) == len(ranks[1]) == len(joined) >= 4
    for i, full in enumerate(joined):
        valid = full.get("batch_valid", np.ones(worker.GLOBAL_BATCH, bool))
        for r, rank in enumerate(ranks):
            got_valid = rank[i].get("batch_valid", np.ones(2, bool))
            for a in range(accum):
                np.testing.assert_array_equal(
                    rank[i]["example_index"][a::accum],
                    full["example_index"][a::accum][r::2])
                np.testing.assert_array_equal(got_valid[a::accum],
                                              valid[a::accum][r::2])
    with pytest.raises(ValueError, match="not divisible by train.accum_steps"):
        DataLoader(apply_overrides(cfg, {"train.accum_steps": 4}),
                   worker.SizedDataset(), worker.GLOBAL_BATCH,
                   process_index=0, process_count=2)


@pytest.mark.parametrize("name", ["faster_rcnn", "deformable_detr",
                                  "faster_rcnn_accum2",
                                  "deformable_detr_accum2", "detr",
                                  "detr_accum2"])
def test_two_process_step_equals_one_process_step(ranks, name):
    cfg = worker.step_configs()[name]
    _, ref = worker.train_one(cfg, worker.global_batch(cfg, seed=5))
    for r in ranks:
        got = r[name]
        assert set(got["metrics"]) == set(ref["metrics"])
        for k, v in ref["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-6), k
        assert set(got["grads"]) == set(ref["grads"])
        floor = 1e-6 * max(float(g.abs().max()) for g in ref["grads"].values())
        for k, g in ref["grads"].items():
            torch.testing.assert_close(
                got["grads"][k], g, rtol=0,
                atol=1e-6 * float(g.abs().max()) + floor, msg=k)
        # The parameters after the update, relative to each tensor's
        # largest, floored at 1e-6 of the model's largest (the biases that
        # start at zero and take noise gradients).
        floor = 1e-6 * max(float(p.abs().max())
                           for p in ref["params"].values())
        for k, p in ref["params"].items():
            torch.testing.assert_close(
                got["params"][k], p, rtol=0,
                atol=1e-6 * float(p.abs().max()) + floor, msg=k)
    # Both ranks hold the same parameters after the update, bit for bit.
    for k in ref["params"]:
        assert torch.equal(ranks[0][name]["params"][k],
                           ranks[1][name]["params"][k]), k
    if "detr" in name:
        assert ref["metrics"]["num_gt"] > 0


def test_rank0_saves_and_every_rank_restores(ranks):
    for r in ranks:
        assert r["restored_step"] == 1
        assert r["restored_fingerprint"] == pytest.approx(
            ranks[0]["saved_fingerprint"], rel=1e-12)


CLI = ["-m", "tpudet_torch.cli.train", "--preset", "tiny", "--dataset",
       "synthetic", "--steps", "2", "--batch-size", "4", "--device", "cpu",
       "--set", "train.log_every=1"]


def test_train_cli_under_torchrun_env_equals_one_process(tmp_path):
    port = free_port()
    envs = [{"RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
            for r in range(2)]
    dp_dir, one_dir = tmp_path / "dp", tmp_path / "one"
    outs = spawn([[sys.executable] + CLI + [
        "--checkpoint-dir", str(dp_dir / "ckpt"),
        "--logdir", str(dp_dir / f"logs{r}")] for r in range(2)], envs)
    assert "rank 0 of 2" in outs[0] and "rank 1 of 2" in outs[1]
    assert "[train step 2]" in outs[0] and "[train step" not in outs[1]
    assert os.listdir(dp_dir / "logs0") and not (dp_dir / "logs1").exists()
    ttrain.main(CLI[2:] + ["--checkpoint-dir", str(one_dir / "ckpt")])
    grouped = CheckpointManager(str(dp_dir / "ckpt"))._load(None)
    alone = CheckpointManager(str(one_dir / "ckpt"))._load(None)
    assert grouped["step"] == alone["step"] == 2
    # Two SGD steps from the same seed-0 weights: the parameters within
    # 1e-6 of the model's largest magnitude (the updates are ~1e-4 of it).
    scale = max(float(v.abs().max()) for v in alone["model"].values())
    for k, v in alone["model"].items():
        torch.testing.assert_close(grouped["model"][k], v, rtol=0,
                                   atol=1e-6 * scale, msg=k)
    with open(dp_dir / "ckpt" / "config.json") as f:
        assert json.load(f)["train"]["batch_size"] == 4


def test_train_cli_refuses_a_batch_the_world_size_does_not_divide(
        monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="not divisible by the data-parallel"):
        ttrain.main(CLI[2:] + ["--batch-size", "3"])
