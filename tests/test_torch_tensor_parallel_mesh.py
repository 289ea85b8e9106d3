"""The port's ``__graft_entry__.dryrun_multichip`` counterpart on the CPU:
a dp=2 x tp=2 gloo mesh of four processes (``tests/_torch_tp_worker.py``),
and the train CLI under torchrun's environment with
``--set train.num_model_shards=2``.

* One tiny Faster R-CNN step with two accumulated microbatches and the EMA
  on equals the one-process step on the joined batch: the metrics, each
  rank's gradient, parameter, EMA and momentum shards (the optimizer state
  is sharded like its parameter);
* the checkpoint the mesh saves holds whole tensors; it restores into the
  same layout, into dp=4 x tp=1 and into one process with equal
  parameters, and one more step on the mesh and in the one process equals
  the one-process second step;
* two processes of ``python -m tpudet_torch.cli.train --device cpu`` with a
  model axis of 2 train ``tiny`` as one process does at the same global
  batch, and a global batch that the data axis does not divide is refused.
"""

import os
import sys

import pytest
import torch

from tests import _torch_tp_worker as worker
from tests._torch_tp_check import (
    assert_shards_equal,
    assert_shards_match_tpudet,
    assert_step_matches_tpudet,
    f32_rounding,
    groupnorm_in_f64,
    run_mesh,
    tpudet_steps,
)
from tests.test_torch_parallel import CLI, free_port, spawn
from tpudet_torch.cli import train as ttrain
from tpudet_torch.models import build_model
from tpudet_torch.train.checkpoint import CheckpointManager
from tpudet_torch.train.state import create_train_state

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tpudet():
    """tpudet's two steps on its dp=2 x tp=2 mesh -> (the port's start,
    [step 1, step 2])."""
    return tpudet_steps("mesh", 2, 2, steps=2)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory, tpudet):
    out = tmp_path_factory.mktemp("mesh")
    ranks = run_mesh(out, 4, 2, "mesh", start={"mesh": tpudet[0]})
    restore = tmp_path_factory.mktemp("restore")
    flat = run_mesh(restore, 4, 1, "restore", ckpt=out / "ckpt")
    return out, ranks, flat


def one_process_steps(start):
    """The one-process steps 1 and 2 from ``start``."""
    cfg = worker.mesh_config()
    state, first = worker.step_once(cfg, None, init=start)
    _, second = worker.step_once(cfg, None, state, init=start, index=1)
    return first, second


@pytest.fixture(scope="module")
def reference(tpudet):
    """The one-process steps 1 and 2 from tpudet's start, and the same
    steps with GroupNorm in float64."""
    plain = one_process_steps(tpudet[0])
    with groupnorm_in_f64():
        wide = one_process_steps(tpudet[0])
    return plain + wide


def test_mesh_places_the_ranks_as_make_mesh(mesh):
    _, ranks, _ = mesh
    assert [(r["rank"], r["model_rank"]) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]


def test_dp2_tp2_step_with_accumulation_and_ema_equals_one_process(
        mesh, reference):
    _, ranks, _ = mesh
    ref = reference[0]
    for r in ranks:
        got, layout = r["step1"], r["layout"]
        for k, v in ref["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-6), k
        for key in ("grads", "params", "ema"):
            assert_shards_equal(got[key], ref[key], layout, r["model_rank"],
                                2, key)
    # SGD's momentum, per parameter index, sharded like its parameter.
    for r in ranks:
        mom = {k: e["momentum_buffer"]
               for k, e in r["step1"]["optimizer"].items()}
        want = {k: e["momentum_buffer"] for k, e in ref["optimizer"].items()}
        assert_shards_equal(mom, want, r["layout"], r["model_rank"], 2,
                            "momentum")


def tpudet_start(mesh):
    """The start the mesh's workers took (tpudet's weights and draws)."""
    return torch.load(mesh[0] / "start.pt")["mesh"]


def test_sharded_checkpoint_restores_into_every_layout(mesh, reference):
    out, ranks, flat = mesh
    blob = CheckpointManager(str(out / "ckpt"))._load(None)
    assert blob["step"] == 1
    whole = {k[len("core."):]: v for k, v in blob["model"].items()}
    # The saved tensors are the whole ones: each rank's shards are blocks
    # of them, bit for bit.
    for r in ranks:
        for k, p in r["step1"]["params"].items():
            step = p.shape[r["layout"][k].dim or 0]
            dim = r["layout"][k].dim
            want = (whole[k] if dim is None else
                    whole[k].narrow(dim, r["model_rank"] * step, step))
            assert torch.equal(p, want), k
            assert torch.equal(r["restored"][k], p), k
            assert torch.equal(r["restored_ema"][k], r["step1"]["ema"][k]), k
    for r in flat:  # dp=4 x tp=1: the whole tensors
        assert r["model_size"] == 1 and r["restored_step"] == 1
        for k, p in r["restored"].items():
            assert torch.equal(p, whole[k]), k
    cfg = worker.mesh_config()
    one = CheckpointManager(str(out / "ckpt")).restore(create_train_state(
        build_model(cfg, device="cpu"), cfg.train, seed=7, device="cpu"))
    assert one.step == 1
    for k, p in one.params.items():
        assert torch.equal(p.detach(), whole[k]), k
    # One more step on the mesh and in the one process.
    ref = reference[1]
    _, again = worker.step_once(cfg, None, one, init=tpudet_start(mesh),
                                index=1)
    for r in ranks:
        for k, v in ref["metrics"].items():
            assert r["step2"]["metrics"][k] == pytest.approx(v, rel=1e-5), k
        assert_shards_equal(r["step2"]["params"], ref["params"], r["layout"],
                            r["model_rank"], 2, "step 2")
    replicated = {k: type(sh)("replicated")
                  for k, sh in ranks[0]["layout"].items()}
    assert_shards_equal(again["params"], ref["params"], replicated, 0, 1,
                        "one process, step 2")


def test_mesh_steps_and_restore_equal_tpudet_sharded_steps(mesh, reference,
                                                           tpudet):
    _, ranks, _ = mesh
    start, (first, second) = tpudet
    slack = [f32_rounding(plain, wide) for plain, wide in
             zip(reference[:2], reference[2:])]
    # The one-process steps with GroupNorm in float64 equal tpudet's.
    replicated = {k: type(sh)("replicated")
                  for k, sh in ranks[0]["layout"].items()}
    for i, (want, before) in enumerate(((first, start["weights"]),
                                        (second, first["params"]))):
        assert_step_matches_tpudet(reference[2 + i], want, before,
                                   replicated, 0, 1,
                                   f"one process step {i + 1}, GroupNorm "
                                   f"in f64")
    for r in ranks:
        layout, rank = r["layout"], r["model_rank"]
        label = f"rank {r['global_rank']}"
        assert_step_matches_tpudet(r["step1"], first, start["weights"],
                                   layout, rank, 2, f"{label} step 1",
                                   slack[0])
        for what, got in (("ema", r["step1"]["ema"]),
                          ("ema", r["restored_ema"]),
                          ("params", r["restored"])):
            assert_shards_match_tpudet(got, first[what], layout, rank, 2,
                                       f"{label} restored {what}",
                                       start["weights"], slack[0]["params"])
        momentum = {k: e["momentum_buffer"]
                    for k, e in r["restored_optimizer"].items()}
        assert_shards_match_tpudet(momentum, first["momentum"], layout, rank,
                                   2, f"{label} restored momentum",
                                   slack=slack[0]["momentum"])
        assert_step_matches_tpudet(r["step2"], second, first["params"],
                                   layout, rank, 2, f"{label} step 2",
                                   slack[1])


def test_train_cli_with_a_model_axis_equals_one_process(tmp_path):
    port = free_port()
    envs = [{"RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": "2",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
            for r in range(2)]
    tp_dir, one_dir = tmp_path / "tp", tmp_path / "one"
    outs = spawn([[sys.executable] + CLI + [
        "--set", "train.num_model_shards=2",
        "--checkpoint-dir", str(tp_dir / "ckpt"),
        "--logdir", str(tp_dir / f"logs{r}")] for r in range(2)], envs)
    assert "data rank 0 of 1, model rank 0 of 2" in outs[0]
    assert "data rank 0 of 1, model rank 1 of 2" in outs[1]
    assert "[train step 2]" in outs[0] and "[train step" not in outs[1]
    assert os.listdir(tp_dir / "logs0") and not (tp_dir / "logs1").exists()
    ttrain.main(CLI[2:] + ["--checkpoint-dir", str(one_dir / "ckpt")])
    grouped = CheckpointManager(str(tp_dir / "ckpt"))._load(None)
    alone = CheckpointManager(str(one_dir / "ckpt"))._load(None)
    assert grouped["step"] == alone["step"] == 2
    scale = max(float(v.abs().max()) for v in alone["model"].values())
    for k, v in alone["model"].items():
        assert grouped["model"][k].shape == v.shape, k
        torch.testing.assert_close(grouped["model"][k], v, rtol=0,
                                   atol=1e-6 * scale, msg=k)


@pytest.mark.parametrize("world,shards,batch", [(4, 2, 3), (3, 2, 4)])
def test_train_cli_refuses_a_mesh_the_world_or_batch_does_not_fit(
        monkeypatch, world, shards, batch):
    monkeypatch.setenv("WORLD_SIZE", str(world))
    match = ("not divisible by the data-parallel world size 2"
             if world == 4 else "does not divide the world size 3")
    with pytest.raises(ValueError, match=match):
        ttrain.main(CLI[2:] + ["--batch-size", str(batch), "--set",
                               f"train.num_model_shards={shards}"])
