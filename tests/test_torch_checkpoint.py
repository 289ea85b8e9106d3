"""The port's checkpoints (``tpudet_torch/train/checkpoint.py``) on the CPU:
keep-k and atomic saves; a run restored after two steps and taken one more
equals three straight steps bit for bit; ``restore_eval`` with and without
an EMA; ``restore_params`` leaves the optimizer and step fresh."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tpudet_torch.config import tiny_test_config
from tpudet_torch.models import build_model
from tpudet_torch.train.checkpoint import CheckpointManager
from tpudet_torch.train.state import create_train_state
from tpudet_torch.train.step import make_train_step

torch.set_num_threads(2)


def batches(cfg, n, seed=0):
    """``n`` uint8 batches of 2 canvases with planted boxes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt = np.zeros((2, cfg.data.max_gt_boxes, 4), np.float32)
        gt[:, :2] = [[10, 12, 60, 70], [40, 30, 110, 90]]
        gt[1, :2] += rng.uniform(-8, 8, (2, 4)).astype(np.float32)
        valid = np.zeros((2, cfg.data.max_gt_boxes), bool)
        valid[:, :2] = True
        out.append({
            "image": torch.from_numpy(rng.integers(0, 256, (2, 128, 128, 3),
                                                   dtype=np.uint8)),
            "image_hw": torch.tensor([[128.0, 128.0], [112.0, 120.0]]),
            "gt_boxes": torch.from_numpy(gt),
            "gt_classes": torch.from_numpy(
                rng.integers(1, 4, valid.shape).astype(np.int32)),
            "gt_valid": torch.from_numpy(valid)})
    return out


def config(**train):
    cfg = tiny_test_config()
    return cfg.replace(train=dataclasses.replace(
        cfg.train, warmup_steps=0, learning_rate=0.02, **train))


def fresh(cfg):
    model = build_model(cfg, device="cpu")
    state = create_train_state(model, cfg.train, seed=0, device="cpu")
    return state, make_train_step(model, cfg, device="cpu",
                                  fused_preprocess=True)


def params(state):
    return {k: v.detach().clone()
            for k, v in state.model.state_dict().items()}


def test_keep_k_and_atomic_saves(tmp_path):
    cfg = config()
    state, _ = fresh(cfg)
    mgr = CheckpointManager(str(tmp_path), keep=2, config=cfg)
    assert mgr.latest_step is None
    for step in range(1, 6):
        state.step = step
        assert mgr.save(state)
    assert not mgr.save(state, force=True)  # step 5 is saved already
    assert mgr.latest_step == 5
    assert sorted(os.listdir(tmp_path)) == ["4", "5"]
    blob = torch.load(tmp_path / "5" / "state.pt", weights_only=True)
    assert blob["step"] == 5
    assert blob["config"]["data"]["dataset"] == "synthetic"


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_resume_equals_straight_run_bitwise(tmp_path, optimizer):
    cfg = config(optimizer=optimizer, ema_decay=0.9)
    data = batches(cfg, 3)
    torch.use_deterministic_algorithms(True)
    try:
        state, step = fresh(cfg)
        for batch in data:
            state, _ = step(state, batch)
        straight = params(state)
        straight_ema = {k: v.clone() for k, v in state.ema_params.items()}

        state, step = fresh(cfg)
        for batch in data[:2]:
            state, _ = step(state, batch)
        CheckpointManager(str(tmp_path), keep=1).save(state)
        # A new process: new model, optimizer and state, restored.
        state, step = fresh(cfg)
        state = CheckpointManager(str(tmp_path), keep=1).restore(state)
        assert state.step == 2
        state, _ = step(state, data[2])
    finally:
        torch.use_deterministic_algorithms(False)
    assert state.step == 3
    for k, v in params(state).items():
        assert torch.equal(v, straight[k]), k
    for k, v in state.ema_params.items():
        assert torch.equal(v, straight_ema[k]), k


def test_restore_eval_and_ema_reconciliation(tmp_path):
    cfg_ema = config(ema_decay=0.9)
    state, step = fresh(cfg_ema)
    for batch in batches(cfg_ema, 2):
        state, _ = step(state, batch)
    saved, saved_ema = params(state), dict(state.ema_params)
    CheckpointManager(str(tmp_path / "ema")).save(state)

    # Evaluation under another optimizer config and no EMA: the model, the
    # EMA and the step come back; the optimizer is left alone.
    other = config(optimizer="adamw")
    state2, _ = fresh(other)
    state2 = CheckpointManager(str(tmp_path / "ema")).restore_eval(state2)
    assert state2.step == 2 and not state2.optimizer.state
    for k, v in params(state2).items():
        assert torch.equal(v, saved[k]), k
    for k, v in state2.ema_params.items():
        assert torch.equal(v, saved_ema[k]), k
    model = state2.eval_model(use_ema=True)
    for k, p in model.core.named_parameters():
        assert torch.equal(p, saved_ema[k]), k

    # A checkpoint without an EMA restored into a state that keeps one:
    # the EMA restarts from the restored parameters.
    plain = config()
    state3, step3 = fresh(plain)
    state3, _ = step3(state3, batches(plain, 1)[0])
    CheckpointManager(str(tmp_path / "plain")).save(state3)
    state4, _ = fresh(cfg_ema)
    state4 = CheckpointManager(str(tmp_path / "plain")).restore(state4)
    for k, p in state4.model.core.named_parameters():
        assert torch.equal(state4.ema_params[k], p), k
    state5, _ = fresh(plain)
    state5 = CheckpointManager(str(tmp_path / "plain")).restore_eval(state5)
    assert state5.ema_params is None
    with pytest.raises(ValueError, match="no EMA"):
        state5.eval_model(use_ema=True)


def test_restore_params_keeps_optimizer_fresh(tmp_path):
    cfg = config()
    state, step = fresh(cfg)
    for batch in batches(cfg, 2):
        state, _ = step(state, batch)
    saved = params(state)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state)
    warm, _ = fresh(config(ema_decay=0.5))
    warm = mgr.restore_params(warm)
    assert warm.step == 0 and not warm.optimizer.state
    for k, v in params(warm).items():
        assert torch.equal(v, saved[k]), k
    for k, p in warm.model.core.named_parameters():
        assert torch.equal(warm.ema_params[k], p), k
    with pytest.raises(ValueError, match="no checkpoint"):
        CheckpointManager(str(tmp_path / "empty")).restore_params(warm)
    # restore with nothing saved leaves the state as it is.
    untouched, _ = fresh(cfg)
    assert CheckpointManager(str(tmp_path / "none")).restore(untouched) \
        is untouched and untouched.step == 0
