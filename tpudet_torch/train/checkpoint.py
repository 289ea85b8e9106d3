"""Checkpoints (``tpudet.train.checkpoint``): save every N steps, keep the
last k, restore on start, warm-start the parameters alone.

One directory per step under ``directory``, named by the step, holding
``state.pt``: ``torch.save`` of the model's state dict (parameters and the
frozen constants, as CPU tensors), the optimizer's state dict, the step,
the EMA parameters (or None) and the config as a dict. A save writes a
temporary directory and renames it, so a run killed mid-save leaves no
half checkpoint. The JAX package's checkpoints are orbax trees; the two
formats do not read each other.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Dict, List, Optional

import torch

from tpudet_torch.train.state import TrainState

_FILE = "state.pt"


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, config=None):
        """``keep``: how many of the newest checkpoints stay; ``config``
        (a ``Config``) is stored in each checkpoint when given."""
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.config = config
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isfile(os.path.join(self.directory, n, _FILE)))

    @property
    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, force: bool = False) -> bool:
        """Save ``state`` under its step; False when that step is saved
        already (the end-of-training save landing on an every-N save).
        ``force`` is kept for the JAX signature: every call saves."""
        del force
        step = int(state.step)
        if step == self.latest_step:
            return False
        blob = {
            "step": step,
            "model": _cpu(state.model.state_dict()),
            "optimizer": state.optimizer.state_dict(),
            "ema_params": (None if state.ema_params is None
                           else _cpu(state.ema_params)),
            "config": (None if self.config is None
                       else dataclasses.asdict(self.config)),
        }
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(blob, os.path.join(tmp, _FILE))
        final = os.path.join(self.directory, str(step))
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        for old in self._steps()[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def _load(self, step: Optional[int]):
        if step is None:
            step = self.latest_step
        if step is None:
            return None
        return torch.load(os.path.join(self.directory, str(step), _FILE),
                          map_location="cpu", weights_only=True)

    @staticmethod
    def _ema_like(state: TrainState, source: Optional[Dict[str, torch.Tensor]]):
        """The EMA as tensors on the model's device: ``source`` copied, or
        (None) a copy of the model's parameters."""
        if source is None:
            return {name: p.detach().clone()
                    for name, p in state.model.core.named_parameters()}
        return {k: v.to(state.model.device) for k, v in source.items()}

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> TrainState:
        """Resume: the model, the optimizer's state, the step and the EMA
        from the checkpoint at ``step`` (the latest by default); ``state``
        unchanged when there is none. A checkpoint with an EMA fills a state
        without one; a state that expects an EMA the checkpoint lacks
        restarts it from the restored parameters."""
        blob = self._load(step)
        if blob is None:
            return state
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        state.step = int(blob["step"])
        if blob["ema_params"] is not None:
            state.ema_params = self._ema_like(state, blob["ema_params"])
        elif state.ema_params is not None:
            state.ema_params = self._ema_like(state, None)
        return state

    def restore_eval(self, state: TrainState, step: Optional[int] = None
                     ) -> TrainState:
        """Eval restore: the model, the EMA (or None) and the step, not the
        optimizer's state, so a checkpoint trained under another optimizer
        config evaluates all the same."""
        blob = self._load(step)
        if blob is None:
            return state
        state.model.load_state_dict(blob["model"])
        state.ema_params = (None if blob["ema_params"] is None
                            else self._ema_like(state, blob["ema_params"]))
        state.step = int(blob["step"])
        return state

    def restore_params(self, state: TrainState, step: Optional[int] = None
                       ) -> TrainState:
        """Warm start: the model's parameters and constants only; the
        state keeps its fresh optimizer and step (a stage transition of the
        alternating schedule). The EMA, when the state keeps one, restarts
        from the loaded parameters."""
        blob = self._load(step)
        if blob is None:
            raise ValueError(
                "restore_params: no checkpoint found to warm-start from")
        state.model.load_state_dict(blob["model"])
        if state.ema_params is not None:
            state.ema_params = self._ema_like(state, None)
        return state
