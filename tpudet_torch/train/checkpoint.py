"""Checkpoints (``tpudet.train.checkpoint``): save every N steps, keep the
last k, restore on start, warm-start the parameters alone.

One directory per step under ``directory``, named by the step, holding
``state.pt``: ``torch.save`` of the model's state dict (parameters and the
frozen constants, as CPU tensors), the optimizer's state dict, the step,
the EMA parameters (or None) and the config as a dict. A save writes a
temporary directory and renames it, so a run killed mid-save leaves no
half checkpoint. The JAX package's checkpoints are orbax trees; the two
formats do not read each other.

Under tensor parallelism (a model cut by ``models.layers.shard_model``) a
checkpoint still holds whole tensors: ``save`` joins each sharded
parameter, its optimizer state and its EMA from the model peers (every peer
calls it; an all-reduce of zero-padded shards over the model group) and the
peer of model rank 0 writes. ``restore``, ``restore_eval`` and
``restore_params`` take the current layout's slice, so a checkpoint
restores into any mesh and into one process, and serving and export load
the same files.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Dict, List, Optional

import torch

from tpudet_torch.train.state import TrainState

_FILE = "state.pt"
_CORE = "core."


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _cut_dim(tp, name: str) -> Optional[int]:
    """The dimension of parameter ``name`` (a ``core`` name) that ``tp``
    cuts, or None (no tensor parallelism, replicated, or no parameter)."""
    if tp is None or name not in tp.layout:
        return None
    return tp.layout[name].dim


def param_names(state: TrainState):
    """The ``core`` parameter name of each index of the optimizer's state
    dict (its groups' parameters, in order)."""
    names = {id(p): n for n, p in state.model.core.named_parameters()}
    return [names[id(p)] for group in state.optimizer.param_groups
            for p in group["params"]]


def optimizer_map(state: TrainState, opt: Dict, fn) -> Dict:
    """``opt`` (an optimizer state dict) with ``fn(tensor, dim)`` applied to
    each per-parameter tensor (momentum, moments; not the step count)."""
    tp = state.model.core.tp
    names = param_names(state)
    out = dict(opt, state={})
    for index, entry in opt["state"].items():
        dim = _cut_dim(tp, names[int(index)])
        out["state"][index] = {
            k: fn(v, dim) if isinstance(v, torch.Tensor) and v.ndim else v
            for k, v in entry.items()}
    return out


def model_map(tp, tensors: Dict[str, torch.Tensor], fn, prefix: str = ""
              ) -> Dict[str, torch.Tensor]:
    """``tensors`` (by ``prefix`` + ``core`` name) with ``fn(tensor, dim)``
    applied to each, ``dim`` the dimension ``tp`` cuts (None for the
    replicated ones and the buffers)."""
    return {k: fn(v, _cut_dim(tp, k[len(prefix):] if k.startswith(prefix)
                              else None))
            for k, v in tensors.items()}


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
        already (the end-of-training save landing on an every-N save), and
        on a model peer of rank > 0, which only lends its shards. ``force``
        is kept for the JAX signature: every call saves."""
        del force
        step = int(state.step)
        tp = getattr(state.model.core, "tp", None)
        model, optimizer, ema = (state.model.state_dict(),
                                 state.optimizer.state_dict(),
                                 state.ema_params)
        if tp is not None:  # every peer joins, in the same order
            model = model_map(tp, model, tp.join, _CORE)
            optimizer = optimizer_map(state, optimizer, tp.join)
            ema = None if ema is None else model_map(tp, ema, tp.join)
            if tp.rank != 0:
                return False
        if step == self.latest_step:
            return False
        optimizer = dict(optimizer, state={
            k: {n: v.detach().cpu() if isinstance(v, torch.Tensor) else v
                for n, v in entry.items()}
            for k, entry in optimizer["state"].items()})
        blob = {
            "step": step,
            "model": _cpu(model),
            "optimizer": optimizer,
            "ema_params": None if ema is None else _cpu(ema),
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

    def _load(self, step: Optional[int],
              state: Optional[TrainState] = None):
        """The checkpoint at ``step`` (the latest by default; None when
        there is none), its tensors whole, or cut to ``state``'s layout."""
        if step is None:
            step = self.latest_step
        if step is None:
            return None
        blob = torch.load(os.path.join(self.directory, str(step), _FILE),
                          map_location="cpu", weights_only=True)
        tp = None if state is None else getattr(state.model.core, "tp", None)
        if tp is not None:
            blob["model"] = model_map(tp, blob["model"], tp.shard, _CORE)
            blob["optimizer"] = optimizer_map(state, blob["optimizer"],
                                               tp.shard)
            if blob["ema_params"] is not None:
                blob["ema_params"] = model_map(tp, blob["ema_params"],
                                                tp.shard)
        return blob

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
        blob = self._load(step, state)
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
        blob = self._load(step, state)
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
        blob = self._load(step, state)
        if blob is None:
            raise ValueError(
                "restore_params: no checkpoint found to warm-start from")
        state.model.load_state_dict(blob["model"])
        if state.ema_params is not None:
            state.ema_params = self._ema_like(state, None)
        return state
