"""Train state, optimizer and schedule (``tpudet.train.state``).

The JAX package builds an optax chain: zero the frozen gradients, clip by
global norm, weight decay (coupled for sgd/adam, decoupled for adamw) under
an ``ndim >= 2`` mask, the optimizer core with a warmup schedule, the
backbone's updates scaled by ``backbone_lr_factor``, and the frozen updates
zeroed again. Here the same update is a ``torch.optim`` optimizer whose
parameter groups carry the decay and the learning-rate factor, driven by
``train.step.make_train_step``, which clips and sets each group's rate:

* the decay mask reads the Flax leaf's ndim (``flax_param_ndims``): the
  attention's ``query``/``key``/``value`` biases are ``[heads, hd]`` in
  Flax and decayed, though the port flattens them;
* a parameter with no gradient (behind ``freeze_stem``) gets a zero one, so
  AdamW still decays it as optax does (``torch.optim`` skips a ``None``
  gradient);
* the factor scales the whole update, decay included: a group whose rate is
  the schedule's times the factor;
* frozen parameters (``train.freeze``) belong to no group and never change.

Under tensor parallelism ``create_train_state`` cuts the model
(``models.layers.shard_model`` by ``parallel.sharding_rules.tp_layout``)
before it makes the optimizer and the EMA, so the momentum, Adam's moments
and the EMA are this rank's shards too, as the JAX package shards the
train state "optimizer state included"; the decay mask still reads the Flax
leaf's ndim.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from tpudet_torch.config import TrainConfig
from tpudet_torch.models.import_weights import flax_param_ndims
from tpudet_torch.models.layers import shard_model
from tpudet_torch.parallel.sharding_rules import tp_layout

F32 = np.float32


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the state's and change in place), the
    optimizer over its ``core``, the number of updates taken, and the EMA
    of the parameters (``train.ema_decay > 0``) or None."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.core.named_parameters())

    def eval_model(self, use_ema: bool = False) -> nn.Module:
        """The model for inference; with ``use_ema`` the EMA average is
        copied into its parameters first (the eval and detect CLIs'
        ``--ema``)."""
        if use_ema:
            if self.ema_params is None:
                raise ValueError(
                    "--ema requested but this state carries no EMA average "
                    "(it was trained with train.ema_decay=0)")
            with torch.no_grad():
                for name, p in self.model.core.named_parameters():
                    p.copy_(self.ema_params[name])
        return self.model


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """``step -> learning rate``, in JAX's f32 arithmetic: a linear warmup
    from ``warmup_factor``, then "step" (times ``lr_gamma`` from each
    milestone on) or "cosine" (half-cosine down to ``lr_min_factor *
    learning_rate`` at ``total_steps``). The first update uses step 0."""
    kind = cfg.lr_schedule
    if kind not in ("step", "cosine"):
        raise ValueError(
            f"unknown train.lr_schedule {kind!r} (use 'step' or 'cosine')")
    boundaries = sorted({int(s): cfg.lr_gamma for s in cfg.lr_milestones}.items())
    lr = F32(cfg.learning_rate)

    def base(step: int):
        if kind == "step":
            value = lr
            for boundary, scale in boundaries:
                if step >= boundary:
                    value = F32(scale) * value
            return value
        # Where JAX mixes Python floats, it computes them in double first.
        lr_min = cfg.lr_min_factor * cfg.learning_rate
        frac = F32(min(step, cfg.total_steps)) / F32(max(cfg.total_steps, 1))
        return F32(lr_min) + F32(0.5 * (cfg.learning_rate - lr_min)) * (
            F32(1.0) + np.cos(F32(math.pi) * frac))

    def schedule(step: int) -> float:
        value = base(step)
        if step < cfg.warmup_steps:
            warm = F32(cfg.warmup_factor) + F32(1.0 - cfg.warmup_factor) * (
                F32(min(step, cfg.warmup_steps)) / F32(max(cfg.warmup_steps, 1)))
            value = value * warm
        return float(value)

    return schedule


def ema_decay_at(cfg: TrainConfig, num_updates: int) -> float:
    """The EMA decay after ``num_updates`` updates: min(ema_decay, (1 + n) /
    (10 + n)) in f32, so the first steps do not pin the average to the
    init."""
    n = F32(num_updates)
    return float(min(F32(cfg.ema_decay), (F32(1.0) + n) / (F32(10.0) + n)))


def freeze_mask(module: nn.Module, prefixes: Iterable[str]) -> Dict[str, bool]:
    """Parameter name -> True where its slash-joined path (the Flax tree's:
    ``backbone/stage2_block0/...``) starts with one of ``prefixes``. Raises
    on a prefix that matches no parameter."""
    prefixes = tuple(prefixes)
    paths = {name: name.replace(".", "/") for name, _ in module.named_parameters()}

    def under(path, prefix):
        return path == prefix or path.startswith(prefix + "/")

    for prefix in prefixes:
        if not any(under(path, prefix) for path in paths.values()):
            top = sorted({path.split("/")[0] for path in paths.values()})
            raise ValueError(f"train.freeze prefix {prefix!r} matches no "
                             f"parameter; top-level subtrees: {top}")
    return {name: any(under(path, p) for p in prefixes)
            for name, path in paths.items()}


def make_optimizer(module: nn.Module, cfg: TrainConfig) -> torch.optim.Optimizer:
    """The optimizer over ``module``'s trainable parameters, one group per
    (decayed, backbone) pair. Each group's ``lr_factor`` multiplies the
    schedule's rate (``backbone_lr_factor`` for the backbone, 1 otherwise);
    ``make_train_step`` sets ``lr`` before every update."""
    ndims = flax_param_ndims(module)
    frozen = freeze_mask(module, cfg.freeze)
    backbone = (freeze_mask(module, ("backbone",))
                if cfg.backbone_lr_factor != 1.0 else {})
    groups: Dict[tuple, list] = {}
    for name, p in module.named_parameters():
        if frozen[name]:
            continue
        key = (ndims[name] >= 2, backbone.get(name, False))
        groups.setdefault(key, []).append(p)
    param_groups = [
        {"params": params,
         "weight_decay": cfg.weight_decay if decay else 0.0,
         "lr_factor": cfg.backbone_lr_factor if in_backbone else 1.0}
        for (decay, in_backbone), params in sorted(groups.items())]
    if cfg.optimizer == "sgd":
        # Coupled L2 (wd * p added to the gradient), as optax's
        # add_decayed_weights before sgd; momentum trace g + m * t.
        return torch.optim.SGD(param_groups, lr=cfg.learning_rate,
                               momentum=cfg.momentum)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(param_groups, lr=cfg.learning_rate)
    if cfg.optimizer == "adamw":
        # Decoupled decay (Loshchilov & Hutter, arXiv:1711.05101).
        return torch.optim.AdamW(param_groups, lr=cfg.learning_rate)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def create_train_state(model: nn.Module, cfg: TrainConfig,
                       seed: Optional[int] = 0, device="cuda",
                       dp=None) -> TrainState:
    """Move ``model`` to ``device`` (CUDA unless the caller passes "cpu"),
    draw its weights from ``seed`` (None keeps the weights it has, e.g.
    converted ones), and build the optimizer and the EMA copy. With ``dp``
    (``parallel.init_mesh``) on a model axis wider than one, the whole
    weights are drawn first (every rank draws the same), then the model is
    cut to this rank's shards."""
    if not 0.0 <= cfg.ema_decay < 1.0:
        raise ValueError(
            f"train.ema_decay {cfg.ema_decay} must be in [0, 1) (0 disables)")
    device = torch.device(device)
    if model.device != device:
        model.to(device)
        model.device = device
    if seed is not None:
        model.init(seed)
    if dp is not None and dp.model_size > 1:
        shard_model(model, tp_layout(model, dp.model_size), dp.model_group)
    ema = ({name: p.detach().clone()
            for name, p in model.core.named_parameters()}
           if cfg.ema_decay > 0 else None)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model.core, cfg),
                      ema_params=ema)
