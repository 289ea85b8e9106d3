"""Train and inference steps (``tpudet.train.step``).

JAX's steps are jitted functions of ``(state or variables, batch)``. Here
the weights live in the model: ``make_train_step`` returns ``step(state,
batch) -> (state, metrics)``, which updates the state's model in place, and
``make_eval_step`` returns ``batch -> detections`` under
``torch.inference_mode``. Both move the batch to the model's device.

Under data parallelism (``parallel.DataParallel``) each process holds its
rows of the global batch (``data.loader.process_rows``): its microbatch
``a`` is rows ``rank::world_size`` of the global microbatch ``a``. It
draws the global microbatch's sampler and augmentation uniforms and keeps
its own rows, and the gradients and metrics are averaged over the group
before clipping, so the step equals the one-process step on the joined
batch.

Under tensor parallelism (``parallel.init_mesh`` with a model axis wider
than one, and a state made by ``create_train_state(..., dp=...)``) ``dp``'s
rank and size are the data axis's: the model peers take the same rows and
the same draws, the gradients and metrics are averaged over the data axis
only (over the world it would add different ranks' shards), the replicated
gradients are averaged over the model axis (they are equal there but for
the rounding of the backward kernels' atomics), and the global norm counts
each sharded tensor's squares once over the model group and each
replicated tensor once. The EMA is kept on the shards.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpudet_torch.config import Config
from tpudet_torch.data.preprocess import augment_draws, device_preprocess
from tpudet_torch.parallel import DataParallel
from tpudet_torch.train.state import (
    TrainState,
    ema_decay_at,
    freeze_mask,
    lr_schedule,
)
from tpudet_torch.utils.profiling import span


def _step_seed(seed: int, step: int, micro: int, rank: int = 0) -> int:
    """The seed of the generator of microbatch ``micro`` of update ``step``
    (Deformable DETR's dropout masks, Faster R-CNN's sampler draws):
    deterministic in ``(train.seed, step, micro)`` and unrelated across
    them, as JAX's ``fold_in`` chain is (the bits differ). ``rank`` > 0
    gives a data-parallel process dropout masks of its own."""
    entropy = [seed, step, micro] + ([rank] if rank else [])
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0])


def _augment_seed(seed: int, step: int, micro: int) -> int:
    """The seed of the train-time augmentation's generator of microbatch
    ``micro`` of update ``step``: the second word of ``_step_seed``'s
    stream, so the samplers' draws are the same with or without it."""
    return int(np.random.SeedSequence([seed, step, micro]).generate_state(
        2, np.uint64)[1])


def _own_rows(draws, dp: Optional[DataParallel]):
    """This process's rows ``rank::world_size`` of each draw of the global
    microbatch."""
    if dp is None:
        return draws
    if isinstance(draws, torch.Tensor):
        return draws[dp.rank::dp.world_size]
    if isinstance(draws, dict):
        return {k: _own_rows(v, dp) for k, v in draws.items()}
    return tuple(_own_rows(v, dp) for v in draws)


def _flat_mean_(grads, mean_) -> None:
    """In place: each of ``grads`` replaced by ``mean_`` of it, through one
    flat buffer (one collective)."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    mean_(flat)
    start = 0
    for g in grads:
        g.copy_(flat[start:start + g.numel()].view_as(g))
        start += g.numel()


def make_train_step(model, cfg: Config, device="cuda",
                    fused_preprocess: bool = False,
                    dp: Optional[DataParallel] = None
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``step(state, batch) -> (state, metrics)`` on a batch (``image``,
    ``image_hw``, ``gt_boxes``, ``gt_classes``, ``gt_valid``; tensors or
    arrays; other entries pass through), as the JAX step. Without
    ``fused_preprocess`` the image is normalized already; with it the batch
    is the loader's (uint8 canvases) and each microbatch goes through
    ``device_preprocess(training=True)`` on the card, its flip and jitter
    drawn from a generator seeded by ``_augment_seed``. Then:

    * ``train.accum_steps`` microbatches of strided rows (rows ``a``,
      ``a + accum``, ...), their gradients summed and divided by the count,
      their metrics averaged;
    * with ``dp``, the batch is this process's rows of the global batch
      (``data.loader.process_rows``): the sampler and augmentation uniforms
      are drawn for the global microbatch and cut to its rows, the DETR
      and Deformable DETR set losses divide by the group's positive count
      (DETR's CE by the group's sum of class weights too), and the
      gradients and metrics are averaged over the group (one all-reduce of
      a flat buffer);
    * frozen parameters' gradients dropped before the ``grad_norm`` metric
      (the norm of the gradients before clipping);
    * clipping by global norm as ``optax.clip_by_global_norm``: ``g / norm *
      max_norm`` when the norm is at least ``max_norm``, else unchanged;
    * the rate of update ``n`` is ``schedule(n)`` times each group's factor;
    * the EMA ``e + (1 - d) * (p - e)`` with the decay after the update.

    Each call is a ``tpudet/step`` span (``utils.profiling.span``) holding
    per microbatch ``tpudet/preprocess`` (its copy to the device and
    ``device_preprocess``), ``tpudet/forward`` (the draws and the loss) and
    ``tpudet/backward``, then ``tpudet/optimizer`` (from dropping the frozen
    gradients to the metrics' reduction).

    Runs on ``device`` (CUDA unless the caller passes "cpu"), where the
    state's model must be, and which must be ``dp.device``."""
    tcfg = cfg.train
    if cfg.det_only and "rpn_head" not in tcfg.freeze:
        # det_only gives the RPN no loss gradient: unfrozen, weight decay
        # alone would move the proposals the detector trains against.
        raise ValueError("det_only training requires 'rpn_head' in "
                         "train.freeze (the RPN supplies proposals but "
                         "receives no gradient)")
    device = torch.device(device)
    if model.device != device:
        raise ValueError(f"make_train_step(device={device}): the model lives "
                         f"on {model.device} (create_train_state moves it)")
    if dp is not None and dp.device != device:
        raise ValueError(f"make_train_step(device={device}): this process "
                         f"of the data-parallel group drives {dp.device}")
    tp = getattr(model.core, "tp", None)
    if dp is not None and dp.model_size > 1 and tp is None:
        raise ValueError("make_train_step: a model axis of "
                         f"{dp.model_size} but the model is not sharded "
                         "(create_train_state(..., dp=...) cuts it)")
    share = 1 if dp is None else dp.world_size
    rank = 0 if dp is None else dp.rank
    # Faster R-CNN's samplers draw from the step's generator; DETR's and
    # Deformable DETR's dropout does, inside their losses; RetinaNet and
    # FCOS draw nothing.
    draws_samples = hasattr(model, "draw_samples")
    loss_kw = {} if dp is None else {"dp": dp}
    accum = max(1, tcfg.accum_steps)
    if accum > 1 and tcfg.batch_size % accum:
        raise ValueError(f"train.batch_size {tcfg.batch_size} not divisible by "
                         f"train.accum_steps {accum}")
    schedule = lr_schedule(tcfg)
    frozen = freeze_mask(model.core, tcfg.freeze)
    trainable = [p for name, p in model.core.named_parameters()
                 if not frozen[name]]
    frozen_params = [p for name, p in model.core.named_parameters()
                     if frozen[name]]
    sharded = [tp is not None and tp.layout[name].kind != "replicated"
               for name, p in model.core.named_parameters()
               if not frozen[name]]
    max_norm = tcfg.grad_clip_norm

    def step_fn(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        with span("tpudet/step"):
            batch = {k: torch.as_tensor(v) for k, v in batch.items()}
            if batch["image"].shape[0] % accum:
                raise ValueError(f"batch of {batch['image'].shape[0]} not "
                                 f"divisible by train.accum_steps {accum}")
            model.train()
            state.optimizer.zero_grad(set_to_none=True)
            per_micro = []
            for a in range(accum):
                with span("tpudet/preprocess"):
                    micro = {k: (v[a::accum] if accum > 1 else v).to(
                        device, non_blocking=True) for k, v in batch.items()}
                    rows = micro["image"].shape[0] * share  # global batch's
                    if fused_preprocess:
                        augment = torch.Generator(device=device).manual_seed(
                            _augment_seed(tcfg.seed, state.step, a))
                        micro = device_preprocess(
                            cfg, micro, training=True,
                            draws=_own_rows(augment_draws(augment, rows), dp))
                with span("tpudet/forward"):
                    generator = torch.Generator(device=device).manual_seed(
                        _step_seed(tcfg.seed, state.step, a,
                                   0 if draws_samples else rank))
                    if draws_samples:
                        # The global batch's draws (loss would draw the local
                        # batch's), this process's rows of them.
                        draws = model.draw_samples(generator, rows,
                                                   micro["image"].shape[1:3])
                        loss, metrics = model.loss(
                            micro, draws=_own_rows(draws, dp))
                    else:
                        loss, metrics = model.loss(micro, generator, **loss_kw)
                with span("tpudet/backward"):
                    loss.backward()
                per_micro.append({k: v.detach() for k, v in metrics.items()})
            with span("tpudet/optimizer"):
                for p in frozen_params:
                    p.grad = None
                grads = []
                for p in trainable:
                    if p.grad is None:  # behind freeze_stem: optax sees zeros
                        p.grad = torch.zeros_like(p)
                    elif accum > 1:
                        p.grad.div_(accum)
                    grads.append(p.grad)
                if dp is not None:
                    # psum's semantics: one all-reduce of every gradient, flat.
                    _flat_mean_(grads, dp.all_reduce_mean_)
                if tp is not None:
                    # The model peers' replicated gradients are equal but
                    # for the rounding of kernels whose sums have no fixed
                    # order (the RoI Align backwards' atomics): their mean
                    # keeps the peers' replicated parameters equal, step
                    # after step.
                    _flat_mean_([g for g, cut in zip(grads, sharded)
                                 if not cut], tp.mean_)
                if tp is None:
                    grad_norm = torch.stack([g.square().sum()
                                             for g in grads]).sum().sqrt()
                else:
                    def squares(part):
                        return torch.stack(
                            [g.square().sum() for g, cut
                             in zip(grads, sharded) if cut == part]
                            or [grads[0].new_zeros(())]).sum()

                    cut_squares = squares(True)
                    dist.all_reduce(cut_squares, group=tp.group)
                    grad_norm = (cut_squares + squares(False)).sqrt()
                if max_norm > 0:
                    keep = grad_norm < max_norm
                    for g in grads:
                        g.copy_(torch.where(keep, g, g / grad_norm * max_norm))
                lr = schedule(state.step)
                for group in state.optimizer.param_groups:
                    group["lr"] = lr * group["lr_factor"]
                state.optimizer.step()
                state.step += 1
                if tcfg.ema_decay > 0:
                    if state.ema_params is None:
                        raise ValueError(
                            "train.ema_decay > 0 but the state has no EMA: "
                            "create it with create_train_state")
                    keep_ema = ema_decay_at(tcfg, state.step)
                    with torch.no_grad():
                        for name, p in model.core.named_parameters():
                            e = state.ema_params[name]
                            e.add_((p - e) * (1.0 - keep_ema))
                metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                           for k in per_micro[0]}
                if dp is not None:  # the group's means
                    names = list(metrics)
                    values = dp.all_reduce_mean_(
                        torch.stack([metrics[k].float() for k in names]))
                    metrics = dict(zip(names, values.unbind()))
                metrics["grad_norm"] = grad_norm
                return state, metrics

    return step_fn


def make_eval_step(model, cfg: Config, fused_preprocess: bool = True
                   ) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """``batch`` (``image [B, H, W, 3]`` uint8 or normalized, ``image_hw
    [B, 2]``; tensors or arrays) -> the detection dict of ``predict``; each
    call a ``tpudet/step`` span holding ``tpudet/preprocess`` and
    ``tpudet/predict``."""

    @torch.inference_mode()
    def eval_fn(batch):
        with span("tpudet/step"):
            with span("tpudet/preprocess"):
                batch = {k: torch.as_tensor(v).to(model.device,
                                                  non_blocking=True)
                         for k, v in batch.items()}
                if fused_preprocess:
                    batch = device_preprocess(cfg, batch, training=False)
            with span("tpudet/predict"):
                return model.predict(batch)

    return eval_fn
