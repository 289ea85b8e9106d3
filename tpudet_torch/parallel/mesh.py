"""The data-parallel group and the ("data", "model") mesh
(``tpudet.parallel.mesh``).

The JAX package builds a ``("data", "model")`` mesh and lets ``pjit``
insert the collectives: the batch is sharded over "data", the parameters
replicated over "data" and cut over "model" by ``sharding_rules``, and the
gradients ``psum``-ed. Here each process drives one card (or the CPU, in
the tests) and joins a ``torch.distributed`` group: NCCL on the card, gloo
only where the caller asks for it. The train step (``train/step.py``)
averages the gradients over the data axis with one all-reduce of a flat
buffer, before clipping and the update, so every process applies the same
update to the same parameters (its shard of them, under tensor
parallelism).

``init_mesh`` lays ``num_data x num_model`` processes out as ``make_mesh``
lays devices out: global rank ``d * num_model + m`` is data rank ``d`` and
model rank ``m``, so the model peers are neighbouring ranks. Each process
gets a subgroup for each axis: its data group (the ranks of its model rank)
and its model group (the ranks of its data rank). ``init_data_parallel``
is the mesh with a one-wide model axis.

A process joins from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or from explicit
arguments. A group that was asked for and cannot be formed raises: nothing
falls back to one process.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place on the mesh: ``rank`` of ``world_size`` on the
    data axis, and the device it drives (``cuda:LOCAL_RANK`` or the CPU).
    Under tensor parallelism also ``model_rank`` of ``model_size`` on the
    model axis, and the two axes' subgroups: ``group`` (the data axis; None
    is the whole world, as with one-wide model axis) and ``model_group``
    (None when the model axis is one wide)."""

    rank: int
    world_size: int
    device: torch.device
    model_rank: int = 0
    model_size: int = 1
    group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def global_rank(self) -> int:
        """The rank in the whole world (``make_mesh``'s device order)."""
        return self.rank * self.model_size + self.model_rank

    def all_reduce_mean_(self, tensor: torch.Tensor) -> torch.Tensor:
        """In place: the mean of ``tensor`` over the data axis (the sum,
        then divided by its size; exact for one process)."""
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=self.group)
        return tensor.div_(self.world_size)

    def all_reduce_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum of ``tensor`` over the data axis, as a new tensor."""
        out = tensor.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def barrier(self) -> None:
        """Every process of the world waits for the others."""
        if self.device.type == "cuda" and dist.get_backend() == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def close(self) -> None:
        """Leave the group (the process's last collective call)."""
        dist.destroy_process_group()


def _env_int(name: str) -> int:
    value = os.environ.get(name)
    if value is None:
        raise ValueError(
            f"init_data_parallel: {name} is not set; run under torchrun "
            "(torchrun --nproc-per-node N -m tpudet_torch.cli.train ...) or "
            "pass rank and world_size")
    return int(value)


def init_data_parallel(device="cuda", rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None,
                       timeout_s: float = 600.0,
                       backend: Optional[str] = None) -> DataParallel:
    """Join the data-parallel group and return this process's place in it:
    ``init_mesh`` with a one-wide model axis."""
    return init_mesh(1, -1, device, rank, world_size, init_method, timeout_s,
                     backend)


def init_mesh(num_model: int = 1, num_data: int = -1, device="cuda",
              rank: Optional[int] = None, world_size: Optional[int] = None,
              init_method: Optional[str] = None, timeout_s: float = 600.0,
              backend: Optional[str] = None) -> DataParallel:
    """Join the ``num_data x num_model`` mesh and return this process's
    place on it. ``num_data=-1`` is the world size over ``num_model``, as
    in ``make_mesh``; the product must be the world size.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``, ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``); the tests pass ``tcp://localhost:<port>``. On
    ``device="cuda"`` the group is NCCL and the process drives
    ``cuda:LOCAL_RANK`` (``cuda:rank`` where torchrun set no
    ``LOCAL_RANK``; a device with an index, e.g. ``"cuda:0"``, is driven as
    given); ``device="cpu"`` joins over gloo. ``backend`` overrides that
    choice ("gloo" on the card: two processes that share one card, which
    NCCL refuses). A collective that waits longer than ``timeout_s``
    raises."""
    device = torch.device(device)
    if dist.is_initialized():
        raise RuntimeError("init_mesh: this process is in a group already")
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world_size {world_size}")
    if num_model < 1 or world_size % num_model:
        raise ValueError(f"a model axis of {num_model} does not divide the "
                         f"world size {world_size}")
    if num_data == -1:
        num_data = world_size // num_model
    if num_data * num_model != world_size:
        raise ValueError(f"mesh {num_data}x{num_model} needs "
                         f"{num_data * num_model} processes, the world has "
                         f"{world_size}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_mesh(device='cuda'): no CUDA card (pass "
                               "device='cpu' for gloo)")
        index = (int(os.environ.get("LOCAL_RANK", rank))
                 if device.index is None else device.index)
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"card {index} asked for but "
                               f"{torch.cuda.device_count()} CUDA cards")
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
        backend = backend or "nccl"
    elif device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"init_mesh: backend {backend!r} on the CPU")
        backend = "gloo"
    else:
        raise ValueError(f"init_mesh: device {device} (use 'cuda' or 'cpu')")
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    if dist.get_world_size() != world_size or dist.get_rank() != rank:
        raise RuntimeError(
            f"joined as rank {dist.get_rank()} of {dist.get_world_size()}, "
            f"asked for {rank} of {world_size}")
    data_rank, model_rank = divmod(rank, num_model)
    if num_model == 1:
        return DataParallel(rank=rank, world_size=world_size, device=device)
    # Every process creates every subgroup, in the same order.
    group = model_group = None
    for m in range(num_model):
        g = dist.new_group([d * num_model + m for d in range(num_data)])
        if m == model_rank:
            group = g
    for d in range(num_data):
        g = dist.new_group([d * num_model + m for m in range(num_model)])
        if d == data_rank:
            model_group = g
    return DataParallel(rank=data_rank, world_size=num_data, device=device,
                        model_rank=model_rank, model_size=num_model,
                        group=group, model_group=model_group)
