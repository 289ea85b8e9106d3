"""The data-parallel group (``tpudet.parallel.mesh``).

The JAX package builds a ``("data", "model")`` mesh and lets ``pjit``
insert the collectives: the batch is sharded over "data", the parameters
replicated, and the gradients ``psum``-ed. Here each process drives one
card (or the CPU, in the tests) and joins a ``torch.distributed`` group:
NCCL on the card, gloo only where the caller asks for the CPU. The train
step (``train/step.py``) averages the gradients over the group with one
all-reduce of a flat buffer, before clipping and the update, so every
process applies the same update to the same parameters.

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
    """This process's place on the data axis: ``rank`` of ``world_size``,
    and the device it drives (``cuda:LOCAL_RANK`` or the CPU)."""

    rank: int
    world_size: int
    device: torch.device

    def all_reduce_mean_(self, tensor: torch.Tensor) -> torch.Tensor:
        """In place: the mean of ``tensor`` over the group (the sum, then
        divided by the world size; exact for one process)."""
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
        return tensor.div_(self.world_size)

    def all_reduce_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum of ``tensor`` over the group, as a new tensor."""
        out = tensor.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    def barrier(self) -> None:
        if self.device.type == "cuda":
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
                       timeout_s: float = 600.0) -> DataParallel:
    """Join the data-parallel group and return this process's place in it.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``, ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``); the tests pass ``tcp://localhost:<port>``. On
    ``device="cuda"`` the group is NCCL and the process drives
    ``cuda:LOCAL_RANK`` (``cuda:rank`` where torchrun set no
    ``LOCAL_RANK``); ``device="cpu"`` joins over gloo. A collective
    that waits longer than ``timeout_s`` raises."""
    device = torch.device(device)
    if dist.is_initialized():
        raise RuntimeError("init_data_parallel: this process is in a group "
                           "already")
    rank = _env_int("RANK") if rank is None else rank
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside world_size {world_size}")
    if device.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        if not torch.cuda.is_available():
            raise RuntimeError("init_data_parallel(device='cuda'): no CUDA "
                               "card (pass device='cpu' for gloo)")
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local_rank} but {torch.cuda.device_count()} "
                "CUDA cards")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_data_parallel: device {device} (use 'cuda' "
                         "or 'cpu')")
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    if dist.get_world_size() != world_size or dist.get_rank() != rank:
        raise RuntimeError(
            f"joined as rank {dist.get_rank()} of {dist.get_world_size()}, "
            f"asked for {rank} of {world_size}")
    return DataParallel(rank=rank, world_size=world_size, device=device)
