"""Greedy NMS keep-walk: the Hopper kernel (``csrc/nms.cu``) and its plain
PyTorch version.

Replaces ``tpudet/kernels/nms.py::_nms_kernel`` (reached through
``nms_pallas``). The TPU kernel resolves 128-box tiles with a vectorized
fixed-point sweep because the TPU is one wide core. On Hopper the walk
goes down the sorted boxes 256 at a time. A first kernel writes, for every
step of every image at once, each box's diagonal words: the later boxes of
its step that it overlaps. Then one cluster of 8 blocks per image walks:
each block tests the step's boxes against its share of the boxes kept so
far (1 in 8, in its shared memory), one cluster barrier joins the blocks'
findings, and one warp resolves the step against the diagonal words in
registers, stopping at ``max_outputs`` keeps. No P x P bitmask is built.

What bounds it on the H100: the least work is testing each box the walk
reaches against the boxes kept before it; the IoU tests (13 f32
operations each) outweigh the bytes, so operations set the bound. The
walk makes those tests, spread over the cluster's 8 SMs, plus the latency
of one step per 256 boxes it reaches; the diagonal kernel adds 32,640
tests a step, all steps in parallel.

Decisions are bit-exact against the plain version (and the JAX kernel): f32
IoU in the JAX operation order, no FMA (``-fmad=false`` and round-to-nearest
intrinsics), the threshold passed as a 32-bit float.

The launcher is the CUDA body of the ``tpudet::nms_keep`` operator
(``kernels/_ops.py``), so ``torch.export`` carries the kernel into a
serving artifact.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from tpudet_torch.kernels import _build, _ops
from tpudet_torch.ops.nms import _select_kept, greedy_keep

# Launches of the CUDA kernel, one per wrapper call on a CUDA tensor.
LAUNCHES = 0

SOURCE = "tpudet_torch/kernels/csrc/nms.cu"
REPLACES = "tpudet/kernels/nms.py:74"
# The kept list fills at most 212 KB of each block's shared memory
# (kMaxDynamicSmem), 20 bytes a box, 1 box in 8 per block.
MAX_KEPT = 8 * (212 * 1024 // 20)


def nms_keep_plain(boxes_sorted: torch.Tensor, candidate: torch.Tensor,
                   iou_threshold: float, max_outputs: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``[B, P, 4]`` score-sorted boxes + ``[B, P]``
    candidates -> ``(positions [B, max_outputs] int32, valid bool)``, the
    sorted positions of the first ``max_outputs`` kept boxes (0 where
    invalid)."""
    keep = greedy_keep(boxes_sorted, candidate, iou_threshold)
    order = torch.arange(keep.shape[1], device=keep.device).expand_as(keep)
    return _select_kept(keep, order, max_outputs)


def _lib():
    lib = _build.load("nms")
    fn = lib.tpudet_nms
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(boxes_sorted: torch.Tensor, candidate: torch.Tensor,
            iou_threshold: float, max_outputs: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA body of ``tpudet::nms_keep``: checks and one launch ->
    ``(positions [B, max_outputs] int32, count [B] int32)``."""
    global LAUNCHES
    if boxes_sorted.device.type != "cuda" or candidate.device != boxes_sorted.device:
        raise ValueError("nms_keep_cuda needs boxes and candidates on one CUDA device")
    if boxes_sorted.dtype != torch.float32 or candidate.dtype != torch.bool:
        raise TypeError(f"nms_keep_cuda takes f32 boxes and a bool mask, got "
                        f"{boxes_sorted.dtype}, {candidate.dtype}")
    b, p = candidate.shape
    if boxes_sorted.shape != (b, p, 4) or p == 0 or max_outputs <= 0:
        raise ValueError(f"bad NMS shapes {tuple(boxes_sorted.shape)}, "
                         f"{tuple(candidate.shape)}, max_outputs={max_outputs}")
    if min(max_outputs, p) > MAX_KEPT or b > 65535:
        raise ValueError(f"NMS keeping up to {min(max_outputs, p)} boxes "
                         f"x {b} images exceeds the kernel's kept list "
                         f"({MAX_KEPT}) or grid (65535 images)")
    boxes_sorted = boxes_sorted.contiguous()
    candidate = candidate.contiguous()
    dev = boxes_sorted.device
    diag = torch.empty((b, p, 4), dtype=torch.int64, device=dev)
    positions = torch.empty((b, max_outputs), dtype=torch.int32, device=dev)
    count = torch.empty((b,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()(boxes_sorted.data_ptr(), candidate.data_ptr(),
                     diag.data_ptr(), positions.data_ptr(), count.data_ptr(),
                     b, p, iou_threshold, max_outputs, stream)
    if err != 0:
        raise RuntimeError(f"NMS kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return positions, count


def _fake(boxes_sorted, candidate, iou_threshold, max_outputs):
    b = candidate.shape[0]
    return (candidate.new_empty((b, max_outputs), dtype=torch.int32),
            candidate.new_empty((b,), dtype=torch.int32))


nms_keep_op = _ops.register(
    "nms_keep", "(Tensor boxes_sorted, Tensor candidate, float iou_threshold, "
    "int max_outputs) -> (Tensor, Tensor)", _launch, _fake)


def nms_keep_cuda(boxes_sorted: torch.Tensor, candidate: torch.Tensor,
                  iou_threshold: float, max_outputs: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel, through ``tpudet::nms_keep``: same contract as
    :func:`nms_keep_plain`."""
    if boxes_sorted.device.type != "cuda":
        raise ValueError("nms_keep_cuda needs boxes and candidates on one "
                         "CUDA device")
    positions, count = nms_keep_op(boxes_sorted, candidate, iou_threshold,
                                   max_outputs)
    rank = torch.arange(max_outputs, device=count.device)
    return positions, rank[None, :] < count[:, None]


def nms_keep(boxes_sorted: torch.Tensor, candidate: torch.Tensor,
             iou_threshold: float, max_outputs: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch by device: CUDA -> the kernel, CPU -> the plain version."""
    if boxes_sorted.device.type == "cuda":
        return nms_keep_cuda(boxes_sorted, candidate, iou_threshold, max_outputs)
    if boxes_sorted.device.type == "cpu":
        return nms_keep_plain(boxes_sorted, candidate, iou_threshold, max_outputs)
    raise ValueError(f"no NMS for device {boxes_sorted.device}")
