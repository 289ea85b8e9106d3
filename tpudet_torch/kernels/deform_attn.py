"""Multi-scale deformable attention: the Hopper kernels
(``csrc/deform_attn.cu``, forward and backward) and their plain PyTorch
version.

The forward replaces ``tpudet/kernels/deform_attn_mxu.py::_fwd_banded_kernel``
and ``::_fwd_flat_kernel``, the backward ``::_bwd_banded_kernel`` and
``::_bwd_flat_kernel`` (all reached through ``ms_deform_attn_mxu`` and its
custom VJP). The TPU kernels contract one-hot selectors with each level's
value map on the matrix unit because the TPU cannot gather; their
banded/flat split, bf16 hi/lo operands, per-axis weight-gradient outputs and
the rule that the head dim divide 128 are TPU workarounds. On Hopper the
bilinear 4-corner gather is the natural form: one launch samples all levels
for every query of the batch, through a by-value table of (H_l, W_l, start
offset). Both kernels give each (image, query, head) one warp, which
stages its samples' corners in shared memory 32 at a time (so any number
of samples per query) and then takes them with its lanes over the four
corner rows: the forward loads 16 bytes a lane (a warp load covers two
samples in bf16, one in f32), the backward 8 or 16 (one sample). A block
of the forward holds neighbouring queries of one head, which share corner
rows in L1.

What bounds them on the H100: the forward, the corner gathers (each
sample's four corner rows read once per (query, head): ~51 M rows for one
bf16 encoder layer at b=8 on 832x832, against ~0.35 GB that the function
must move); their rate in rows, more than in bytes, sets its time. It
sums in f32 in registers and adds the corner lanes by shuffles. The
backward, instructions and latency: it adds into an f32 value gradient
with one vector atomic per lane and corner, and casts it once to the
values' dtype (for f32 values the accumulator is the result).

``ms_deform_attn`` is the differentiable entry: on the card an autograd
Function runs the forward kernel and, for the gradients, the backward
kernel; on the CPU autograd runs through the plain version.

The launchers are the CUDA bodies of the operators
``tpudet::ms_deform_attn_fwd`` and ``tpudet::ms_deform_attn_bwd``
(``kernels/_ops.py``), so ``torch.export`` carries the kernels into a
serving artifact; training calls them through the autograd Function.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from tpudet_torch.kernels import _build, _ops
# The plain version: the gather-then-weighted-sum form, in ``ops.deform_attn``.
from tpudet_torch.ops.deform_attn import (
    level_start_offsets,
    ms_deform_attn_batched as ms_deform_attn_plain,
)

# Launches of the CUDA kernels, one per wrapper call on CUDA tensors.
LAUNCHES = 0
BACKWARD_LAUNCHES = 0

SOURCE = "tpudet_torch/kernels/csrc/deform_attn.cu"
REPLACES = "tpudet/kernels/deform_attn_mxu.py:173"
BACKWARD_REPLACES = ("tpudet/kernels/deform_attn_mxu.py:244 and "
                     "tpudet/kernels/deform_attn_mxu.py:319")

MAX_LEVELS = 4  # kMaxLevels of the CUDA source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["ms_deform_attn", "ms_deform_attn_cuda",
           "ms_deform_attn_backward_cuda", "ms_deform_attn_plain"]


def _lib():
    lib = _build.load("deform_attn")
    fwd, bwd = lib.tpudet_ms_deform_attn_forward, lib.tpudet_ms_deform_attn_backward
    if fwd.argtypes is None:
        tail = ([ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)] * 3
                + [ctypes.c_int, ctypes.c_void_p])
        fwd.argtypes = [ctypes.c_void_p] * 4 + tail
        bwd.argtypes = [ctypes.c_void_p] * 7 + tail
        fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(values, level_shapes, locations, weights, name):
    """Device, dtype, shape and layout checks shared by both kernels."""
    dev = values.device
    if dev.type != "cuda" or locations.device != dev or weights.device != dev:
        raise ValueError(f"{name} needs all inputs on one CUDA device")
    if values.dtype not in _DTYPES:
        raise TypeError(f"{name} takes f32 or bf16 values, got {values.dtype}")
    if locations.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"{name} takes f32 locations and weights")
    b, n, h, d = values.shape
    q, lv, p = locations.shape[1], locations.shape[3], locations.shape[4]
    if not 1 <= lv <= MAX_LEVELS or len(level_shapes) != lv:
        raise ValueError(f"{name} takes 1..{MAX_LEVELS} levels, got "
                         f"{len(level_shapes)} shapes for {lv} levels")
    offsets, total = level_start_offsets(level_shapes)
    if total != n:
        raise ValueError(f"level_shapes {tuple(level_shapes)} sum to {total} "
                         f"tokens, values carry {n}")
    if (locations.shape != (b, q, h, lv, p, 2)
            or weights.shape != (b, q, h, lv, p)):
        raise ValueError(f"bad deformable attention shapes {tuple(values.shape)}"
                         f", {tuple(locations.shape)}, {tuple(weights.shape)}")
    if not (values.is_contiguous() and locations.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError(f"{name} needs contiguous values, locations and "
                         "weights")
    ints = ctypes.c_int * lv
    table = (ints(*(hl for hl, _ in level_shapes)),
             ints(*(wl for _, wl in level_shapes)), ints(*offsets))
    return (b, n, q, h, d, lv, p), table


def _pairs(flat: Sequence[int]):
    """``[h0, w0, h1, w1, ...]`` -> ``((h0, w0), (h1, w1), ...)``."""
    return tuple((int(flat[i]), int(flat[i + 1]))
                 for i in range(0, len(flat), 2))


def _flat(level_shapes: Sequence[Tuple[int, int]]):
    return [int(d) for shape in level_shapes for d in shape]


def _launch_forward(values: torch.Tensor, level_shapes: Sequence[int],
                    locations: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """The CUDA body of ``tpudet::ms_deform_attn_fwd`` (``level_shapes``
    flattened, ``[h0, w0, h1, w1, ...]``): checks and one launch."""
    global LAUNCHES
    level_shapes = _pairs(level_shapes)
    dims, table = _check(values, level_shapes, locations, weights,
                         "ms_deform_attn_cuda")
    b, n, q, h, d, lv, p = dims
    dev = values.device
    out = torch.empty((b, q, h, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()[0](
            values.data_ptr(), locations.data_ptr(), weights.data_ptr(),
            out.data_ptr(), b, n, q, h, d, lv, p, *table,
            _DTYPES[values.dtype], stream)
    if err != 0:
        raise RuntimeError(f"deformable attention kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out


def _launch_backward(values: torch.Tensor, level_shapes: Sequence[int],
                     locations: torch.Tensor, weights: torch.Tensor,
                     grad_out: torch.Tensor):
    """The CUDA body of ``tpudet::ms_deform_attn_bwd``: checks and one
    launch."""
    global BACKWARD_LAUNCHES
    level_shapes = _pairs(level_shapes)
    dims, table = _check(values, level_shapes, locations, weights,
                         "ms_deform_attn_backward_cuda")
    b, n, q, h, d, lv, p = dims
    if (grad_out.device != values.device or grad_out.dtype != torch.float32
            or grad_out.shape != (b, q, h, d) or not grad_out.is_contiguous()):
        raise ValueError(f"ms_deform_attn_backward_cuda needs a contiguous f32 "
                         f"cotangent [{b}, {q}, {h}, {d}] on the values' "
                         f"device, got {grad_out.dtype} "
                         f"{tuple(grad_out.shape)} on {grad_out.device}")
    dev = values.device
    grad_values = torch.zeros((b, n, h, d), dtype=torch.float32, device=dev)
    grad_loc = torch.empty_like(locations)
    grad_weights = torch.empty_like(weights)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()[1](
            values.data_ptr(), locations.data_ptr(), weights.data_ptr(),
            grad_out.data_ptr(), grad_values.data_ptr(), grad_loc.data_ptr(),
            grad_weights.data_ptr(), b, n, q, h, d, lv, p, *table,
            _DTYPES[values.dtype], stream)
    if err != 0:
        raise RuntimeError(f"deformable attention backward kernel launch "
                           f"failed: cudaError {err}")
    BACKWARD_LAUNCHES += 1
    return grad_values.to(values.dtype), grad_loc, grad_weights


def _fake_forward(values, level_shapes, locations, weights):
    b, q, h = locations.shape[:3]
    return values.new_empty((b, q, h, values.shape[-1]), dtype=torch.float32)


def _fake_backward(values, level_shapes, locations, weights, grad_out):
    return (torch.empty_like(values), torch.empty_like(locations),
            torch.empty_like(weights))


ms_deform_attn_fwd = _ops.register(
    "ms_deform_attn_fwd", "(Tensor values, int[] level_shapes, Tensor "
    "locations, Tensor weights) -> Tensor", _launch_forward, _fake_forward)
ms_deform_attn_bwd = _ops.register(
    "ms_deform_attn_bwd", "(Tensor values, int[] level_shapes, Tensor "
    "locations, Tensor weights, Tensor grad_out) -> (Tensor, Tensor, Tensor)",
    _launch_backward, _fake_backward)


def _require_cuda(values: torch.Tensor, name: str) -> None:
    if values.device.type != "cuda":
        raise ValueError(f"{name} needs all inputs on one CUDA device")


def ms_deform_attn_cuda(values: torch.Tensor,
                        level_shapes: Sequence[Tuple[int, int]],
                        locations: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """The forward kernel, through ``tpudet::ms_deform_attn_fwd``: ``values
    [B, N, H, D]`` (f32 or bf16), ``locations [B, Q, H, L, P, 2]`` f32,
    ``weights [B, Q, H, L, P]`` f32, all contiguous on one CUDA device ->
    ``[B, Q, H, D]`` f32. Any head count, head dim and number of samples per
    query."""
    _require_cuda(values, "ms_deform_attn_cuda")
    return ms_deform_attn_fwd(values, _flat(level_shapes), locations, weights)


def ms_deform_attn_backward_cuda(values: torch.Tensor,
                                 level_shapes: Sequence[Tuple[int, int]],
                                 locations: torch.Tensor,
                                 weights: torch.Tensor,
                                 grad_out: torch.Tensor):
    """The backward kernel, through ``tpudet::ms_deform_attn_bwd``: the
    forward's inputs and the f32 cotangent ``grad_out [B, Q, H, D]`` ->
    ``(d_values [B, N, H, D]`` in the values' dtype (summed in f32, cast
    once; f32 values are summed in place), ``d_locations``, ``d_weights)``
    f32 in the shapes of the inputs. Any head count, head dim and number of
    samples per query."""
    _require_cuda(values, "ms_deform_attn_backward_cuda")
    return ms_deform_attn_bwd(values, _flat(level_shapes), locations, weights,
                              grad_out)


class _MSDeformAttnCUDA(torch.autograd.Function):
    """The forward kernel, with the backward kernel for its gradients."""

    @staticmethod
    def forward(ctx, values, locations, weights, level_shapes):
        ctx.level_shapes = level_shapes
        ctx.save_for_backward(values, locations, weights)
        return ms_deform_attn_cuda(values, level_shapes, locations, weights)

    @staticmethod
    def backward(ctx, grad_out):
        values, locations, weights = ctx.saved_tensors
        grads = ms_deform_attn_backward_cuda(
            values, ctx.level_shapes, locations, weights,
            grad_out.to(torch.float32).contiguous())
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def ms_deform_attn(values: torch.Tensor,
                   level_shapes: Sequence[Tuple[int, int]],
                   locations: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Dispatch by device: CUDA -> the kernels through their ``tpudet::``
    operators (an autograd Function adds the backward one when autograd
    asks for gradients; under ``no_grad`` or ``inference_mode`` the forward
    operator alone), CPU -> the plain version (autograd runs through
    it)."""
    if values.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (values, locations, weights)):
            return _MSDeformAttnCUDA.apply(values, locations, weights,
                                           tuple(level_shapes))
        return ms_deform_attn_cuda(values, level_shapes, locations, weights)
    if values.device.type == "cpu":
        return ms_deform_attn_plain(values, level_shapes, locations, weights)
    raise ValueError(f"no deformable attention for device {values.device}")
