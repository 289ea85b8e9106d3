"""FPN RoI Align, each RoI pooled once at its own level: the Hopper kernel
(``csrc/roi_align_window.cu``) and its plain PyTorch version.

Replaces ``tpudet/kernels/roi_align_window.py::_kernel`` (reached through
``roi_align_window_pallas`` and ``roi_align_window_pallas_batched``). The
TPU kernel cuts a ``window x window`` tile around each RoI out of its level
with one DMA and contracts it on the matrix unit, because the TPU cannot
gather; the window only bounds where a RoI's samples may fall. On Hopper
the 4-corner gather is the natural form: one launch pools all ``B x N``
RoIs, each reading its own level map through a small by-value table of
(pointer, H, W, stride).

What bounds it on the H100, as measured: instructions and the corner rows
they request, not bytes. The first design (a block per RoI and output
row, a thread per channel doing the level lookup, ``box / stride`` and
every sample's geometry) ran 2.13 ms at coco_r101_fpn's b=32 832x832 shape
against a 0.15 ms bytes bound. It now shares the RoI Align forward's
design (``kernels/roi_align.py``): a block per RoI looks up the level,
divides the box by its stride and computes the sample axes once into
shared memory; each warp pools an output row with 16 bytes of channels per
lane, one channel per lane where 16-byte vectors do not fit the maps.
It then takes 0.39 ms at that shape on an H100 (2.7x the bound), most of
it the corner-cell rows the samples read through L1 and L2.

The backward gives each level map's gradient (boxes and levels get none,
as the JAX package's ``roi_align_window_train`` gives them zeros). It is
not a TPU kernel: the JAX package transposes its per-level masked sum with
``jax.linear_transpose`` (``tpudet/ops/roi_align.py:629``). Here one launch
scatters every RoI at its level with the RoI Align backward's design
(``kernels/roi_align.py``): a block per RoI, its axes once, a warp per
touched feature row and channel chunk that adds each touched cell once
with vector f32 atomics. The accumulators of all levels are one flat f32
buffer, so the dense passes around the kernel are one zero pass and, for
bf16 maps, one cast pass; they move more bytes than the kernel's own work:
at coco_r101_fpn's b=8 832x832 train shape in bf16 the kernel takes 0.16
ms on an H100 and the passes 0.38 ms, against a 0.078 ms bound
(``PERF.md``).

``roi_align_window`` is the differentiable entry: on the card an autograd
Function runs the forward kernel and, for the maps' gradient, the backward
kernel; on the CPU autograd runs through the plain version.

The launchers are the CUDA bodies of the operators
``tpudet::roi_align_window_fwd`` and ``tpudet::roi_align_window_bwd``
(``kernels/_ops.py``), so ``torch.export`` carries the kernels into a
serving artifact; training calls them through the autograd Function.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from tpudet_torch.kernels import _build, _ops
from tpudet_torch.kernels.roi_align import vectorized
# The plain version: per-level gather form, in ``ops.roi_align``.
from tpudet_torch.ops.roi_align import roi_align_levels as roi_align_window_plain

# Launches of the CUDA kernels, one per wrapper call on CUDA tensors.
LAUNCHES = 0
BACKWARD_LAUNCHES = 0

SOURCE = "tpudet_torch/kernels/csrc/roi_align_window.cu"
REPLACES = "tpudet/kernels/roi_align_window.py:109"
# The backward replaces the gradient the JAX package takes of the same
# function (``pool_bwd`` of ``roi_align_window_train_batched``).
BACKWARD_REPLACES = "tpudet/ops/roi_align.py:629"

MAX_LEVELS = 4  # kMaxLevels of the CUDA source
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["roi_align_window", "roi_align_window_cuda",
           "roi_align_window_backward_cuda", "roi_align_window_plain"]


def _lib():
    lib = _build.load("roi_align_window")
    fwd = lib.tpudet_roi_align_window_forward
    bwd = lib.tpudet_roi_align_window_backward
    if fwd.argtypes is None:
        # The level table, then three pointers, B, N, C, S, R, dtype,
        # vectorized and the stream.
        fwd.argtypes = bwd.argtypes = (
            [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
             ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
             ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
            + [ctypes.c_void_p])
        fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _level_table(maps: Sequence[torch.Tensor], strides: Sequence[float]):
    """The C entry points' level arguments: pointers, heights, widths,
    strides and the count."""
    count = len(maps)
    return ((ctypes.c_void_p * count)(*(m.data_ptr() for m in maps)),
            (ctypes.c_int * count)(*(m.shape[1] for m in maps)),
            (ctypes.c_int * count)(*(m.shape[2] for m in maps)),
            (ctypes.c_float * count)(*(float(st) for st in strides)), count)


def _check_rois(boxes, levels, dev, name):
    """``[B, N, 4]`` f32 boxes and ``[B, N]`` int32 levels, contiguous, on
    ``dev`` -> (B, N)."""
    if boxes.device != dev or levels.device != dev:
        raise ValueError(f"{name} needs all inputs on one CUDA device")
    if boxes.dtype != torch.float32 or levels.dtype != torch.int32:
        raise TypeError(f"{name} takes f32 boxes and int32 levels")
    if levels.dim() != 2 or boxes.shape != levels.shape + (4,):
        raise ValueError(f"bad RoI shapes {tuple(boxes.shape)}, "
                         f"{tuple(levels.shape)}")
    if not (boxes.is_contiguous() and levels.is_contiguous()):
        raise ValueError(f"{name} needs contiguous boxes and levels")
    return levels.shape


def _launch_forward(features: Sequence[torch.Tensor],
                    strides: Sequence[float], boxes: torch.Tensor,
                    levels: torch.Tensor, output_size: int,
                    sampling_ratio: int) -> torch.Tensor:
    """The CUDA body of ``tpudet::roi_align_window_fwd``: checks and one
    launch."""
    global LAUNCHES
    dev = boxes.device
    if dev.type != "cuda" or levels.device != dev or any(
            f.device != dev for f in features):
        raise ValueError("roi_align_window_cuda needs all inputs on one CUDA "
                         "device")
    if not 1 <= len(features) <= MAX_LEVELS or len(strides) != len(features):
        raise ValueError(f"roi_align_window_cuda takes 1..{MAX_LEVELS} levels "
                         f"with one stride each, got {len(features)} maps and "
                         f"{len(strides)} strides")
    dtype = features[0].dtype
    if dtype not in _DTYPES or any(f.dtype != dtype for f in features):
        raise TypeError("roi_align_window_cuda takes f32 or bf16 maps of one "
                        f"dtype, got {[f.dtype for f in features]}")
    b, n = _check_rois(boxes, levels, dev, "roi_align_window_cuda")
    c = features[0].shape[-1]
    if any(f.dim() != 4 or f.shape[0] != b or f.shape[3] != c
           for f in features):
        raise ValueError(f"bad FPN RoI Align shapes "
                         f"{[tuple(f.shape) for f in features]}, "
                         f"{tuple(boxes.shape)}, {tuple(levels.shape)}")
    if not all(f.is_contiguous() for f in features):
        raise ValueError("roi_align_window_cuda needs contiguous NHWC maps")
    s, r = output_size, sampling_ratio
    out = torch.empty((b, n, s, s, c), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()[0](
            *_level_table(features, strides), boxes.data_ptr(),
            levels.data_ptr(), out.data_ptr(), b, n, c, s, r, _DTYPES[dtype],
            vectorized(out, *features), stream)
    if err != 0:
        raise RuntimeError(f"FPN RoI Align kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def scatter_backward(grad_out: torch.Tensor, boxes: torch.Tensor,
                     levels: torch.Tensor, grads: Sequence[torch.Tensor],
                     strides: Sequence[float],
                     sampling_ratio: int = 2) -> None:
    """The backward kernel alone: adds the gradient of
    :func:`roi_align_window_cuda` for the cotangent ``[B, N, S, S, C]`` (f32
    or bf16) into ``grads``, f32 ``[B, H_l, W_l, C]`` accumulators."""
    global BACKWARD_LAUNCHES
    dev = grad_out.device
    if dev.type != "cuda" or any(g.device != dev for g in grads):
        raise ValueError("the FPN RoI Align backward needs all inputs on one "
                         "CUDA device")
    if not 1 <= len(grads) <= MAX_LEVELS or len(strides) != len(grads):
        raise ValueError(f"the FPN RoI Align backward takes 1..{MAX_LEVELS} "
                         f"levels with one stride each, got {len(grads)} "
                         f"maps and {len(strides)} strides")
    if grad_out.dtype not in _DTYPES:
        raise TypeError(f"the FPN RoI Align backward takes an f32 or bf16 "
                        f"cotangent, got {grad_out.dtype}")
    b, n = _check_rois(boxes, levels, dev, "the FPN RoI Align backward")
    s = grad_out.shape[2] if grad_out.dim() == 5 else 0
    c = grad_out.shape[-1]
    if grad_out.shape != (b, n, s, s, c) or not grad_out.is_contiguous():
        raise ValueError(f"the FPN RoI Align backward needs a contiguous "
                         f"cotangent [{b}, {n}, S, S, C], got "
                         f"{tuple(grad_out.shape)}")
    if any(g.dtype != torch.float32 or g.dim() != 4 or g.shape[0] != b
           or g.shape[3] != c or not g.is_contiguous() for g in grads):
        raise ValueError(f"the FPN RoI Align backward needs contiguous f32 "
                         f"[{b}, H, W, {c}] accumulators, got "
                         f"{[(tuple(g.shape), g.dtype) for g in grads]}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()[1](
            *_level_table(grads, strides), grad_out.data_ptr(),
            boxes.data_ptr(), levels.data_ptr(), b, n, c, s, sampling_ratio,
            _DTYPES[grad_out.dtype], vectorized(grad_out, *grads), stream)
    if err != 0:
        raise RuntimeError(f"FPN RoI Align backward kernel launch failed: "
                           f"cudaError {err}")
    BACKWARD_LAUNCHES += 1


def _launch_backward(grad_out: torch.Tensor, boxes: torch.Tensor,
                     levels: torch.Tensor, feature_shapes: Sequence[int],
                     strides: Sequence[float], dtype: torch.dtype,
                     sampling_ratio: int) -> torch.Tensor:
    """The CUDA body of ``tpudet::roi_align_window_bwd``: the levels'
    gradients, ``feature_shapes`` flattened 4 numbers a level, as one flat
    buffer in ``dtype`` (the levels one after another). The f32 sums are
    views of one flat buffer: one zero pass, and one cast pass for bf16."""
    if dtype not in _DTYPES:
        raise TypeError(f"the FPN RoI Align backward gives f32 or bf16, got "
                        f"{dtype}")
    shapes = _unflatten_shapes(feature_shapes)
    flat = torch.zeros(sum(_sizes(shapes)), dtype=torch.float32,
                       device=grad_out.device)
    scatter_backward(grad_out, boxes, levels, _views(flat, shapes), strides,
                     sampling_ratio)
    return flat.to(dtype)


def _unflatten_shapes(flat: Sequence[int]):
    return [tuple(flat[i:i + 4]) for i in range(0, len(flat), 4)]


def _sizes(shapes):
    return [int(torch.Size(shape).numel()) for shape in shapes]


def _views(buffer: torch.Tensor, shapes):
    return [part.view(shape) for part, shape in
            zip(torch.split(buffer, _sizes(shapes)), shapes)]


def _fake_forward(features, strides, boxes, levels, output_size,
                  sampling_ratio):
    b, n = levels.shape
    return features[0].new_empty((b, n, output_size, output_size,
                                  features[0].shape[-1]))


def _fake_backward(grad_out, boxes, levels, feature_shapes, strides, dtype,
                   sampling_ratio):
    size = sum(_sizes(_unflatten_shapes(feature_shapes)))
    return grad_out.new_empty((size,), dtype=dtype)


roi_align_window_fwd = _ops.register(
    "roi_align_window_fwd", "(Tensor[] features, float[] strides, Tensor "
    "boxes, Tensor levels, int output_size, int sampling_ratio) -> Tensor",
    _launch_forward, _fake_forward)
roi_align_window_bwd = _ops.register(
    "roi_align_window_bwd", "(Tensor grad_out, Tensor boxes, Tensor levels, "
    "int[] feature_shapes, float[] strides, ScalarType dtype, "
    "int sampling_ratio) -> Tensor", _launch_backward, _fake_backward)


def roi_align_window_cuda(features: Sequence[torch.Tensor],
                          strides: Sequence[float], boxes: torch.Tensor,
                          levels: torch.Tensor, output_size: int,
                          sampling_ratio: int = 2) -> torch.Tensor:
    """The kernel, through ``tpudet::roi_align_window_fwd``: ``[B, H_l, W_l,
    C]`` NHWC maps (f32 or bf16, one dtype), their strides, ``[B, N, 4]`` f32
    image-pixel boxes and ``[B, N]`` int32 0-based levels -> ``[B, N, S, S,
    C]`` in the features' dtype."""
    if boxes.device.type != "cuda":
        raise ValueError("roi_align_window_cuda needs all inputs on one CUDA "
                         "device")
    return roi_align_window_fwd(list(features), [float(st) for st in strides],
                                boxes, levels, output_size, sampling_ratio)


def roi_align_window_backward_cuda(grad_out: torch.Tensor,
                                   boxes: torch.Tensor, levels: torch.Tensor,
                                   feature_shapes, strides: Sequence[float],
                                   dtype: torch.dtype,
                                   sampling_ratio: int = 2):
    """The gradient of :func:`roi_align_window_cuda` on maps of
    ``feature_shapes`` (``[B, H_l, W_l, C]`` each) for the cotangent
    ``[B, N, S, S, C]``, through ``tpudet::roi_align_window_bwd`` -> one
    gradient per map in ``dtype``, summed in f32 and cast once (views of
    the operator's one flat output)."""
    if grad_out.device.type != "cuda":
        raise ValueError("the FPN RoI Align backward needs all inputs on one "
                         "CUDA device")
    shapes = [tuple(int(d) for d in shape) for shape in feature_shapes]
    flat = roi_align_window_bwd(
        grad_out, boxes, levels, [d for shape in shapes for d in shape],
        [float(st) for st in strides], dtype, sampling_ratio)
    return _views(flat, shapes)


class _RoIAlignWindowCUDA(torch.autograd.Function):
    """The forward kernel, with the backward kernel for the maps' gradient.
    Saves the boxes, levels, shapes and strides, no feature values."""

    @staticmethod
    def forward(ctx, boxes, levels, strides, output_size, sampling_ratio,
                *features):
        ctx.save_for_backward(boxes, levels)
        ctx.feature_shapes = [tuple(f.shape) for f in features]
        ctx.dtype = features[0].dtype
        ctx.strides = strides
        ctx.sampling_ratio = sampling_ratio
        return roi_align_window_cuda(features, strides, boxes, levels,
                                     output_size, sampling_ratio)

    @staticmethod
    def backward(ctx, grad_out):
        boxes, levels = ctx.saved_tensors
        grads = [None] * len(ctx.feature_shapes)
        if any(ctx.needs_input_grad[5:]):
            grads = roi_align_window_backward_cuda(
                grad_out.contiguous(), boxes, levels, ctx.feature_shapes,
                ctx.strides, ctx.dtype, ctx.sampling_ratio)
        return (None, None, None, None, None, *grads)


def roi_align_window(features: Sequence[torch.Tensor],
                     strides: Sequence[float], boxes: torch.Tensor,
                     levels: torch.Tensor, output_size: int,
                     sampling_ratio: int = 2) -> torch.Tensor:
    """Dispatch by device: CUDA -> the kernels through their ``tpudet::``
    operators (an autograd Function adds the backward one when autograd
    asks for the maps' gradient), CPU -> the plain version (autograd runs
    through it)."""
    if boxes.device.type == "cuda":
        if torch.is_grad_enabled() and any(f.requires_grad for f in features):
            return _RoIAlignWindowCUDA.apply(boxes, levels, tuple(strides),
                                             output_size, sampling_ratio,
                                             *features)
        return roi_align_window_cuda(features, strides, boxes, levels,
                                     output_size, sampling_ratio)
    if boxes.device.type == "cpu":
        # The boxes are data on both devices (the kernels give them no
        # gradient, tpudet's VJP gives them zeros).
        return roi_align_window_plain(features, strides, boxes.detach(),
                                      levels, output_size, sampling_ratio)
    raise ValueError(f"no FPN RoI Align for device {boxes.device}")
