"""RoI Align forward and backward: the Hopper kernels (``csrc/roi_align.cu``)
and their plain PyTorch version.

Replaces ``tpudet/kernels/roi_align.py::_roi_align_kernel`` (reached
through ``roi_align_pallas``). The TPU kernel keeps one image's feature map
in VMEM and fetches corner rows with aligned block loads plus a select,
because the TPU has no cheap gather; on Hopper the 4-corner gather is the
natural form. One launch pools all ``B x R`` RoIs, each with its image
index.

What bounds it on the H100, as measured: instructions and the corner rows
they request, not bytes. The first design (a block per RoI and output
row, a thread per channel) recomputed every sample's geometry, true
division included, in each of 17 M threads and loaded one 2-byte channel
per corner: 2.06 ms at voc_r50's b=32 shape against a 0.08 ms bytes
bound. The forward now runs a block per RoI: its threads compute the RoI's
S * r row and column sample axes once into shared memory, then each warp
pools an output row with 16 bytes of channels per lane (8 bf16 or 4 f32),
so one warp load takes a corner cell's 512-byte row. Lanes accumulate in
f32 in the plain version's order and store 16 bytes. A C that 16-byte
vectors do not divide, or a base that is not 16-byte aligned
(:func:`vectorized` decides), takes one channel per lane in the same
kernel. It then takes 0.36 ms at that shape on an H100 (4.5x the bound):
what remains is the 3.85 GB of corner-cell rows the samples read through
L1 and L2 (``PERF.md``).

The backward gives the features' gradient (boxes and image indices are
data, as the JAX package's proposals are). The TPU kernel has no VJP: the
JAX package trains through the einsum form's transpose. Here f32 atomics
sum each sample's share of the cotangent at its four corners in a
``[B, H, W, C]`` accumulator, cast once to the features' dtype. Its bound
is bytes (the cotangent read once, the gradient written once). The first
design (a block per RoI and output row, a thread per channel, the geometry
per thread and sample, four scalar atomics per sample) ran 0.30 ms at
voc_r50's train shape against a 0.0096 ms bound: 205.5 M atomics for 3.28 M
addresses. The backward now shares the forward's block per RoI and its
axes, and uses that the scatter is separable (a sample's weight on a cell
is its row weight times its column weight): a warp per touched feature row
and channel chunk sums the bin rows' cotangent by their weight on the row,
walks the column samples in order, and adds each touched cell once, with
one vector f32 atomic per 4 channels. The same C and alignment rule
(:func:`vectorized`) picks one channel per lane with scalar atomics. It
then takes 0.10 ms at that shape on an H100 (~11x the bound), bound by the
per-RoI flushes through L2 and the per-row instructions, not by
contention on shared cells (``PERF.md``).

``roi_align`` is the differentiable entry: on the card an autograd Function
runs the forward kernel and, for the gradient, the backward kernel; on the
CPU autograd runs through the plain version.

The launchers are the CUDA bodies of the operators
``tpudet::roi_align_fwd`` and ``tpudet::roi_align_bwd``
(``kernels/_ops.py``), so ``torch.export`` carries the kernels into a
serving artifact; training calls them through the autograd Function.
"""

from __future__ import annotations

import ctypes

import torch

from tpudet_torch.kernels import _build, _ops
# The plain version: the gather form in ``ops.roi_align``, batched.
from tpudet_torch.ops.roi_align import roi_align_batched as roi_align_plain

# Launches of the CUDA kernels, one per wrapper call on CUDA tensors.
LAUNCHES = 0
BACKWARD_LAUNCHES = 0

SOURCE = "tpudet_torch/kernels/csrc/roi_align.cu"
# The backward replaces the gradient of the same TPU kernel (it has none of
# its own).
REPLACES = "tpudet/kernels/roi_align.py:32"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["roi_align", "roi_align_cuda", "roi_align_backward_cuda",
           "roi_align_plain"]


def _lib():
    lib = _build.load("roi_align")
    fwd, bwd = lib.tpudet_roi_align_forward, lib.tpudet_roi_align_backward
    if fwd.argtypes is None:
        ptrs, ints = [ctypes.c_void_p] * 4, [ctypes.c_int]
        # ... K, H, W, C, S, R, dtype, vectorized, stream
        fwd.argtypes = bwd.argtypes = ptrs + ints * 8 + [ctypes.c_void_p]
        fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def vectorized(out: torch.Tensor, *maps: torch.Tensor) -> int:
    """1 where the kernels can take 16-byte channel vectors: C (the last
    dimension of ``out``, the forward's output or the backward's cotangent)
    a multiple of 16 bytes' channels of its dtype and every tensor starting
    16-byte aligned (a contiguous view with a storage offset may not); else
    0, one channel per lane."""
    per_vec = 16 // out.element_size()
    return int(out.shape[-1] % per_vec == 0
               and all(t.data_ptr() % 16 == 0 for t in (out, *maps)))


def _check_rois(boxes, image_index, dev, name):
    if boxes.device != dev or image_index.device != dev:
        raise ValueError(f"{name} needs all inputs on one CUDA device")
    if boxes.dtype != torch.float32 or image_index.dtype != torch.int32:
        raise TypeError(f"{name} takes f32 boxes and int32 image indices")
    if boxes.shape != (image_index.shape[0], 4):
        raise ValueError(f"bad RoI shapes {tuple(boxes.shape)}, "
                         f"{tuple(image_index.shape)}")
    if not (boxes.is_contiguous() and image_index.is_contiguous()):
        raise ValueError(f"{name} needs contiguous boxes and indices")


def _launch_forward(features: torch.Tensor, boxes: torch.Tensor,
                    image_index: torch.Tensor, output_size: int,
                    sampling_ratio: int) -> torch.Tensor:
    """The CUDA body of ``tpudet::roi_align_fwd``: checks and one launch."""
    global LAUNCHES
    dev = features.device
    if dev.type != "cuda":
        raise ValueError("roi_align_cuda needs all inputs on one CUDA device")
    if features.dtype not in _DTYPES:
        raise TypeError(f"roi_align_cuda takes f32 or bf16 features, got {features.dtype}")
    if features.dim() != 4 or not features.is_contiguous():
        raise ValueError(f"roi_align_cuda needs contiguous NHWC features, got "
                         f"{tuple(features.shape)}")
    _check_rois(boxes, image_index, dev, "roi_align_cuda")
    _, h, w, c = features.shape
    k = boxes.shape[0]
    s, r = output_size, sampling_ratio
    out = torch.empty((k, s, s, c), dtype=features.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()[0](features.data_ptr(), boxes.data_ptr(),
                        image_index.data_ptr(), out.data_ptr(),
                        k, h, w, c, s, r, _DTYPES[features.dtype],
                        vectorized(out, features), stream)
    if err != 0:
        raise RuntimeError(f"RoI Align kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def _launch_backward(grad_out: torch.Tensor, boxes: torch.Tensor,
                     image_index: torch.Tensor, feature_shape,
                     dtype: torch.dtype, sampling_ratio: int) -> torch.Tensor:
    """The CUDA body of ``tpudet::roi_align_bwd``: checks and one launch."""
    global BACKWARD_LAUNCHES
    dev = grad_out.device
    if dev.type != "cuda":
        raise ValueError("roi_align_backward_cuda needs all inputs on one "
                         "CUDA device")
    if grad_out.dtype not in _DTYPES or dtype not in _DTYPES:
        raise TypeError(f"roi_align_backward_cuda takes f32 or bf16, got "
                        f"{grad_out.dtype} -> {dtype}")
    _check_rois(boxes, image_index, dev, "roi_align_backward_cuda")
    b, h, w, c = feature_shape
    k = boxes.shape[0]
    s = grad_out.shape[1] if grad_out.dim() == 4 else 0
    if grad_out.shape != (k, s, s, c) or not grad_out.is_contiguous():
        raise ValueError(f"roi_align_backward_cuda needs a contiguous "
                         f"cotangent [{k}, S, S, {c}], got "
                         f"{tuple(grad_out.shape)}")
    grad = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib()[1](grad_out.data_ptr(), boxes.data_ptr(),
                        image_index.data_ptr(), grad.data_ptr(),
                        k, h, w, c, s, sampling_ratio,
                        _DTYPES[grad_out.dtype], vectorized(grad_out, grad),
                        stream)
    if err != 0:
        raise RuntimeError(f"RoI Align backward kernel launch failed: "
                           f"cudaError {err}")
    BACKWARD_LAUNCHES += 1
    return grad.to(dtype)


def _fake_forward(features, boxes, image_index, output_size,
                  sampling_ratio):
    return features.new_empty((boxes.shape[0], output_size, output_size,
                               features.shape[-1]))


def _fake_backward(grad_out, boxes, image_index, feature_shape, dtype,
                   sampling_ratio):
    return grad_out.new_empty(feature_shape, dtype=dtype)


roi_align_fwd = _ops.register(
    "roi_align_fwd", "(Tensor features, Tensor boxes, Tensor image_index, "
    "int output_size, int sampling_ratio) -> Tensor", _launch_forward,
    _fake_forward)
roi_align_bwd = _ops.register(
    "roi_align_bwd", "(Tensor grad_out, Tensor boxes, Tensor image_index, "
    "int[] feature_shape, ScalarType dtype, int sampling_ratio) -> Tensor",
    _launch_backward, _fake_backward)


def _require_cuda(tensor: torch.Tensor, name: str) -> None:
    if tensor.device.type != "cuda":
        raise ValueError(f"{name} needs all inputs on one CUDA device")


def roi_align_cuda(features: torch.Tensor, boxes: torch.Tensor,
                   image_index: torch.Tensor, output_size: int,
                   sampling_ratio: int = 2) -> torch.Tensor:
    """The kernel, through ``tpudet::roi_align_fwd``: ``[B, H, W, C]``
    features (f32 or bf16), ``[K, 4]`` f32 boxes in feature coordinates,
    ``[K]`` int32 image indices -> ``[K, S, S, C]`` in the features'
    dtype."""
    _require_cuda(features, "roi_align_cuda")
    return roi_align_fwd(features, boxes, image_index, output_size,
                         sampling_ratio)


def roi_align_backward_cuda(grad_out: torch.Tensor, boxes: torch.Tensor,
                            image_index: torch.Tensor, feature_shape,
                            dtype: torch.dtype,
                            sampling_ratio: int = 2) -> torch.Tensor:
    """The backward kernel, through ``tpudet::roi_align_bwd``: the
    cotangent ``[K, S, S, C]`` (f32 or bf16) of :func:`roi_align_cuda` on
    ``[B, H, W, C]`` = ``feature_shape`` features and the same boxes and
    indices -> the features' gradient in ``dtype``, summed in f32 and cast
    once."""
    _require_cuda(grad_out, "roi_align_backward_cuda")
    return roi_align_bwd(grad_out, boxes, image_index,
                         [int(d) for d in feature_shape], dtype,
                         sampling_ratio)


class _RoIAlignCUDA(torch.autograd.Function):
    """The forward kernel, with the backward kernel for the features'
    gradient."""

    @staticmethod
    def forward(ctx, features, boxes, image_index, output_size,
                sampling_ratio):
        ctx.feature_shape = tuple(features.shape)
        ctx.dtype = features.dtype
        ctx.sampling_ratio = sampling_ratio
        ctx.save_for_backward(boxes, image_index)
        return roi_align_cuda(features, boxes, image_index, output_size,
                              sampling_ratio)

    @staticmethod
    def backward(ctx, grad_out):
        boxes, image_index = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[0]:
            grad = roi_align_backward_cuda(
                grad_out.contiguous(), boxes, image_index, ctx.feature_shape,
                ctx.dtype, ctx.sampling_ratio)
        return grad, None, None, None, None


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              image_index: torch.Tensor, output_size: int,
              sampling_ratio: int = 2) -> torch.Tensor:
    """Dispatch by device: CUDA -> the kernels through their ``tpudet::``
    operators (an autograd Function adds the backward one when autograd
    asks for the features' gradient), CPU -> the plain version (autograd
    runs through it)."""
    if features.device.type == "cuda":
        if torch.is_grad_enabled() and features.requires_grad:
            return _RoIAlignCUDA.apply(features, boxes, image_index,
                                       output_size, sampling_ratio)
        return roi_align_cuda(features, boxes, image_index, output_size,
                              sampling_ratio)
    if features.device.type == "cpu":
        return roi_align_plain(features, boxes, image_index, output_size,
                               sampling_ratio)
    raise ValueError(f"no RoI Align for device {features.device}")
