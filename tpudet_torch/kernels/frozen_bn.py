"""Frozen batch norm, an optional residual add and the ReLU in one pass:
the Hopper kernels (``csrc/frozen_bn.cu``) and their plain PyTorch version.

Replaces no TPU kernel. On the TPU, XLA fuses ``relu(norm(x) [+ r])`` into
its neighbours; PyTorch runs it as a broadcast multiply and add per norm
(on its generic, non-vectorized kernel), seven tiny launches that form
the per-channel affine, the residual add and the ReLU, each pass a read
and a write of the map. The forward kernel reads the norm's four f32
buffers, forms ``w`` and ``b`` per channel with ``FrozenBatchNorm.forward``'s
f32 ops, and writes ``relu(bf(bf(x * w) + b) (+) r)`` in one pass, where
``bf`` is the rounding to the map's dtype that the plain ops apply after
each op and the residual ``r`` is absent, an identity map, or a projection
``bf(bf(s * w_s) + b_s)`` normed in the same pass. The backward kernel
writes the input's gradient (and the residual's) in one pass from the
upstream gradient and the saved output. Both equal the plain ops bit for
bit.

What bounds it on the H100: bytes (a few flops an element). 16-byte vector
loads and stores over channels-last maps (the layout of every ResNet map in
the port); a thread keeps one channel group over its grid-stride loop, so
its ``w`` and ``b`` stay in registers.

``frozen_bn_act`` is the entry, and the one place that picks the path: on
the card, for ``FrozenBatchNorm`` norms, an autograd Function runs the
forward kernel and, for the gradients, the backward kernel; on any other
device or for any other norm the plain layers run and autograd runs
through them. The launchers are the
CUDA bodies of ``tpudet::frozen_bn_act_fwd`` and ``tpudet::frozen_bn_act_bwd``
(``kernels/_ops.py``), so ``torch.export`` carries the kernel into a
serving artifact.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpudet_torch.kernels import _build, _ops

# Launches of the CUDA kernels, one per wrapper call on CUDA tensors.
LAUNCHES = 0
BACKWARD_LAUNCHES = 0

SOURCE = "tpudet_torch/kernels/csrc/frozen_bn.cu"
# No TPU kernel: XLA fuses the chain there.
REPLACES = None

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["frozen_bn_act", "frozen_bn_act_plain", "frozen_bn_act_fwd",
           "frozen_bn_act_bwd"]


def _lib():
    lib = _build.load("frozen_bn")
    fwd, bwd = lib.tpudet_frozen_bn_forward, lib.tpudet_frozen_bn_backward
    if fwd.argtypes is None:
        p, f = ctypes.c_void_p, ctypes.c_float
        # ... rows, channels, form, dtype, stream
        tail = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                p]
        fwd.argtypes = [p] * 7 + [f] + [p] * 4 + [f] + tail
        bwd.argtypes = [p] * 6 + [f] + [p] * 2 + [f] + tail
        fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def frozen_bn_act_plain(x: torch.Tensor, norm: nn.Module,
                        shortcut: Optional[torch.Tensor] = None,
                        shortcut_norm: Optional[nn.Module] = None
                        ) -> torch.Tensor:
    """``relu(norm(x) + r)`` with ``r`` absent (no ``shortcut``), the
    ``shortcut`` itself, or ``shortcut_norm(shortcut)``: the layers one by
    one, for any norm module."""
    y = norm(x)
    if shortcut is not None:
        y = y + (shortcut if shortcut_norm is None
                 else shortcut_norm(shortcut))
    return F.relu(y)


def _check_layout(x: torch.Tensor, name: str) -> None:
    """Raises unless ``x`` is a 4-d channels-last map of a channel count
    that 16-byte vectors divide."""
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} takes a 4-d channels-last map, got shape "
                         f"{tuple(x.shape)}, strides {x.stride()}")
    per_vec = 16 // x.element_size()
    if x.shape[1] % per_vec:
        raise ValueError(f"{name} takes a multiple of {per_vec} channels, "
                         f"got {x.shape[1]}")


def _check_like(t: torch.Tensor, x: torch.Tensor, what: str,
                name: str) -> None:
    if (t.device != x.device or t.dtype != x.dtype or t.shape != x.shape
            or not t.is_contiguous(memory_format=torch.channels_last)
            or t.data_ptr() % 16):
        raise ValueError(f"{name}: the {what} must match the map in device, "
                         f"dtype, shape and layout, 16-byte aligned")


def _check_buffers(buffers: Sequence[torch.Tensor], x: torch.Tensor,
                   name: str) -> None:
    for b in buffers:
        if (b.device != x.device or b.dtype != torch.float32
                or b.shape != (x.shape[1],) or not b.is_contiguous()):
            raise ValueError(f"{name} takes contiguous f32 norm buffers of "
                             f"{x.shape[1]} channels on the map's device")


def _check_map(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs all inputs on one CUDA device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes f32 or bf16 maps, got {x.dtype}")
    _check_layout(x, name)
    if x.data_ptr() % 16:
        raise ValueError(f"{name} needs a 16-byte aligned map")


def _form(residual: bool, proj: Sequence[torch.Tensor], count: int,
          name: str) -> int:
    """The kernels' form: 0 no residual, 1 identity, 2 projected."""
    if len(proj) not in (0, count) or (proj and not residual):
        raise ValueError(f"{name}: the projection's norm takes {count} "
                         f"buffers and a residual input")
    return 2 if proj else int(residual)


def _geometry(x: torch.Tensor):
    """-> (rows N * H * W, channels) of the channels-last map."""
    n, c, h, w = x.shape
    return n * h * w, c


def _launch_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    mean: torch.Tensor, var: torch.Tensor, eps: float,
                    residual: Optional[torch.Tensor],
                    proj: List[torch.Tensor], proj_eps: float
                    ) -> torch.Tensor:
    """The CUDA body of ``tpudet::frozen_bn_act_fwd``: checks and one
    launch."""
    global LAUNCHES
    name = "frozen_bn_act_fwd"
    _check_map(x, name)
    form = _form(residual is not None, proj, 4, name)
    _check_buffers([scale, bias, mean, var, *proj], x, name)
    if residual is not None:
        _check_like(residual, x, "residual", name)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib()[0](
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            out.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), var.data_ptr(), eps,
            *([t.data_ptr() for t in proj] or [None] * 4), proj_eps,
            *_geometry(x), form, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"frozen batch norm kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return out


def _launch_backward(grad: torch.Tensor, out: torch.Tensor,
                     scale: torch.Tensor, var: torch.Tensor, eps: float,
                     residual: bool, proj: List[torch.Tensor],
                     proj_eps: float):
    """The CUDA body of ``tpudet::frozen_bn_act_bwd``: checks and one
    launch -> (the input's gradient, the residual's: the identity's or the
    projection input's, empty without a residual)."""
    global BACKWARD_LAUNCHES
    name = "frozen_bn_act_bwd"
    _check_map(out, name)
    form = _form(residual, proj, 2, name)
    _check_like(grad, out, "gradient", name)
    _check_buffers([scale, var, *proj], out, name)
    gx = torch.empty_like(out)
    g2 = torch.empty_like(out) if form else out.new_empty(0)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = _lib()[1](
            grad.data_ptr(), out.data_ptr(), gx.data_ptr(),
            g2.data_ptr() if form else None, scale.data_ptr(),
            var.data_ptr(), eps,
            *([t.data_ptr() for t in proj] or [None] * 2), proj_eps,
            *_geometry(out), form, _DTYPES[out.dtype], stream)
    if err != 0:
        raise RuntimeError(f"frozen batch norm backward kernel launch "
                           f"failed: cudaError {err}")
    BACKWARD_LAUNCHES += 1
    return gx, g2


# The fake bodies take any layout: under torch.export's fake tensors a
# convolution of a channels-last map reports NCHW strides, where on the card
# it gives channels-last, which the CUDA bodies check.
def _fake_forward(x, scale, bias, mean, var, eps, residual, proj, proj_eps):
    return torch.empty_like(x)


def _fake_backward(grad, out, scale, var, eps, residual, proj, proj_eps):
    return (torch.empty_like(out),
            torch.empty_like(out) if residual else out.new_empty(0))


frozen_bn_act_fwd = _ops.register(
    "frozen_bn_act_fwd", "(Tensor x, Tensor scale, Tensor bias, Tensor mean, "
    "Tensor var, float eps, Tensor? residual, Tensor[] proj, float proj_eps)"
    " -> Tensor", _launch_forward, _fake_forward)
frozen_bn_act_bwd = _ops.register(
    "frozen_bn_act_bwd", "(Tensor grad, Tensor out, Tensor scale, Tensor var, "
    "float eps, bool residual, Tensor[] proj, float proj_eps) -> "
    "(Tensor, Tensor)", _launch_backward, _fake_backward)


class _FrozenBNActCUDA(torch.autograd.Function):
    """The forward kernel, with the backward kernel for the gradients of
    the map and of the residual input."""

    @staticmethod
    def forward(ctx, x, residual, scale, bias, mean, var, eps, proj,
                proj_eps):
        out = frozen_bn_act_fwd(x, scale, bias, mean, var, eps, residual,
                                proj, proj_eps)
        ctx.eps, ctx.proj_eps = eps, proj_eps
        ctx.residual = residual is not None
        ctx.save_for_backward(out, scale, var,
                              *([proj[0], proj[3]] if proj else []))
        return out

    @staticmethod
    def backward(ctx, grad):
        out, scale, var, *proj = ctx.saved_tensors
        grad = grad.contiguous(memory_format=torch.channels_last)
        gx, g2 = frozen_bn_act_bwd(grad, out, scale, var, ctx.eps,
                                   ctx.residual, proj, ctx.proj_eps)
        return (gx if ctx.needs_input_grad[0] else None,
                g2 if ctx.residual and ctx.needs_input_grad[1] else None,
                None, None, None, None, None, None, None)


def _buffers(norm: nn.Module) -> List[torch.Tensor]:
    return [norm.scale, norm.bias, norm.mean, norm.var]


def frozen_bn_act(x: torch.Tensor, norm: nn.Module,
                  shortcut: Optional[torch.Tensor] = None,
                  shortcut_norm: Optional[nn.Module] = None) -> torch.Tensor:
    """``relu(norm(x) + r)``, ``r`` absent (no ``shortcut``), the
    ``shortcut`` map itself, or ``shortcut_norm(shortcut)``. On a CUDA map
    with ``FrozenBatchNorm`` norms: one pass of the kernel through
    ``tpudet::frozen_bn_act_fwd`` (an autograd Function adds the backward
    kernel when autograd asks for a gradient). On any other device or for
    any other norm: :func:`frozen_bn_act_plain`."""
    # Imported here: tpudet_torch.models imports this module.
    from tpudet_torch.models.layers import FrozenBatchNorm

    if (x.device.type != "cuda" or not isinstance(norm, FrozenBatchNorm)
            or not isinstance(shortcut_norm, (FrozenBatchNorm, type(None)))):
        return frozen_bn_act_plain(x, norm, shortcut, shortcut_norm)
    proj = [] if shortcut_norm is None else _buffers(shortcut_norm)
    proj_eps = 0.0 if shortcut_norm is None else shortcut_norm.epsilon
    args = (*_buffers(norm), norm.epsilon)
    if torch.is_grad_enabled() and (
            x.requires_grad
            or (shortcut is not None and shortcut.requires_grad)):
        return _FrozenBNActCUDA.apply(x, shortcut, *args, proj, proj_eps)
    return frozen_bn_act_fwd(x, *args, shortcut, proj, proj_eps)
