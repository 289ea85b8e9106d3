"""NumPy front over the native (C++) image front end
(``tpudet.data.native_decode``).

These helpers repeat the host half of ``preprocess.prepare_example`` (the
same ``resize_scale`` rounding, the same top-left canvas placement) so that
the loader can swap the PIL path for the native one per example. They work
on host numpy arrays and raise RuntimeError where the native library is
unavailable (``tpudet_torch.native.native_available()``).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from tpudet_torch.native import load_decoder

_u8p = ctypes.POINTER(ctypes.c_uint8)


class NativeDecodeError(ValueError):
    """A JPEG the native decoder cannot handle (corrupt data, or a colour
    space libjpeg will not convert, e.g. CMYK/YCCK). Callers may fall back
    to PIL for these; other ValueErrors are the caller's and propagate."""


def _lib():
    lib = load_decoder()
    if lib is None:
        raise RuntimeError("native decoder unavailable (g++/libjpeg missing)")
    return lib


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(_u8p)


def _bytes_ptr(data: bytes):
    return ctypes.cast(ctypes.c_char_p(data), _u8p)


def jpeg_dims(data: bytes) -> Tuple[int, int]:
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = _lib().tpudet_jpeg_dims(
        _bytes_ptr(data), len(data), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise NativeDecodeError("corrupt JPEG header")
    return h.value, w.value


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> RGB uint8 [h, w, 3]."""
    h, w = jpeg_dims(data)
    out = np.empty((h, w, 3), np.uint8)
    oh, ow = ctypes.c_int(), ctypes.c_int()
    rc = _lib().tpudet_decode_jpeg(
        _bytes_ptr(data), len(data), _as_u8p(out), out.nbytes,
        ctypes.byref(oh), ctypes.byref(ow))
    if rc != 0:
        raise NativeDecodeError("corrupt JPEG")
    return out


def resize(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """PIL-convention antialiased bilinear resize of an RGB uint8 array, in
    floating point (within 2 levels of PIL's fixed point)."""
    image = np.ascontiguousarray(image, np.uint8)
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = _lib().tpudet_resize(
        _as_u8p(image), image.shape[0], image.shape[1], _as_u8p(out),
        out_h, out_w)
    if rc != 0:
        raise ValueError("bad resize args")
    return out


def decode_resize_pad(data: bytes, min_size: int, max_size: int,
                      canvas_h: int, canvas_w: int,
                      fast_dct_scale: bool = True):
    """Fused decode -> resize -> pad. Returns (canvas, (nh, nw), (oh, ow))."""
    canvas = np.zeros((canvas_h, canvas_w, 3), np.uint8)
    nh, nw = ctypes.c_int(), ctypes.c_int()
    oh, ow = ctypes.c_int(), ctypes.c_int()
    rc = _lib().tpudet_decode_resize_pad(
        _bytes_ptr(data), len(data), min_size, max_size, canvas_h, canvas_w,
        int(fast_dct_scale), _as_u8p(canvas),
        ctypes.byref(nh), ctypes.byref(nw), ctypes.byref(oh), ctypes.byref(ow))
    if rc != 0:
        raise NativeDecodeError("corrupt JPEG")
    return canvas, (nh.value, nw.value), (oh.value, ow.value)


def decode_batch(jpegs: List[bytes], min_size: int, max_size: int,
                 canvas_h: int, canvas_w: int, fast_dct_scale: bool = True,
                 num_threads: int = 8):
    """The fused front end for a whole batch in one native call (the GIL is
    released throughout). Returns (canvases [n, ch, cw, 3], sizes [n, 4] =
    (nh, nw, oh, ow) per image, the number of failures); a failed image's
    sizes are 0."""
    n = len(jpegs)
    blob = b"".join(jpegs)
    offsets = np.zeros(n + 1, np.uintp)
    np.cumsum([len(j) for j in jpegs], out=offsets[1:])
    canvases = np.zeros((n, canvas_h, canvas_w, 3), np.uint8)
    sizes = np.zeros((n, 4), np.int32)
    failures = _lib().tpudet_decode_batch(
        _bytes_ptr(blob),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_size_t)),
        n, min_size, max_size, canvas_h, canvas_w, int(fast_dct_scale),
        num_threads, _as_u8p(canvases),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return canvases, sizes, failures

