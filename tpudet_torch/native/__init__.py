"""Native (C++) host-side image front end, bound with ctypes
(``tpudet.native``).

The port's own copy of the JAX package's JPEG decode + resize + canvas pad
(``decoder.cpp``): one pass per image, threaded across a batch inside one
call that releases the GIL. It runs on the host, as the JAX package's does,
and gives the same bytes on the same host.

Builds lazily on first use with the JAX package's g++ flags (linking the
system libjpeg) into ``build/tpudet_torch_native/`` at the repository root,
keyed by the source hash and the host's CPU, and renamed into place, so
processes that build at once are safe. ``load_decoder()`` returns None
when g++ or libjpeg is missing; ``data.native_decode`` then raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "decoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpudet_torch_native"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _host_tag() -> str:
    """CPU identity folded into the file name: -march=native objects are
    ISA-specific, and a library built on a wider-ISA host would SIGILL
    here."""
    cpu = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first CPU's block; the rest repeat it
                if line.startswith(("model name", "flags", "CPU implementer",
                                    "CPU part", "Features")):
                    cpu += line
    except OSError:
        pass
    return hashlib.sha256((os.uname().machine + cpu).encode()).hexdigest()[:8]


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libtpudet_torch_decoder_{digest}_{_host_tag()}.so"


def build() -> Path:
    """The built library's path, building it first if it is missing; raises
    with the compiler's output where the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    # The JAX package's flags: a change of float contraction moves the
    # resize by a level.
    cmd = ["g++", "-O3", "-march=native", "-funroll-loops",
           "-ffp-contract=fast", "-shared", "-fPIC", "-std=c++17", "-pthread",
           str(_SRC), "-o", str(tmp), "-ljpeg"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("native decoder build failed: "
                               f"{' '.join(cmd)}\n{proc.stderr.strip()[-2000:]}")
        os.replace(tmp, out)  # atomic when processes build at once
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int)
    szp = ctypes.POINTER(ctypes.c_size_t)
    lib.tpudet_jpeg_dims.argtypes = [u8p, ctypes.c_size_t, i32p, i32p]
    lib.tpudet_jpeg_dims.restype = ctypes.c_int
    lib.tpudet_decode_jpeg.argtypes = [
        u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, i32p, i32p]
    lib.tpudet_decode_jpeg.restype = ctypes.c_int
    lib.tpudet_decode_resize_pad.argtypes = [
        u8p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, u8p, i32p, i32p, i32p, i32p]
    lib.tpudet_decode_resize_pad.restype = ctypes.c_int
    lib.tpudet_decode_batch.argtypes = [
        u8p, szp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p, i32p]
    lib.tpudet_decode_batch.restype = ctypes.c_int
    lib.tpudet_resize.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int]
    lib.tpudet_resize.restype = ctypes.c_int
    return lib


def load_decoder() -> Optional[ctypes.CDLL]:
    """Build (once) and load the native decoder; None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except (OSError, RuntimeError):
            # No g++ (FileNotFoundError is an OSError) or no libjpeg.
            _load_failed = True
    return _lib


def native_available() -> bool:
    return load_decoder() is not None
