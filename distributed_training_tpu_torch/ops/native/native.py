"""ctypes binding of the native augment library (``augment.cpp``).

The port of ``distributed_training_tpu/ops/native/native.py``. The library
is built with ``g++`` at first use into the package's ``_build/``
directory (``libaugment-<hash>.so``, the hash of the source), never into
the source tree, and never at import. The flags are the JAX package's,
``-O3 -fPIC -shared -pthread -march=native``, retried without
``-march=native`` where the toolchain refuses it. ``ctypes.CDLL`` releases
the GIL during each call, so loader threads run it side by side.

:func:`available` keeps the JAX meaning: False when there is no compiler
(or the build fails), and the callers in ``data/`` then take their numpy
path, which gives the same bytes. Each wrapper counts its calls in
``<wrapper>.calls``, so a caller can show that the native path ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "augment.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")
FLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-march=native")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False
# The flags the loaded library was built with, and the compiler's output.
built_with: tuple[str, ...] = ()
build_log = ""


def _target() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha1(fh.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libaugment-{digest}.so")


def _build(out: str) -> bool:
    """Compile into ``out`` (atomically); False when no compiler builds it."""
    global built_with, build_log
    gxx = shutil.which("g++")
    if gxx is None:
        build_log = "g++ not found"
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    for flags in (FLAGS, tuple(f for f in FLAGS if f != "-march=native")):
        try:
            res = subprocess.run([gxx, *flags, "-o", tmp, _SRC],
                                 capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            build_log = str(e)
            return False
        build_log = res.stdout + res.stderr
        if res.returncode == 0:
            os.replace(tmp, out)
            built_with = flags
            return True
    return False


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built first if needed; None if unavailable."""
    global _lib, _build_failed, build_log
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        out = _target()
        if not os.path.exists(out) and not _build(out):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            build_log = str(e)
            _build_failed = True
            return None
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        lib.pad_crop_flip_u8.argtypes = [ptr, ptr, i64, i64, i64, i64, i64, ptr, ptr, ptr]
        lib.pad_crop_flip_u8.restype = None
        lib.gather_crop_flip_u8.argtypes = [ptr, ptr, ptr, i64, i64, i64, i64, i64, i64,
                                            ptr, ptr, ptr]
        lib.gather_crop_flip_u8.restype = None
        lib.u8_to_f32_affine.argtypes = [ptr, ptr, i64, ctypes.c_float, ctypes.c_float]
        lib.u8_to_f32_affine.restype = None
        _lib = lib
        return _lib


def _count(wrapper) -> None:
    """One more call of ``wrapper`` (loader threads call side by side)."""
    with _lock:
        wrapper.calls += 1


def available() -> bool:
    return get_lib() is not None


def _need() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"the native augment library is unavailable: {build_log}")
    return lib


def pad_crop_flip(images: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                  flips: np.ndarray, pad: int) -> np.ndarray:
    """Pad(pad) + crop at (ys, xs) + flip, per image of a uint8 NHWC batch;
    the numpy path's bytes (``data/transforms.py``)."""
    lib = _need()
    if images.dtype != np.uint8:
        raise ValueError(f"uint8 images expected, got {images.dtype}")
    images = np.ascontiguousarray(images)
    n, h, w, c = images.shape
    if not len(ys) == len(xs) == len(flips) == n:
        raise ValueError(f"{n} images, {len(ys)}/{len(xs)}/{len(flips)} draws")
    out = np.empty_like(images)
    # Converted arrays bound to names: the integer address alone would not
    # keep a converted copy alive through the call.
    ys = np.ascontiguousarray(ys, np.int32)
    xs = np.ascontiguousarray(xs, np.int32)
    flips = np.ascontiguousarray(flips, np.uint8)
    if n and (ys.min() < 0 or xs.min() < 0 or ys.max() > 2 * pad or xs.max() > 2 * pad):
        raise ValueError(f"crop offsets outside [0, {2 * pad}]")
    lib.pad_crop_flip_u8(images.ctypes.data, out.ctypes.data, n, h, w, c, pad,
                         ys.ctypes.data, xs.ctypes.data, flips.ctypes.data)
    _count(pad_crop_flip)
    return out


def gather_crop_flip(dataset: np.ndarray, lidx: np.ndarray, ys: np.ndarray,
                     xs: np.ndarray, flips: np.ndarray, size: int) -> np.ndarray:
    """Rows ``lidx`` of a ``[N, bh, bw, c]`` uint8 dataset, each cropped to
    ``size`` at (ys, xs) and flipped where ``flips``; reads a memmap in
    place, without copying the file."""
    lib = _need()
    if dataset.dtype != np.uint8 or not dataset.flags["C_CONTIGUOUS"]:
        raise ValueError("dataset must be C-contiguous uint8")
    total, bh, bw, c = dataset.shape
    n = len(lidx)
    lidx = np.ascontiguousarray(lidx, np.int64)
    ys = np.ascontiguousarray(ys, np.int32)
    xs = np.ascontiguousarray(xs, np.int32)
    flips = np.ascontiguousarray(flips, np.uint8)
    if not len(ys) == len(xs) == len(flips) == n:
        raise ValueError(f"{n} rows, {len(ys)}/{len(xs)}/{len(flips)} draws")
    if n and (lidx.min() < 0 or lidx.max() >= total or ys.min() < 0 or xs.min() < 0
              or ys.max() + size > bh or xs.max() + size > bw):
        raise ValueError("row index or crop window outside the dataset")
    out = np.empty((n, size, size, c), np.uint8)
    lib.gather_crop_flip_u8(dataset.ctypes.data, out.ctypes.data, lidx.ctypes.data,
                            n, bh, bw, size, size, c,
                            ys.ctypes.data, xs.ctypes.data, flips.ctypes.data)
    _count(gather_crop_flip)
    return out


def u8_to_f32(images: np.ndarray, scale: float, bias: float) -> np.ndarray:
    """uint8 → float32 ``x·scale + bias``, rounded once."""
    lib = _need()
    if images.dtype != np.uint8:
        raise ValueError(f"uint8 images expected, got {images.dtype}")
    images = np.ascontiguousarray(images)
    out = np.empty(images.shape, np.float32)
    lib.u8_to_f32_affine(images.ctypes.data, out.ctypes.data, images.size,
                         ctypes.c_float(scale), ctypes.c_float(bias))
    _count(u8_to_f32)
    return out


pad_crop_flip.calls = gather_crop_flip.calls = u8_to_f32.calls = 0
