"""Batched augmentation on whole uint8 NHWC batches: numpy, with the
native C++ fast path.

A copy of ``distributed_training_tpu/data/transforms.py``. The random
draws happen here, in the same order from the same ``RandomState``, and
the native library (``ops/native``, multithreaded C++) only moves memory,
so both paths give the same bytes, and the JAX package's: the uint8 →
float32 conversion rounds once (``x·scale + bias`` as a fused
multiply-add, as the native library computes it). ``use_native=None``
takes the native path when the library builds (:func:`native.available`).
"""

from __future__ import annotations

import numpy as np

from distributed_training_tpu_torch.ops.native import native


def _native(use_native: bool | None) -> bool:
    return native.available() if use_native is None else use_native


def pad_crop_flip(images: np.ndarray, rng: np.random.RandomState,
                  pad: int = 4, use_native: bool | None = None) -> np.ndarray:
    """Batched Pad(pad) → RandomCrop(original) → RandomHorizontalFlip."""
    n, h, w, c = images.shape
    ys = rng.randint(0, 2 * pad + 1, size=n)
    xs = rng.randint(0, 2 * pad + 1, size=n)
    flips = rng.rand(n) < 0.5
    if images.dtype == np.uint8 and _native(use_native):
        return native.pad_crop_flip(images, ys, xs, flips, pad)
    padded = np.pad(
        images, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="constant")
    windows = np.lib.stride_tricks.sliding_window_view(padded, (h, w), axis=(1, 2))
    crops = windows[np.arange(n), ys, xs]            # (n, c, h, w) view
    crops = np.moveaxis(crops, 1, -1)                # back to NHWC
    crops[flips] = crops[flips, :, ::-1]
    return np.ascontiguousarray(crops)


def u8_to_f32(images: np.ndarray, scale: float, bias: float,
              use_native: bool | None = None) -> np.ndarray:
    """``x·scale + bias`` with one rounding to float32. In numpy: the
    product of a uint8 and a float32 and its sum with a float32 bias are
    exact in float64, so rounding that once is the fused multiply-add's
    result."""
    if images.dtype == np.uint8 and _native(use_native):
        return native.u8_to_f32(images, scale, bias)
    exact = images.astype(np.float64) * np.float64(np.float32(scale))
    return (exact + np.float64(np.float32(bias))).astype(np.float32)


def to_float(images: np.ndarray) -> np.ndarray:
    """ToTensor: uint8 [0,255] → float32 [0,1] (layout stays NHWC)."""
    return u8_to_f32(images, 1.0 / 255.0, 0.0)


def to_normalized(images: np.ndarray) -> np.ndarray:
    """ToTensor + Normalize((0.5,)*3, (0.5,)*3) → [-1, 1], fused:
    x/255/0.5 - 1 = x·(2/255) - 1."""
    return u8_to_f32(images, 2.0 / 255.0, -1.0)


def apply_train_augment(images: np.ndarray, mode: str,
                        rng: np.random.RandomState) -> np.ndarray:
    if mode == "pad_crop_flip":
        return to_float(pad_crop_flip(images, rng))
    if mode == "normalize_only":
        return to_normalized(images)
    if mode == "none":
        return to_float(images)
    raise ValueError(f"unknown augment mode {mode!r}")


def apply_eval_transform(images: np.ndarray, mode: str) -> np.ndarray:
    if mode == "normalize_only":
        return to_normalized(images)
    return to_float(images)
