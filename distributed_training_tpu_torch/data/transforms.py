"""Batched augmentation on whole uint8 NHWC batches, in numpy.

A numpy copy of ``distributed_training_tpu/data/transforms.py``: the
random draws happen in the same order from the same ``RandomState``, and
the uint8 → float32 conversion rounds once, as the JAX package's native
C++ library does (``x·scale + bias``, contracted to a fused multiply-add),
so the batches are bitwise identical to the JAX package's. That native
library itself is host code and is not ported yet.
"""

from __future__ import annotations

import numpy as np


def pad_crop_flip(images: np.ndarray, rng: np.random.RandomState,
                  pad: int = 4) -> np.ndarray:
    """Batched Pad(pad) → RandomCrop(original) → RandomHorizontalFlip."""
    n, h, w, c = images.shape
    ys = rng.randint(0, 2 * pad + 1, size=n)
    xs = rng.randint(0, 2 * pad + 1, size=n)
    flips = rng.rand(n) < 0.5
    padded = np.pad(
        images, ((0, 0), (pad, pad), (pad, pad), (0, 0)), mode="constant")
    windows = np.lib.stride_tricks.sliding_window_view(padded, (h, w), axis=(1, 2))
    crops = windows[np.arange(n), ys, xs]            # (n, c, h, w) view
    crops = np.moveaxis(crops, 1, -1)                # back to NHWC
    crops[flips] = crops[flips, :, ::-1]
    return np.ascontiguousarray(crops)


def u8_to_f32(images: np.ndarray, scale: float, bias: float) -> np.ndarray:
    """``x·scale + bias`` with one rounding to float32. The product of a
    uint8 and a float32 and its sum with a float32 bias are exact in
    float64, so rounding that once is the fused multiply-add's result."""
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
