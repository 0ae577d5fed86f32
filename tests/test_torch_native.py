"""The port's native augment library (``ops/native``) and the transforms
that call it, held against the port's numpy path and the JAX package's
``data/transforms.py``, bit for bit, on seeded uint8 batches.

The library is built with g++ into the package's ``_build/`` directory
(never the source tree). Where no compiler is found, ``available()`` is
False and the transforms take the numpy path, which gives the same bytes.
"""

import os

import numpy as np
import pytest

from distributed_training_tpu.data import transforms as jtransforms
from distributed_training_tpu.ops.native import native as jnative
from distributed_training_tpu_torch.data import transforms
from distributed_training_tpu_torch.ops.native import native

PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(native.__file__))))


def _images(n, h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3), dtype=np.uint8)


def test_library_builds_into_the_build_dir():
    assert native.available()
    target = native._target()
    assert os.path.dirname(target) == os.path.join(PKG, "_build")
    assert os.path.exists(target)
    src_dir = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]


@pytest.mark.parametrize("shape,pad", [((9, 32, 32), 4), ((5, 17, 23), 4), ((6, 11, 7), 3)])
def test_pad_crop_flip_native_numpy_jax_bitwise(shape, pad):
    images = _images(*shape)
    calls = native.pad_crop_flip.calls
    got = transforms.pad_crop_flip(images, np.random.RandomState(3), pad, use_native=True)
    assert native.pad_crop_flip.calls == calls + 1
    plain = transforms.pad_crop_flip(images, np.random.RandomState(3), pad, use_native=False)
    want = jtransforms.pad_crop_flip(images, np.random.RandomState(3), pad, use_native=False)
    assert got.dtype == plain.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)
    if jnative.available():
        np.testing.assert_array_equal(
            got, jtransforms.pad_crop_flip(images, np.random.RandomState(3), pad,
                                           use_native=True))


@pytest.mark.parametrize("mode", ["pad_crop_flip", "normalize_only", "none"])
def test_train_augment_native_numpy_jax_bitwise(mode, monkeypatch):
    """The float32 conversion rounds ``x·scale + bias`` once, on both of
    the port's paths and in the JAX package's native library."""
    images = _images(7, 32, 32, seed=1)
    got = transforms.apply_train_augment(images, mode, np.random.RandomState(5))
    evals = [transforms.apply_eval_transform(images, m) for m in (mode, "normalize_only")]
    if jnative.available():
        want = jtransforms.apply_train_augment(images, mode, np.random.RandomState(5))
        assert want.dtype == got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(native, "available", lambda: False)  # the numpy path
    np.testing.assert_array_equal(
        got, transforms.apply_train_augment(images, mode, np.random.RandomState(5)))
    for m, e in zip((mode, "normalize_only"), evals):
        np.testing.assert_array_equal(e, transforms.apply_eval_transform(images, m))


def test_u8_to_f32_every_byte_bitwise():
    every = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, axis=-1)
    for scale, bias in ((1 / 255, 0.0), (2 / 255, -1.0), (0.5, 0.25)):
        got = native.u8_to_f32(every, scale, bias)
        np.testing.assert_array_equal(got, transforms.u8_to_f32(every, scale, bias,
                                                                use_native=False))
        if jnative.available():
            np.testing.assert_array_equal(got, jnative.u8_to_f32(every, scale, bias))


@pytest.mark.parametrize("size,base", [(16, 18), (24, 28), (224, 257)])
def test_gather_crop_flip_matches_slicing(size, base):
    data = _images(12, base, base, seed=2)
    rng = np.random.RandomState(4)
    n = 10
    lidx = rng.randint(0, len(data), n)
    ys, xs = rng.randint(0, base - size + 1, n), rng.randint(0, base - size + 1, n)
    flips = rng.randint(0, 2, n)
    got = native.gather_crop_flip(data, lidx, ys, xs, flips, size)
    want = np.stack([data[i, y:y + size, x:x + size][:, ::-1 if f else 1]
                     for i, y, x, f in zip(lidx, ys, xs, flips)])
    np.testing.assert_array_equal(got, want)
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.gather_crop_flip(data, lidx, ys, xs, flips,
                                                                    size))


def test_wrappers_validate_their_inputs():
    images = _images(2, 8, 8)
    with pytest.raises(ValueError, match="uint8"):
        native.pad_crop_flip(images.astype(np.float32), [0, 0], [0, 0], [0, 0], 2)
    with pytest.raises(ValueError, match="outside"):
        native.pad_crop_flip(images, [0, 5], [0, 0], [0, 0], 2)
    with pytest.raises(ValueError, match="outside"):
        native.gather_crop_flip(images, [0, 2], [0, 0], [0, 0], [0, 0], 4)
    with pytest.raises(ValueError, match="outside"):
        native.gather_crop_flip(images, [0, 1], [0, 5], [0, 0], [0, 0], 4)
    with pytest.raises(ValueError, match="uint8"):
        native.u8_to_f32(images.astype(np.int32), 1.0, 0.0)
    # A float batch takes the numpy path, whatever use_native says.
    floats = images.astype(np.float32) / 255
    np.testing.assert_array_equal(
        transforms.pad_crop_flip(floats, np.random.RandomState(0), 2, use_native=True),
        jtransforms.pad_crop_flip(floats, np.random.RandomState(0), 2, use_native=False))


def test_without_a_compiler_the_numpy_path_runs(monkeypatch, tmp_path):
    """No g++: ``available()`` is False, and the transforms give the same
    bytes through numpy."""
    images = _images(6, 20, 20, seed=7)
    want = transforms.apply_train_augment(images, "pad_crop_flip", np.random.RandomState(1))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "_target", lambda: str(tmp_path / "libaugment-x.so"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    assert "g++ not found" in native.build_log
    got = transforms.apply_train_augment(images, "pad_crop_flip", np.random.RandomState(1))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError, match="unavailable"):
        native.u8_to_f32(images, 1.0, 0.0)
