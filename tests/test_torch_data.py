"""The port's data path against the JAX package's, bitwise: the same
seeds give the same arrays and the same batches (order, augmentation,
padding mask, resume skips)."""

import warnings

import numpy as np
import pytest
import torch

from distributed_training_tpu.config import DataConfig as JData
from distributed_training_tpu.config import TrainConfig as JTrain
from distributed_training_tpu.data import cifar10 as jcifar
from distributed_training_tpu.data import pipeline as jpipe
from distributed_training_tpu.data.synthetic import synthetic_imagenet as jimagenet
from distributed_training_tpu_torch.config import DataConfig, TrainConfig
from distributed_training_tpu_torch.data import cifar10, pipeline
from distributed_training_tpu_torch.data.synthetic import synthetic_imagenet


def _equal_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("fn", ["synthetic_cifar10", "synthetic_cifar10_hard"])
def test_synthetic_arrays_are_bitwise_equal(fn, train):
    for seed in (0, 3):
        a = getattr(jcifar, fn)(257, train, seed)
        b = getattr(cifar10, fn)(257, train, seed)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_synthetic_imagenet_is_bitwise_equal():
    for x, y in zip(jimagenet(9, 40, 100, 5), synthetic_imagenet(9, 40, 100, 5)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("on_disk", [False, True])
def test_load_cifar10_is_bitwise_equal(tmp_path, on_disk):
    if on_disk:  # the binary layout, 5 train batches of 7 records each
        d = tmp_path / "cifar-10-batches-bin"
        d.mkdir()
        rng = np.random.RandomState(0)
        for f in [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]:
            rng.randint(0, 256, (7, 3073)).astype(np.uint8).tofile(d / f)
    for train in (True, False):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            a = jcifar.load_cifar10(str(tmp_path), train, synthetic_size=33)
            b = cifar10.load_cifar10(str(tmp_path), train, synthetic_size=33)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    if not on_disk:
        with pytest.raises(FileNotFoundError):
            cifar10.load_cifar10(str(tmp_path), synthetic_ok=False)


def _loaders(**kw):
    x, y = cifar10.synthetic_cifar10(203, True, 1)
    common = dict(global_batch_size=16, seed=7, process_index=kw.pop("rank", 0),
                  process_count=kw.pop("world", 1), **kw)
    return (jpipe.ShardedDataLoader(x, y, **common),
            pipeline.ShardedDataLoader(x, y, **common))


@pytest.mark.parametrize("augment", ["pad_crop_flip", "normalize_only", "none"])
@pytest.mark.parametrize("epoch", [0, 2])
def test_train_batches_bitwise_equal(augment, epoch):
    j, t = _loaders(augment=augment, max_steps=5)
    j.set_epoch(epoch)
    t.set_epoch(epoch)
    assert len(j) == len(t) == 5
    _equal_batches(j, t)


def test_eval_batches_with_ragged_mask_bitwise_equal():
    j, t = _loaders(shuffle=False, drop_last=False, train=False,
                    augment="pad_crop_flip")
    assert len(t) == 13
    _equal_batches(j, t)
    last = list(t)[-1]
    assert last["mask"].sum() == 203 - 12 * 16


@pytest.mark.parametrize("rank", [0, 1])
def test_process_shards_bitwise_equal(rank):
    j, t = _loaders(rank=rank, world=2, augment="pad_crop_flip")
    _equal_batches(j, t)


def test_skip_batches_bitwise_equal_and_refuses_overrun():
    j, t = _loaders(augment="pad_crop_flip", max_steps=6)
    j.set_epoch(1)
    t.set_epoch(1)
    _equal_batches(jpipe.SkipBatches(j, 4), pipeline.SkipBatches(t, 4))
    assert len(pipeline.SkipBatches(t, 4)) == 2
    with pytest.raises(ValueError, match="cannot resume"):
        pipeline.SkipBatches(t, 6)


def test_build_dataloaders_bitwise_equal():
    jcfg = JTrain(data=JData(dataset="synthetic_cifar", batch_size=8,
                             max_steps_per_epoch=3))
    tcfg = TrainConfig(data=DataConfig(dataset="synthetic_cifar", batch_size=8,
                                       max_steps_per_epoch=3))
    jt, je = jpipe.build_dataloaders(jcfg, seed=2, global_batch_size=16,
                                     eval_global_batch_size=8)
    tt, te = pipeline.build_dataloaders(tcfg, seed=2, global_batch_size=16,
                                        eval_global_batch_size=8)
    _equal_batches(jt, tt)
    _equal_batches(je, te)


def test_to_device_on_cpu_keeps_values():
    j, t = _loaders(augment="none", max_steps=1)
    batch = next(iter(t))
    dev = pipeline.to_device(batch, torch.device("cpu"))
    for k in batch:
        np.testing.assert_array_equal(dev[k].numpy(), batch[k])


def test_unported_datasets_raise():
    cfg = TrainConfig(data=DataConfig(dataset="imagefolder", data_path="/x"))
    with pytest.raises(NotImplementedError):
        pipeline.build_dataloaders(cfg)
