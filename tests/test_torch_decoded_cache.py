"""The port's decoded cache against the JAX package's, on a tiny PIL-written
tree: the three files byte for byte, each package opening the other's
cache, the batches bit for bit (training crops and flips, eval centre
crops, worker threads, ``iter_from``, two process slices), the idempotent
rebuild and its fingerprint, the numpy path without the native library,
and ``build_dataloaders`` building the imagefolder and cached loaders."""

import filecmp
import os

import numpy as np
import pytest

from distributed_training_tpu.config import DataConfig as JData
from distributed_training_tpu.config import TrainConfig as JTrain
from distributed_training_tpu.data import decoded_cache as jcache
from distributed_training_tpu.data import pipeline as jpipe
from distributed_training_tpu_torch.config import DataConfig, TrainConfig
from distributed_training_tpu_torch.data import decoded_cache, imagefolder, pipeline
from distributed_training_tpu_torch.ops.native import native
from torch_image_tree import write_tree

SUFFIXES = (".npy", ".labels.npy", ".meta.json")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("tree"))


@pytest.fixture(scope="module")
def caches(tree, tmp_path_factory):
    """The same split cached by each package."""
    d = tmp_path_factory.mktemp("caches")
    paths, labels, _ = imagefolder.scan_imagefolder(f"{tree}/train")
    port = decoded_cache.build_decoded_cache(paths, labels, str(d / "port" / "train_16"),
                                             image_size=16, num_workers=3)
    jax = jcache.build_decoded_cache(paths, labels, str(d / "jax" / "train_16"),
                                     image_size=16, num_workers=3)
    return port, jax


def _equal_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k])


def test_cache_files_are_byte_equal(caches):
    port, jax = caches
    for suffix in SUFFIXES:
        assert filecmp.cmp(port + suffix, jax + suffix, shallow=False), suffix
    images = np.load(port + ".npy", mmap_mode="r")
    assert images.shape == (14, 18, 18, 3) and images.dtype == np.uint8


@pytest.mark.parametrize("train,workers", [(True, 0), (True, 2), (False, 0), (False, 3)])
def test_each_package_reads_the_others_cache(caches, train, workers):
    """Each package's loader on each package's cache gives the port's
    batches on its own cache, over two epochs."""
    port, jax = caches
    kw = dict(global_batch_size=4, train=train, shuffle=train, drop_last=train, seed=2,
              process_index=0, process_count=1, num_workers=workers)
    for epoch in (0, 1):
        loaders = [make(cache, **kw) for make in (decoded_cache.DecodedCacheLoader,
                                                  jcache.DecodedCacheLoader)
                   for cache in (port, jax)]
        for ld in loaders:
            ld.set_epoch(epoch)
        want = list(loaders[0])
        assert want[0]["image"].dtype == np.uint8 and want[0]["image"].shape == (4, 16, 16, 3)
        for ld in loaders[1:]:
            _equal_batches(ld, want)


def test_iter_from_and_process_slices(caches):
    port, jax = caches
    kw = dict(global_batch_size=4, seed=4)
    t = decoded_cache.DecodedCacheLoader(port, **kw)
    j = jcache.DecodedCacheLoader(jax, process_index=0, process_count=1, **kw)
    _equal_batches(j.iter_from(1), t.iter_from(1))
    # Each slice draws its own crops (the augment stream is seeded by the
    # process index, as in the JAX package); the examples are the slices
    # of the one-process batch.
    whole = list(decoded_cache.DecodedCacheLoader(port, train=False, shuffle=True, **kw))
    halves = [list(decoded_cache.DecodedCacheLoader(port, train=False, shuffle=True,
                                                    process_index=i, process_count=2, **kw))
              for i in (0, 1)]
    for i in (0, 1):
        _equal_batches(jcache.DecodedCacheLoader(jax, train=False, shuffle=True, process_index=i,
                                                 process_count=2, **kw), halves[i])
    for b, h0, h1 in zip(whole, *halves):
        for k in b:
            np.testing.assert_array_equal(b[k], np.concatenate([h0[k], h1[k]]))


def test_without_the_native_library_the_bytes_are_the_same(caches, monkeypatch):
    port, _ = caches
    kw = dict(global_batch_size=4, seed=6)
    want = list(decoded_cache.DecodedCacheLoader(port, **kw))
    calls = native.gather_crop_flip.calls
    monkeypatch.setattr(native, "available", lambda: False)
    _equal_batches(decoded_cache.DecodedCacheLoader(port, **kw), want)
    assert native.gather_crop_flip.calls == calls


def test_rebuild_is_idempotent_and_fingerprinted(tree, tmp_path):
    paths, labels, _ = imagefolder.scan_imagefolder(f"{tree}/val")
    cache = str(tmp_path / "val_16")
    decoded_cache.build_decoded_cache(paths, labels, cache, image_size=16)
    stamp = os.stat(cache + ".npy").st_mtime_ns
    decoded_cache.build_decoded_cache(paths, labels, cache, image_size=16)
    assert os.stat(cache + ".npy").st_mtime_ns == stamp  # kept as it was
    assert (decoded_cache.fingerprint(paths, labels)
            != decoded_cache.fingerprint(paths, labels[::-1]))
    decoded_cache.build_decoded_cache(paths, labels[::-1].copy(), cache, image_size=16)
    np.testing.assert_array_equal(np.load(cache + ".labels.npy"), labels[::-1])
    with pytest.raises(ValueError, match="exceeds cached base"):
        decoded_cache.DecodedCacheLoader(cache, global_batch_size=2, image_size=20)


def _cfgs(tree, **data):
    common = dict(dataset="imagefolder", data_path=tree, num_classes=2, image_size=16,
                  batch_size=4, num_workers=2, **data)
    return JTrain(data=JData(**common)), TrainConfig(data=DataConfig(**common))


@pytest.mark.parametrize("cached", [False, True], ids=["imagefolder", "decoded_cache"])
def test_build_dataloaders_builds_imagefolder_and_cached_loaders(tree, cached):
    jcfg, tcfg = _cfgs(tree, decoded_cache=cached)
    train, evals = pipeline.build_dataloaders(tcfg, seed=1, global_batch_size=4,
                                              eval_global_batch_size=4)
    kind = (decoded_cache.DecodedCacheLoader if cached else imagefolder.ImageFolderLoader)
    assert isinstance(train, kind) and isinstance(evals, kind)
    if cached:
        assert os.path.exists(os.path.join(tree, ".decoded_cache", "train_16.meta.json"))
    jtrain, jevals = jpipe.build_dataloaders(jcfg, seed=1, global_batch_size=4,
                                             eval_global_batch_size=4)
    _equal_batches(jtrain, train)
    _equal_batches(jevals, evals)


def test_build_dataloaders_checks_the_tree(tree, tmp_path):
    _, cfg = _cfgs(tree)
    with pytest.raises(ValueError, match="num_classes"):
        pipeline.build_dataloaders(cfg.replace(data=DataConfig(
            dataset="imagefolder", data_path=tree, num_classes=3)))
    with pytest.raises(ValueError, match="requires data_path"):
        pipeline.build_dataloaders(cfg.replace(data=DataConfig(dataset="imagefolder")))
    other = write_tree(tmp_path / "other", 1, 1)
    os.rename(os.path.join(other, "val", "dog"), os.path.join(other, "val", "fox"))
    with pytest.raises(ValueError, match="class mismatch"):
        pipeline.build_dataloaders(cfg.replace(data=DataConfig(
            dataset="imagefolder", data_path=other, num_classes=2)))
