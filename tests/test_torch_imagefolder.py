"""The port's imagefolder loader against the JAX package's, bit for bit,
on a tiny PIL-written tree (two classes, JPEGs and a PNG of odd sizes, a
grey JPEG, a file that is not an image): the scan, the decoded batches
(random crop and flip in training, centre crop in eval, normalize_only),
``iter_from``'s resume, the ragged last eval batch's mask, and two
process slices put together against one process. Also the decode's
retry policy (the JAX package's delays and counter) and the Pillow
check."""

import sys

import numpy as np
import pytest

from distributed_training_tpu.data import imagefolder as jfolder
from distributed_training_tpu.resilience import retry as jretry
from distributed_training_tpu_torch.data import imagefolder
from distributed_training_tpu_torch.resilience import retry
from torch_image_tree import write_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("tree"))


def _equal_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k])


def _pair(paths, labels, **kw):
    kw.setdefault("process_index", 0)
    kw.setdefault("process_count", 1)
    return (jfolder.ImageFolderLoader(paths, labels, **kw),
            imagefolder.ImageFolderLoader(paths, labels, **kw))


def test_scan_equals_jax(tree):
    for split in ("train", "val"):
        got = imagefolder.scan_imagefolder(f"{tree}/{split}")
        want = jfolder.scan_imagefolder(f"{tree}/{split}")
        assert got[0] == want[0] and got[2] == want[2] == ["cat", "dog"]
        np.testing.assert_array_equal(got[1], want[1])
        assert not any(p.endswith(".txt") for p in got[0])
    with pytest.raises(FileNotFoundError):
        imagefolder.scan_imagefolder(f"{tree}/nowhere")


@pytest.mark.parametrize("train,augment,size", [
    (True, "pad_crop_flip", 16), (False, "pad_crop_flip", 16),
    (True, "normalize_only", 12), (False, "none", 20)])
def test_batches_equal_jax_over_epochs(tree, train, augment, size):
    paths, labels, _ = imagefolder.scan_imagefolder(f"{tree}/train")
    j, t = _pair(paths, labels, global_batch_size=4, image_size=size, train=train,
                 augment=augment, shuffle=train, drop_last=train, seed=3, num_workers=3)
    for epoch in (0, 1):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        batches = list(t)
        assert batches[0]["image"].shape == (4, size, size, 3)
        assert batches[0]["image"].dtype == np.float32
        _equal_batches(j, batches)


def test_iter_from_resumes_as_jax(tree):
    paths, labels, _ = imagefolder.scan_imagefolder(f"{tree}/train")
    j, t = _pair(paths, labels, global_batch_size=2, image_size=16, seed=1, num_workers=2)
    for loader in (j, t):
        loader.set_epoch(2)
    _equal_batches(j.iter_from(3), t.iter_from(3))
    _equal_batches(list(t)[3:], t.iter_from(3))


def test_ragged_eval_batch_has_a_mask(tree):
    paths, labels, _ = imagefolder.scan_imagefolder(f"{tree}/val")
    j, t = _pair(paths, labels, global_batch_size=4, image_size=16, train=False,
                 shuffle=False, drop_last=False)
    batches = list(t)
    assert len(batches) == 2 and batches[-1]["mask"].tolist() == [1, 1, 0, 0]
    _equal_batches(j, batches)


def test_two_process_slices_make_the_one_process_batch(tree):
    paths, labels, _ = imagefolder.scan_imagefolder(f"{tree}/train")
    kw = dict(global_batch_size=4, image_size=16, seed=5, num_workers=2)
    whole = list(imagefolder.ImageFolderLoader(paths, labels, **kw))
    halves = [list(imagefolder.ImageFolderLoader(paths, labels, process_index=i,
                                                 process_count=2, **kw)) for i in (0, 1)]
    jhalves = [list(jfolder.ImageFolderLoader(paths, labels, process_index=i,
                                              process_count=2, **kw)) for i in (0, 1)]
    for i in (0, 1):
        _equal_batches(jhalves[i], halves[i])
    for b, h0, h1 in zip(whole, *halves):
        for k in b:
            np.testing.assert_array_equal(b[k], np.concatenate([h0[k], h1[k]]))


def test_decode_retries_transient_faults(tree, monkeypatch):
    path = imagefolder.scan_imagefolder(f"{tree}/train")[0][0]
    real, fails = imagefolder._decode_once, [2]

    def flaky(*a):
        if fails[0]:
            fails[0] -= 1
            raise OSError("transient read fault")
        return real(*a)

    monkeypatch.setattr(imagefolder, "_decode_once", flaky)
    monkeypatch.setattr(imagefolder, "_DECODE_RETRY",
                        retry.RetryPolicy(max_attempts=3, sleep=lambda s: None))
    retry.reset_retries()
    got = imagefolder._decode(path, 16, True, 7)
    assert retry.total_retries() == 2
    np.testing.assert_array_equal(got, jfolder._decode_once(path, 16, True, 7))
    fails[0] = 3
    with pytest.raises(OSError):
        imagefolder._decode(path, 16, True, 7)
    monkeypatch.setattr(imagefolder, "_decode_once",
                        lambda *a: (_ for _ in ()).throw(ValueError("structural")))
    retry.reset_retries()
    with pytest.raises(ValueError):
        imagefolder._decode(path, 16, True, 7)
    assert retry.total_retries() == 0


@pytest.mark.parametrize("kw", [{}, dict(max_attempts=5, base_delay_s=0.3, multiplier=3.0,
                                         max_delay_s=1.0), dict(max_attempts=1)])
def test_retry_policy_delays_are_the_jax_packages(kw):
    assert list(retry.RetryPolicy(**kw).delays()) == list(jretry.RetryPolicy(**kw).delays())
    for bad in (dict(max_attempts=0), dict(base_delay_s=-1), dict(multiplier=0.5)):
        with pytest.raises(ValueError):
            retry.RetryPolicy(**bad)


def test_decode_without_pillow_names_it(monkeypatch, tree):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        imagefolder.pillow()
    with pytest.raises(ImportError, match="Pillow"):
        imagefolder._decode_once(f"{tree}/train/cat/im00.JPEG", 16, False, 0)
