"""Pre-decoded image cache: decode the JPEGs once, train at memory speed.

The port of ``distributed_training_tpu/data/decoded_cache.py``, file for
file, so a cache built by either package opens in the other:

- **Build once** (:func:`build_decoded_cache`): every image is decoded on
  threads, its short side resized to ``base = round(1.15 · size)`` and
  centre-cropped to ``base × base`` uint8, written into one memory-mapped
  ``<path>.npy`` ``[N, base, base, 3]``, beside ``<path>.labels.npy``
  (int32) and ``<path>.meta.json`` (count, base, image_size and a sha256
  fingerprint of the (file name, label, byte size) sequence). A cache
  whose meta matches is kept as it is.
- **Train from it** (:class:`DecodedCacheLoader`): each batch is
  gathered out of the memmap and cropped and flipped from the cached
  square by the native ``gather_crop_flip`` (``ops/native``; a numpy loop
  where the library does not build, with the same bytes).

The cache keeps only the centre ``base × base`` square, so crops near the
long edges of a very non-square image are not available (the usual trade
of fixed-size records), and a centre crop may sit one pixel off the live
loader's when both gaps are odd.
"""

from __future__ import annotations

import hashlib
import json
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from distributed_training_tpu_torch.data.imagefolder import pillow
from distributed_training_tpu_torch.data.pipeline import ShardedBatchIndexer
from distributed_training_tpu_torch.ops.native import native


def _base_size(image_size: int) -> int:
    return int(round(image_size * 1.15))


def _decode_base(path: str, base: int) -> np.ndarray:
    """The cached form of one image: short side → ``base``, centre crop
    ``base × base``, uint8."""
    Image = pillow()
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        scale = base / min(w, h)
        im = im.resize((max(base, int(round(w * scale))),
                        max(base, int(round(h * scale)))), Image.BILINEAR)
        w, h = im.size
        x0, y0 = (w - base) // 2, (h - base) // 2
        im = im.crop((x0, y0, x0 + base, y0 + base))
        return np.asarray(im, np.uint8)


def fingerprint(paths: Sequence[str], labels) -> str:
    """sha256 of the (file name, label, byte size) sequence: a renamed,
    relabelled, reordered or re-encoded tree of the same length does not
    open a stale cache (size rather than mtime: a copy keeps the size)."""
    digest = hashlib.sha256()
    for p, l in zip(paths, np.asarray(labels).tolist()):
        try:
            sig = os.stat(p).st_size
        except OSError:
            sig = "?"
        digest.update(f"{os.path.basename(p)}:{l}:{sig}\n".encode())
    return digest.hexdigest()


def build_decoded_cache(
    paths: Sequence[str],
    labels: np.ndarray,
    cache_path: str,
    *,
    image_size: int = 224,
    num_workers: int = 8,
    progress_every: int = 0,
) -> str:
    """Decode ``paths`` into the three files at ``cache_path`` (see the
    module docstring) and return ``cache_path``. Kept as it is when its
    meta matches (count, base size, fingerprint). Under a process group,
    build inside ``Coordinator.priority_execution`` so rank 0 writes
    first."""
    base = _base_size(image_size)
    fp = fingerprint(paths, labels)
    meta_path = cache_path + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
        if (meta.get("count") == len(paths) and meta.get("base") == base
                and meta.get("fingerprint") == fp):
            return cache_path
    os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
    arr = np.lib.format.open_memmap(
        cache_path + ".npy", mode="w+", dtype=np.uint8,
        shape=(len(paths), base, base, 3))

    def work(i):
        arr[i] = _decode_base(paths[i], base)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"[decoded_cache] {i + 1}/{len(paths)}")

    with ThreadPoolExecutor(max(1, num_workers)) as pool:
        list(pool.map(work, range(len(paths))))
    arr.flush()
    del arr
    np.save(cache_path + ".labels.npy", np.asarray(labels, np.int32))
    with open(meta_path, "w") as fh:
        json.dump({"count": len(paths), "base": base,
                   "image_size": image_size, "fingerprint": fp}, fh)
    return cache_path


class DecodedCacheLoader(ShardedBatchIndexer):
    """Sharded loader over a decoded cache.

    The shard and shuffle of :class:`ImageFolderLoader` (``set_epoch``
    reseeds, ``iter_from`` skips at the index level), yielding numpy
    ``{'image': uint8 [NHWC] 0–255, 'label': i32[N]}`` (+ ``mask`` when
    ``drop_last=False``): the ``/255`` and the normalize_only affine are
    left to the device (``train/step.py::_input_images``), so the host
    only crops and flips and the copy to the card is a quarter of the
    float32 one. ``num_workers > 0`` assembles batches on that many
    threads, up to ``2 · num_workers`` ahead, in order; every random draw
    is made in order on the consumer's side, so the worker count never
    changes the batches.
    """

    def __init__(
        self,
        cache_path: str,
        *,
        global_batch_size: int,
        image_size: int | None = None,
        shuffle: bool = True,
        drop_last: bool = True,
        train: bool = True,
        augment: str = "pad_crop_flip",
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        max_steps: int | None = None,
        microbatches: int = 1,
        num_workers: int = 0,
    ):
        with open(cache_path + ".meta.json") as fh:
            meta = json.load(fh)
        self.images = np.load(cache_path + ".npy", mmap_mode="r")
        self.labels = np.load(cache_path + ".labels.npy")
        self.base = int(meta["base"])
        self.image_size = int(image_size or meta["image_size"])
        if self.image_size > self.base:
            raise ValueError(
                f"image_size {self.image_size} exceeds cached base "
                f"{self.base}; rebuild the cache for this size")
        if augment not in ("pad_crop_flip", "normalize_only", "none"):
            raise ValueError(f"unknown augment mode {augment!r}")
        self.augment = augment
        self.train = train
        self.num_workers = int(num_workers)
        super().__init__(
            len(self.labels), global_batch_size=global_batch_size,
            shuffle=shuffle, drop_last=drop_last, seed=seed,
            process_index=process_index, process_count=process_count,
            max_steps=max_steps, microbatches=microbatches)

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def _assemble(self, lidx, pad, xs, ys, flips) -> dict:
        """Gather, crop and flip one batch (the native call releases the
        GIL)."""
        size = self.image_size
        n = len(lidx)
        if native.available():
            out = native.gather_crop_flip(self.images, lidx, ys, xs, flips, size)
        else:
            gathered = self.images[lidx]
            out = np.empty((n, size, size, 3), np.uint8)
            for j in range(n):
                crop = gathered[j, ys[j]:ys[j] + size, xs[j]:xs[j] + size]
                if flips[j]:
                    crop = crop[:, ::-1]
                out[j] = crop
        labels = self.labels[lidx].astype(np.int32)
        mask = np.ones(n, np.float32)
        if pad:
            out = np.concatenate(
                [out, np.zeros((pad, size, size, 3), np.uint8)])
            labels = np.concatenate([labels, np.zeros(pad, np.int32)])
            mask = np.concatenate([mask, np.zeros(pad, np.float32)])
        batch = {"image": out, "label": labels}
        if not self.drop_last:
            batch["mask"] = mask
        return batch

    def _batch_args(self, start_step: int) -> Iterator[tuple]:
        """``(lidx, pad, xs, ys, flips)`` per batch, every draw made here
        in order."""
        size, base = self.image_size, self.base
        span = base - size + 1
        rng = np.random.RandomState(
            (self.seed * 7 + self.epoch * 13 + self.process_index) % (2 ** 31))
        randomize = self.train and self.augment == "pad_crop_flip"
        for lidx, pad in self.batches(start_step):
            n = len(lidx)
            if randomize:
                xs = rng.randint(0, span, n)
                ys = rng.randint(0, span, n)
                flips = rng.randint(0, 2, n)
            else:
                xs = ys = np.full(n, (base - size) // 2)
                flips = np.zeros(n, np.int64)
            yield lidx, pad, xs, ys, flips

    def iter_from(self, start_step: int) -> Iterator[dict]:
        if self.num_workers <= 0:
            for args in self._batch_args(start_step):
                yield self._assemble(*args)
            return
        # An ordered window of assemblies in flight: up to 2 × workers
        # submitted ahead, the oldest yielded first.
        with ThreadPoolExecutor(self.num_workers) as pool:
            window: deque = deque()
            try:
                for args in self._batch_args(start_step):
                    window.append(pool.submit(self._assemble, *args))
                    if len(window) > 2 * self.num_workers:
                        yield window.popleft().result()
                while window:
                    yield window.popleft().result()
            finally:
                for f in window:
                    f.cancel()
