"""Directory-tree image datasets (torchvision's ``ImageFolder`` layout).

The port of ``distributed_training_tpu/data/imagefolder.py``: a
``root/<class>/<image>`` tree decoded lazily (ImageNet does not fit in
memory), a batch at a time on a pool of threads (PIL releases the GIL
while it decodes). Sharding and the epoch's shuffle are
:class:`ShardedBatchIndexer`'s: one global permutation per (seed, epoch)
and a contiguous slice of every global batch per process. The batches
are bitwise the JAX package's: the same files in the same order, the same
resize, crop and flip from the same per-example seed.

Decode needs Pillow (:func:`pillow`); the decoded cache
(``data/decoded_cache.py``) reads its own files without it.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from distributed_training_tpu_torch.data.pipeline import ShardedBatchIndexer
from distributed_training_tpu_torch.resilience.chaos import chaos_io_check
from distributed_training_tpu_torch.resilience.retry import RetryPolicy

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".gif", ".webp")

# Transient-I/O retry for each image's decode (flaky network-filesystem
# reads; also where the chaos harness injects its one-shot faults), with a
# deterministic backoff, so chaos runs replay exactly.
_DECODE_RETRY = RetryPolicy(max_attempts=3, base_delay_s=0.02)


def pillow():
    """PIL's ``Image`` module; raises ``ImportError`` naming Pillow when it
    is not installed (image decode and the JPEG trees need it)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding an image tree needs Pillow (the PIL package), which "
            "is not installed; the decoded cache's files read without it") from e
    return Image


def scan_imagefolder(root: str) -> tuple[list[str], np.ndarray, list[str]]:
    """Scan ``root/<class>/<image>`` into (paths, labels, class_names):
    classes sorted by name (a class's index is its rank), files sorted
    within each class, so the index → example map is the same on every
    process and run."""
    root = os.path.abspath(root)
    if not os.path.isdir(root):
        raise FileNotFoundError(f"imagefolder root {root} does not exist")
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise ValueError(f"imagefolder root {root} has no class directories")
    paths: list[str] = []
    labels: list[int] = []
    for idx, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(IMAGE_EXTENSIONS):
                paths.append(os.path.join(cdir, fname))
                labels.append(idx)
    if not paths:
        raise ValueError(f"no images with {IMAGE_EXTENSIONS} under {root}")
    return paths, np.asarray(labels, np.int32), classes


def _decode(path: str, size: int, randomize: bool, rng_seed: int) -> np.ndarray:
    """One image as float32 [size, size, 3] in [0, 1], retrying transient
    I/O faults (``_DECODE_RETRY``; chaos injects here).

    The short side is resized to ``round(1.15 · size)`` (bilinear); then
    with ``randomize`` a random crop and horizontal flip drawn from
    ``rng_seed``, else the centre crop.
    """
    return _DECODE_RETRY.call(_decode_once, path, size, randomize, rng_seed)


def _decode_once(path: str, size: int, randomize: bool,
                 rng_seed: int) -> np.ndarray:
    Image = pillow()
    chaos_io_check("data", path)
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        short = int(round(size * 1.15))
        scale = short / min(w, h)
        im = im.resize((max(size, int(round(w * scale))),
                        max(size, int(round(h * scale)))), Image.BILINEAR)
        w, h = im.size
        if randomize:
            rng = np.random.RandomState(rng_seed % (2 ** 31))
            x0 = rng.randint(0, w - size + 1)
            y0 = rng.randint(0, h - size + 1)
            im = im.crop((x0, y0, x0 + size, y0 + size))
            if rng.randint(2):
                im = im.transpose(Image.FLIP_LEFT_RIGHT)
        else:
            x0 = (w - size) // 2
            y0 = (h - size) // 2
            im = im.crop((x0, y0, x0 + size, y0 + size))
        return np.asarray(im, np.float32) / 255.0


class ImageFolderLoader(ShardedBatchIndexer):
    """Lazy sharded loader over an image tree.

    Yields numpy ``{'image': f32[NHWC], 'label': i32[N]}`` (+ ``mask``
    when ``drop_last=False``), this process's slice of each global batch;
    ``set_epoch`` reseeds the shuffle. Decode runs on ``num_workers``
    threads, the batch's order kept.
    """

    def __init__(
        self,
        paths: Sequence[str],
        labels: np.ndarray,
        *,
        global_batch_size: int,
        image_size: int = 224,
        shuffle: bool = True,
        drop_last: bool = True,
        train: bool = True,
        augment: str = "pad_crop_flip",
        seed: int = 0,
        num_workers: int = 8,
        process_index: int = 0,
        process_count: int = 1,
        max_steps: int | None = None,
        microbatches: int = 1,
    ):
        if len(paths) != len(labels):
            raise ValueError(f"{len(paths)} paths vs {len(labels)} labels")
        super().__init__(
            len(labels), global_batch_size=global_batch_size, shuffle=shuffle,
            drop_last=drop_last, seed=seed, process_index=process_index,
            process_count=process_count, max_steps=max_steps,
            microbatches=microbatches)
        self.paths = list(paths)
        self.labels = np.asarray(labels, np.int32)
        self.image_size = image_size
        self.train = train
        if augment not in ("pad_crop_flip", "normalize_only", "none"):
            raise ValueError(f"unknown augment mode {augment!r}")
        self.augment = augment
        self.num_workers = max(1, num_workers)

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def iter_from(self, start_step: int) -> Iterator[dict]:
        """Iterate from ``start_step``; the skipped batches are skipped at
        the index level, with no decode."""
        # Per-example decode seeds from (seed, epoch, global index): the
        # same crop for an example whichever process or step loads it.
        seed_base = (self.seed * 7 + self.epoch * 13) % (2 ** 31)
        # A random crop and flip only for pad_crop_flip training; the
        # normalize_only mode (and 'none') take the centre crop.
        randomize = self.train and self.augment == "pad_crop_flip"

        with ThreadPoolExecutor(self.num_workers) as pool:
            for lidx, pad in self.batches(start_step):
                decoded = list(pool.map(
                    lambda j: _decode(self.paths[j], self.image_size,
                                      randomize, seed_base + int(j)),
                    lidx))
                labels = self.labels[lidx]
                mask = np.ones(len(lidx), np.float32)
                if pad:  # ragged final batch
                    decoded.extend(
                        [np.zeros((self.image_size, self.image_size, 3),
                                  np.float32)] * pad)
                    labels = np.concatenate([labels, np.zeros(pad, np.int32)])
                    mask = np.concatenate([mask, np.zeros(pad, np.float32)])
                images = np.stack(decoded)
                if self.augment == "normalize_only":
                    images = (images - 0.5) / 0.5  # Normalize(0.5, 0.5) → [-1, 1]
                batch = {"image": images, "label": labels.astype(np.int32)}
                if not self.drop_last:
                    batch["mask"] = mask
                yield batch
