"""Sharded input pipeline: each process loads its slice.

The port of ``distributed_training_tpu/data/pipeline.py``: a
deterministic global permutation seeded by ``(seed, epoch)``, a contiguous
per-process slice of every global batch, ``drop_last`` for train and a
0/1 ``mask`` on the ragged last eval batch, augmentation on whole uint8
batches. The batches are bitwise identical to the JAX package's.

Host→device copies (:func:`to_device`) go through pinned memory with
``non_blocking=True``, so the copy of one batch overlaps the step still
running on the card; the trainers copy ahead on a thread of their own
(``data/prefetch.py``). Besides the in-memory datasets,
:func:`build_dataloaders` reads imagefolder trees (``data/imagefolder.py``)
and, with ``data.decoded_cache``, their decoded cache
(``data/decoded_cache.py``).
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch

from distributed_training_tpu_torch.data import cifar10, transforms
from distributed_training_tpu_torch.data.synthetic import synthetic_imagenet
from distributed_training_tpu_torch.runtime.coordinator import Coordinator


def check_microbatches(global_batch_size: int, process_count: int,
                       microbatches: int) -> None:
    """The global batch must split into ``microbatches`` blocks of equal
    shares for every process."""
    if microbatches > 1 and global_batch_size % (microbatches * process_count):
        raise ValueError(
            f"global batch {global_batch_size} not divisible into "
            f"{microbatches} microbatches over {process_count} processes")


def process_rows(rows: np.ndarray, index: int, count: int,
                 microbatches: int = 1, local: int | None = None) -> np.ndarray:
    """Process ``index``'s share of one global batch's ``rows`` (of
    ``count`` processes). With ``microbatches`` A the global batch is A
    contiguous blocks, JAX's gradient-accumulation microbatches (the
    GSPMD step's ``microbatches``: ``[G] → [A, G/A]`` with the data axis
    on dim 1), and the process takes its contiguous ``1/count`` of each
    block in turn, so that chunk *m* of its rows is its data shard of
    JAX's microbatch *m*; at A = 1 (or one process) its contiguous slice
    of the whole batch, ``local`` rows (default ``len(rows) / count``; a
    ragged last batch leaves the last processes fewer)."""
    if microbatches > 1 and count > 1:
        return rows.reshape(microbatches, count, -1)[:, index].reshape(-1)
    n = len(rows) // count if local is None else local
    return rows[index * n:(index + 1) * n]


class ShardedBatchIndexer:
    """One global permutation per (seed, epoch), the same on every
    process; each process takes its contiguous slice of every global
    batch, or with ``microbatches`` A > 1 its slice of each of the A
    contiguous blocks of the global batch (:func:`process_rows`)."""

    def __init__(
        self,
        num_examples: int,
        *,
        global_batch_size: int,
        shuffle: bool,
        drop_last: bool,
        seed: int,
        process_index: int = 0,
        process_count: int = 1,
        max_steps: int | None = None,
        microbatches: int = 1,
    ):
        self.num_examples = num_examples
        self.global_batch_size = global_batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count
        if global_batch_size % process_count:
            raise ValueError(
                f"global batch {global_batch_size} not divisible by "
                f"{process_count} processes")
        self.local_batch_size = global_batch_size // process_count
        self.max_steps = max_steps
        check_microbatches(global_batch_size, process_count, microbatches)
        self.microbatches = microbatches

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle (``sampler.set_epoch`` parity)."""
        self.epoch = epoch

    def __len__(self) -> int:
        steps = (self.num_examples // self.global_batch_size if self.drop_last
                 else -(-self.num_examples // self.global_batch_size))
        if self.max_steps is not None:
            steps = min(steps, self.max_steps)
        return steps

    def batches(self, start_step: int = 0) -> Iterator[tuple[np.ndarray, int]]:
        """Yield ``(local_indices, pad)`` per step, from ``start_step``."""
        order = np.arange(self.num_examples)
        if self.shuffle:
            order = np.random.RandomState(
                (self.seed * 100_003 + self.epoch) % (2 ** 31)).permutation(
                    self.num_examples)
        for i in range(start_step, len(self)):
            gstart = i * self.global_batch_size
            gidx = order[gstart:gstart + self.global_batch_size]
            lidx = process_rows(gidx, self.process_index, self.process_count,
                                self.microbatches if len(gidx) == self.global_batch_size
                                else 1, self.local_batch_size)
            yield lidx, self.local_batch_size - len(lidx)


class ShardedDataLoader(ShardedBatchIndexer):
    """Deterministic sharded loader over in-memory arrays.

    Yields numpy dict batches ``{'image': f32[NHWC], 'label': i32[N]}``
    (+ ``mask`` when ``drop_last=False``).
    """

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        *,
        global_batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        augment: str = "none",
        train: bool = True,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        max_steps: int | None = None,
        microbatches: int = 1,
    ):
        super().__init__(
            len(labels), global_batch_size=global_batch_size, shuffle=shuffle,
            drop_last=drop_last, seed=seed, process_index=process_index,
            process_count=process_count, max_steps=max_steps,
            microbatches=microbatches)
        self.images = images
        self.labels = labels
        self.augment = augment
        self.train = train

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def iter_from(self, start_step: int) -> Iterator[dict]:
        """Iterate the epoch from ``start_step``; skipped batches are never
        materialized, and the augment stream restarts."""
        aug_rng = np.random.RandomState(
            (self.seed * 7 + self.epoch * 13 + self.process_index) % (2 ** 31))
        for lidx, pad in self.batches(start_step):
            images = self.images[lidx]
            labels = self.labels[lidx]
            mask = np.ones(len(lidx), dtype=np.float32)
            if pad:  # ragged final batch
                images = np.concatenate(
                    [images, np.zeros((pad, *images.shape[1:]), images.dtype)])
                labels = np.concatenate([labels, np.zeros(pad, labels.dtype)])
                mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            if self.train:
                x = transforms.apply_train_augment(images, self.augment, aug_rng)
            else:
                x = transforms.apply_eval_transform(images, self.augment)
            batch = {"image": x, "label": labels.astype(np.int32)}
            if not self.drop_last:
                batch["mask"] = mask
            yield batch


class SkipBatches:
    """Loader view that drops the first ``skip`` batches of the epoch's
    deterministic shuffle (step-accurate resume). A skip that no longer
    fits the epoch is refused: training zero batches would drop data."""

    def __init__(self, loader, skip: int):
        if skip >= len(loader):
            raise ValueError(
                f"cannot resume at step {skip} of a {len(loader)}-step "
                f"epoch — the epoch geometry changed since the save "
                f"(different batch size or dataset?)")
        self.loader, self.skip = loader, skip

    def __len__(self):
        return max(0, len(self.loader) - self.skip)

    def __iter__(self):
        if hasattr(self.loader, "iter_from"):
            return self.loader.iter_from(self.skip)
        it = iter(self.loader)
        for _ in range(self.skip):
            next(it, None)
        return it


def to_device(batch: dict, device: torch.device) -> dict:
    """Numpy batch → tensors on ``device``. On the card the copy is made
    from pinned memory with ``non_blocking=True``: it is queued on the
    current stream and the host goes on to the next batch."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def build_dataloaders(cfg, *, seed: int = 0,
                      global_batch_size: int | None = None,
                      eval_global_batch_size: int | None = None,
                      process_index: int | None = None,
                      process_count: int | None = None,
                      microbatches: int = 1):
    """Build ``(train_loader, eval_loader)`` for one process.

    ``global_batch_size`` / ``eval_global_batch_size`` override the config
    (the trainer passes ``config.effective_batch_sizes``, so gradient
    accumulation scales only the train loader). ``process_index`` and
    ``process_count`` default to this process's rank and the world size
    of the default process group (0 and 1 without one): each process
    loads its own contiguous slice of every global batch, or with
    ``microbatches`` > 1 (the train loader only) its slice of each
    gradient-accumulation microbatch in JAX's order (:func:`process_rows`).
    """
    coord = Coordinator()
    if process_index is None or process_count is None:
        process_index, process_count = coord.process_index, coord.process_count
    data = cfg.data
    global_bs = global_batch_size or data.global_batch_size or data.batch_size
    eval_bs = eval_global_batch_size or global_bs
    shard = dict(process_index=process_index, process_count=process_count)
    if data.dataset == "imagefolder":
        return _imagefolder_loaders(data, coord, seed, global_bs, eval_bs, shard,
                                    microbatches)
    if data.dataset == "cifar10":
        tr = cifar10.load_cifar10(data.data_path, train=True,
                                  synthetic_ok=data.synthetic_ok)
        ev = cifar10.load_cifar10(data.data_path, train=False,
                                  synthetic_ok=data.synthetic_ok)
    elif data.dataset == "synthetic_cifar":
        tr = cifar10.synthetic_cifar10(4096, True, seed)
        ev = cifar10.synthetic_cifar10(1024, False, seed)
    elif data.dataset == "synthetic_cifar_hard":
        tr = cifar10.synthetic_cifar10_hard(50_000, True, seed)
        ev = cifar10.synthetic_cifar10_hard(10_000, False, seed)
    elif data.dataset == "synthetic_imagenet":
        tr = synthetic_imagenet(8192, data.image_size, data.num_classes, seed)
        ev = synthetic_imagenet(1024, data.image_size, data.num_classes, seed + 1)
    else:
        raise ValueError(f"unknown dataset {data.dataset!r}")
    (train_x, train_y), (eval_x, eval_y) = tr, ev
    train_loader = ShardedDataLoader(
        train_x, train_y, global_batch_size=global_bs, shuffle=True,
        drop_last=data.drop_last, augment=data.augment, train=True, seed=seed,
        process_index=process_index, process_count=process_count,
        max_steps=data.max_steps_per_epoch, microbatches=microbatches)
    eval_loader = ShardedDataLoader(
        eval_x, eval_y, global_batch_size=eval_bs, shuffle=False,
        drop_last=False, augment=data.augment, train=False, seed=seed,
        process_index=process_index, process_count=process_count)
    return train_loader, eval_loader


def _imagefolder_loaders(data, coord: Coordinator, seed: int, global_bs: int,
                         eval_bs: int, shard: dict, microbatches: int = 1):
    """``root/train`` and ``root/val`` class trees (torchvision's layout),
    decoded a batch at a time on threads or, with ``data.decoded_cache``,
    decoded once into ``root/.decoded_cache/{train,val}_<size>`` (rank 0
    first, so processes sharing a filesystem do not race) and read from
    there."""
    from distributed_training_tpu_torch.data.imagefolder import (
        ImageFolderLoader,
        scan_imagefolder,
    )

    if not data.data_path:
        raise ValueError("dataset='imagefolder' requires data_path")
    tr_paths, tr_labels, classes = scan_imagefolder(os.path.join(data.data_path, "train"))
    ev_paths, ev_labels, ev_classes = scan_imagefolder(os.path.join(data.data_path, "val"))
    if classes != ev_classes:
        raise ValueError(f"train/val class mismatch: {classes} vs {ev_classes}")
    if len(classes) != data.num_classes:
        raise ValueError(
            f"found {len(classes)} classes under {data.data_path}, "
            f"config says num_classes={data.num_classes}")
    if not data.decoded_cache:
        common = dict(image_size=data.image_size, seed=seed,
                      num_workers=data.num_workers, augment=data.augment, **shard)
        return (ImageFolderLoader(tr_paths, tr_labels, global_batch_size=global_bs,
                                  shuffle=True, drop_last=data.drop_last, train=True,
                                  max_steps=data.max_steps_per_epoch,
                                  microbatches=microbatches, **common),
                ImageFolderLoader(ev_paths, ev_labels, global_batch_size=eval_bs,
                                  shuffle=False, drop_last=False, train=False, **common))
    from distributed_training_tpu_torch.data.decoded_cache import (
        DecodedCacheLoader,
        build_decoded_cache,
    )

    cache_root = os.path.join(data.data_path, ".decoded_cache")
    caches = {}
    with coord.priority_execution("decoded_cache"):
        for split, paths, labels in (("train", tr_paths, tr_labels),
                                     ("val", ev_paths, ev_labels)):
            caches[split] = build_decoded_cache(
                paths, labels, os.path.join(cache_root, f"{split}_{data.image_size}"),
                image_size=data.image_size, num_workers=data.num_workers)
    cached = dict(image_size=data.image_size, seed=seed, augment=data.augment,
                  num_workers=data.num_workers, **shard)
    return (DecodedCacheLoader(caches["train"], global_batch_size=global_bs, shuffle=True,
                               drop_last=data.drop_last, train=True,
                               max_steps=data.max_steps_per_epoch,
                               microbatches=microbatches, **cached),
            DecodedCacheLoader(caches["val"], global_batch_size=eval_bs, shuffle=False,
                               drop_last=False, train=False, **cached))
