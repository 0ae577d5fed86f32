"""Sharded input pipeline for one process.

The port of ``distributed_training_tpu/data/pipeline.py``: a
deterministic global permutation seeded by ``(seed, epoch)``, a contiguous
per-process slice of every global batch, ``drop_last`` for train and a
0/1 ``mask`` on the ragged last eval batch, augmentation on whole uint8
batches. The batches are bitwise identical to the JAX package's.

Host→device copies (:func:`to_device`) go through pinned memory with
``non_blocking=True``, so the copy of one batch overlaps the step still
running on the card. Not ported yet: imagefolder trees, the decoded cache
and the background prefetch thread.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from distributed_training_tpu_torch.data import cifar10, transforms
from distributed_training_tpu_torch.data.synthetic import synthetic_imagenet


class ShardedBatchIndexer:
    """One global permutation per (seed, epoch), the same on every
    process; each process takes its contiguous slice of every global
    batch."""

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
            lstart = self.process_index * self.local_batch_size
            lidx = gidx[lstart:lstart + self.local_batch_size]
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
    ):
        super().__init__(
            len(labels), global_batch_size=global_batch_size, shuffle=shuffle,
            drop_last=drop_last, seed=seed, process_index=process_index,
            process_count=process_count, max_steps=max_steps)
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
                      eval_global_batch_size: int | None = None):
    """Build ``(train_loader, eval_loader)`` for one process.

    ``global_batch_size`` / ``eval_global_batch_size`` override the config
    (the trainer passes ``config.effective_batch_sizes``, so gradient
    accumulation scales only the train loader).
    """
    data = cfg.data
    global_bs = global_batch_size or data.global_batch_size or data.batch_size
    eval_bs = eval_global_batch_size or global_bs
    if data.dataset == "imagefolder" or data.decoded_cache:
        raise NotImplementedError(
            "imagefolder datasets and the decoded cache are not ported yet")
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
        max_steps=data.max_steps_per_epoch)
    eval_loader = ShardedDataLoader(
        eval_x, eval_y, global_batch_size=eval_bs, shuffle=False,
        drop_last=False, augment=data.augment, train=False, seed=seed)
    return train_loader, eval_loader
