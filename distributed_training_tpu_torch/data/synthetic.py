"""Synthetic ImageNet-shaped data (a copy of
``distributed_training_tpu/data/synthetic.py``)."""

from __future__ import annotations

import numpy as np


def synthetic_imagenet(n: int, image_size: int = 224, num_classes: int = 1000,
                       seed: int = 0):
    """Uniform random uint8 images and labels, ImageNet-shaped."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n).astype(np.int32)
    images = rng.randint(0, 256, size=(n, image_size, image_size, 3),
                         dtype=np.uint8)
    return images, labels
