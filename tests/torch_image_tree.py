"""A tiny image tree for the input-pipeline tests: ``root/{train,val}/
{cat,dog}/``, seeded RGB noise at odd sizes written by PIL (JPEGs, one
PNG, one grey JPEG), and a file that is not an image."""

import os

import numpy as np
from PIL import Image

SIZES = [(37, 29), (50, 41), (23, 61), (44, 44), (31, 57), (40, 26), (29, 35)]


def write_tree(root, train_per_class: int = 7, val_per_class: int = 3, seed: int = 0) -> str:
    rng = np.random.RandomState(seed)
    for split, n in (("train", train_per_class), ("val", val_per_class)):
        for cls in ("cat", "dog"):
            d = os.path.join(root, split, cls)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                w, h = SIZES[i % len(SIZES)]
                arr = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
                if i == 1:
                    Image.fromarray(arr).save(os.path.join(d, f"im{i:02d}.png"))
                elif i == 2:
                    Image.fromarray(arr[..., 0]).save(os.path.join(d, f"im{i:02d}.jpg"), quality=90)
                else:
                    Image.fromarray(arr).save(os.path.join(d, f"im{i:02d}.JPEG"), quality=90)
            with open(os.path.join(d, "notes.txt"), "w") as fh:
                fh.write("not an image\n")
    return str(root)
