"""Host-side data: datasets, augmentation and the sharded loader."""
