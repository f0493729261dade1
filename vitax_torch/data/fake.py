"""Fake ImageNet dataset (vitax/data/fake.py, the reference's
FakeImageNetDataset): zero images, label 0, the real ImageNet split
lengths. Images are NHWC float32, as the JAX package keeps them."""

from __future__ import annotations

import numpy as np

TRAIN_SPLIT_LEN = 1_281_167
VAL_SPLIT_LEN = 50_000


class FakeImageNetDataset:
    def __init__(self, image_size: int, length: int):
        self.image_size = image_size
        self.length = length

    def __getitem__(self, idx: int):
        s = self.image_size
        return np.zeros((s, s, 3), np.float32), 0

    def __len__(self) -> int:
        return self.length

    def __repr__(self) -> str:
        return f"FakeImageNetDataset(image_size={self.image_size}, length={self.length})"
