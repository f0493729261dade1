"""Eval image transform (vitax/data/transforms.py ValTransform) on uint8
HWC numpy arrays: resize the shorter side to image_size*256//224 (bicubic),
then center crop to image_size. Output stays uint8; the engine normalises
on the device (vitax_torch/train/step.py prepare_images).

The resample goes through PIL, imported at use, so its pixels equal the
JAX package's. It is skipped when the shorter side already equals the
target, where PIL's resize returns an unchanged copy, so such inputs need
no PIL at all.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision Resize(int) parity: scale the shorter side to `size`."""
    height, width = img.shape[:2]
    if width <= height:
        new_w, new_h = size, max(1, int(round(size * height / width)))
    else:
        new_h, new_w = size, max(1, int(round(size * width / height)))
    if (new_w, new_h) == (width, height):
        return img
    from PIL import Image
    return np.asarray(Image.fromarray(img, "RGB").resize((new_w, new_h), Image.Resampling.BICUBIC))


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Center crop to (size, size). The caller resized the shorter side to at
    least `size` (resize_to >= image_size), so no padding case arises."""
    height, width = img.shape[:2]
    top, left = (height - size) // 2, (width - size) // 2
    return img[top:top + size, left:left + size]


class ValTransform:
    """Reference val stack: resize shorter side to size*256//224, center crop."""

    def __init__(self, image_size: int):
        self.image_size = image_size
        self.resize_to = (image_size * 256) // 224

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"ValTransform takes uint8 (H, W, 3), got {img.dtype} {img.shape}")
        img = resize_shorter(img, self.resize_to)
        return np.ascontiguousarray(center_crop(img, self.image_size))
