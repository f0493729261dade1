"""Image transforms (vitax/data/transforms.py), bitwise equal to the JAX
package's on the same image, seed, epoch and index.

Train: RandomResizedCrop(size, scale=(0.08, 1.0), ratio=(3/4, 4/3),
       bicubic) + RandomHorizontalFlip(0.5)
Val:   Resize(size * 256 // 224, bicubic) + CenterCrop(size), zero-padded
       when the image is smaller

Both take a PIL image (the datasets' decode path: resampled as it is, no
copy to an array and back, which would hold the GIL the loader's threads
share) or a uint8 (H, W, 3) array (the server's PPM bodies), and return
HWC uint8, or float32 normalized with ImageNet's mean and std when
`normalize`. The port's default is uint8 (normalize False): the train step
and the engine normalize on the card (train/step.py prepare_images). The
resamples go through PIL, imported at use, so the pixels are PIL's; on an
array the val resize is skipped where the shorter side already has the
target length, where PIL returns an unchanged copy.

The augmentation's randomness comes from a SeedSequence over (seed,
epoch, index), so it is thread-safe and reproducible; `native_params`
draws the same numbers in the same order as `__call__`, so the native
decoder (data/native.py) applies the same crop and flip.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _check(arr: np.ndarray) -> np.ndarray:
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"transforms take uint8 (H, W, 3) arrays or PIL images, got {arr.dtype} {arr.shape}")
    return arr


def _size(img) -> Tuple[int, int]:
    """(width, height) of an array or a PIL image."""
    return (img.shape[1], img.shape[0]) if isinstance(img, np.ndarray) else img.size


def _bicubic(img, size: Tuple[int, int], box=None) -> np.ndarray:
    """PIL's bicubic resize of a PIL image, or of an array through one."""
    from PIL import Image
    if isinstance(img, np.ndarray):
        img = Image.fromarray(_check(img), "RGB")
    elif img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img.resize(size, Image.Resampling.BICUBIC, box=box))


def _finish(img: np.ndarray, normalize: bool) -> np.ndarray:
    if not normalize:
        return np.ascontiguousarray(img)
    arr = img.astype(np.float32) / 255.0           # ToTensor: scale to [0, 1]
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def get_crop_params(width: int, height: int, rng: np.random.Generator,
                    scale: Tuple[float, float] = (0.08, 1.0),
                    ratio: Tuple[float, float] = (3 / 4, 4 / 3)) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params: 10 attempts at a random
    area and aspect, then a center crop at the closest valid ratio.
    Returns (left, top, w, h)."""
    area = width * height
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = int(rng.integers(0, height - h + 1))
            left = int(rng.integers(0, width - w + 1))
            return left, top, w, h
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = height, int(round(height * ratio[1]))
    else:
        w, h = width, height
    return (width - w) // 2, (height - h) // 2, w, h


def random_resized_crop(img, size: int, rng: np.random.Generator,
                        scale: Tuple[float, float] = (0.08, 1.0),
                        ratio: Tuple[float, float] = (3 / 4, 4 / 3)) -> np.ndarray:
    width, height = _size(img)
    left, top, w, h = get_crop_params(width, height, rng, scale, ratio)
    return _bicubic(img, (size, size), box=(left, top, left + w, top + h))


def resize_shorter(img, size: int) -> np.ndarray:
    """torchvision Resize(int): scale the shorter side to `size`."""
    width, height = _size(img)
    if width <= height:
        new_w, new_h = size, max(1, int(round(size * height / width)))
    else:
        new_h, new_w = size, max(1, int(round(size * width / height)))
    if (new_w, new_h) == (width, height) and isinstance(img, np.ndarray):
        return _check(img)
    return _bicubic(img, (new_w, new_h))


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision CenterCrop: pads with zeros where the image is smaller."""
    height, width = img.shape[:2]
    if width < size or height < size:
        padded = np.zeros((max(height, size), max(width, size), 3), np.uint8)
        top, left = (padded.shape[0] - height) // 2, (padded.shape[1] - width) // 2
        padded[top:top + height, left:left + width] = img
        img, (height, width) = padded, padded.shape[:2]
    top, left = (height - size) // 2, (width - size) // 2
    return img[top:top + size, left:left + size]


class TrainTransform:
    """The reference's train stack (vitax/data/transforms.py TrainTransform)."""

    def __init__(self, image_size: int, seed: int = 0, normalize: bool = False):
        self.image_size = image_size
        self.seed = seed
        self.epoch = 0
        self.normalize = normalize

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch, index]))

    def __call__(self, img, index: int = 0) -> np.ndarray:
        rng = self._rng(index)
        out = random_resized_crop(img, self.image_size, rng)
        if rng.random() < 0.5:
            out = out[:, ::-1]
        return _finish(out, self.normalize)

    def native_params(self, width: int, height: int, index: int) -> Tuple[int, ...]:
        """(mode 0, left, top, cw, ch, flip) for the native decoder: the
        same draws, in the same order, as __call__."""
        rng = self._rng(index)
        left, top, w, h = get_crop_params(width, height, rng)
        return (0, left, top, w, h, int(rng.random() < 0.5))


class ValTransform:
    """The reference's val stack: resize the shorter side to
    size * 256 // 224, center crop (vitax/data/transforms.py ValTransform)."""

    def __init__(self, image_size: int, normalize: bool = False):
        self.image_size = image_size
        self.resize_to = (image_size * 256) // 224
        self.normalize = normalize

    def set_epoch(self, epoch: int) -> None:
        pass

    def __call__(self, img, index: int = 0) -> np.ndarray:
        out = center_crop(resize_shorter(img, self.resize_to), self.image_size)
        return _finish(out, self.normalize)

    def native_params(self, width: int, height: int, index: int) -> Tuple[int, ...]:
        return (1, 0, 0, 0, 0, 0)         # mode 1: the val pipeline draws nothing
