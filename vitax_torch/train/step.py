"""Device-side input preparation (vitax/train/step.py prepare_images).
The train step itself comes with the training slice."""

from __future__ import annotations

import torch

from vitax_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD


def prepare_images(images: torch.Tensor) -> torch.Tensor:
    """ToTensor + Normalize for uint8 (B, H, W, 3) batches, on their device:
    f32 / 255, minus the ImageNet mean, over its std. Float inputs pass
    through unchanged."""
    if images.dtype != torch.uint8:
        return images
    mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, device=images.device)
    return (images.float() / 255.0 - mean) / std
