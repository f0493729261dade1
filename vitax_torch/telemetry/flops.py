"""Analytic model FLOPs and MFU (vitax/telemetry/flops.py, PaLM appendix B
convention): useful matmul FLOPs of one forward and backward over the
batch (3x the forward; remat recompute is not useful work), over the
card's peak. The FLOP count is closed-form from the Config, the same
numbers the JAX package reports.
"""

from __future__ import annotations

from typing import Optional

# Dense bf16 tensor-core peak in TFLOP/s by CUDA device name (NVIDIA's data
# sheets). A card not listed has no MFU.
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,     # H100 SXM5
}


def peak_tflops(device_name: str) -> Optional[float]:
    """Peak bf16 TFLOP/s of a card from torch.cuda.get_device_name, or None."""
    return PEAK_TFLOPS.get(device_name)


def model_flops_per_image(cfg) -> float:
    """Useful matmul FLOPs per image, forward and backward: qkv, proj, the
    two attention einsums, fc1, fc2, the patchify conv and the head."""
    d, layers = cfg.embed_dim, cfg.num_blocks
    n = cfg.num_patches
    h = cfg.mlp_hidden_dim
    attn_per_token = 2 * (3 * d * d + d * d)                   # qkv, proj
    attn_block = 2 * 2 * n * n * d                             # QK^T and AV
    mlp_per_token = 2 * (d * h + h * d)                        # fc1, fc2
    fwd = layers * ((attn_per_token + mlp_per_token) * n + attn_block)
    fwd += 2 * n * (3 * cfg.patch_size ** 2) * d               # patchify conv
    fwd += 2 * d * cfg.num_classes                             # head
    return 3.0 * fwd


def model_flops_per_step(cfg) -> float:
    """Useful FLOPs of one optimizer step: per image x batch (any K)."""
    return model_flops_per_image(cfg) * cfg.batch_size


def mfu(cfg, sec_per_iter: float, n_devices: int, peak_tflops_per_card: float) -> float:
    """Achieved useful FLOP/s over the cards' aggregate peak, in [0, 1]."""
    if sec_per_iter <= 0 or n_devices <= 0 or peak_tflops_per_card <= 0:
        return 0.0
    return model_flops_per_step(cfg) / sec_per_iter / (peak_tflops_per_card * 1e12 * n_devices)
