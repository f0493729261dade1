"""Analytic model FLOPs and MFU (vitax/telemetry/flops.py, PaLM appendix B
convention): useful matmul FLOPs of one forward and backward over the
batch (3x the forward; remat recompute is not useful work), over the
card's peak. The FLOP count is closed-form from the Config, the same
numbers the JAX package reports.
"""

from __future__ import annotations

import sys
from typing import Optional

# Dense bf16 tensor-core peak in TFLOP/s by CUDA device name (NVIDIA's data
# sheets). "cpu" keeps CPU runs' MFU finite and equal to the JAX package's.
# A card not listed has no peak: MFU 0 unless --peak_tflops gives one.
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,     # H100 SXM5
    "cpu": 1.0,
}


def peak_tflops(device_name: str) -> Optional[float]:
    """Peak bf16 TFLOP/s of a card from torch.cuda.get_device_name, or None."""
    return PEAK_TFLOPS.get(device_name)


def detect_peak_tflops(device_kind: str, override: float = 0.0) -> float:
    """Per-card peak TFLOP/s for `device_kind` (torch.cuda.get_device_name,
    or "cpu"); `override` > 0 (--peak_tflops) always wins. A card the table
    has not met gets 0, so its MFU reads 0, and one warning naming the flag."""
    if override and override > 0:
        return float(override)
    peak = PEAK_TFLOPS.get(device_kind)
    if peak is None:
        print(f"vitax_torch.telemetry: no peak TFLOP/s known for {device_kind!r}; MFU reads 0 "
              f"(pass --peak_tflops to set the card's dense bf16 peak)", file=sys.stderr, flush=True)
        return 0.0
    return peak


def model_flops_per_image(cfg) -> float:
    """Useful matmul FLOPs per image, forward and backward: qkv, proj, the
    two attention einsums, fc1, fc2, the patchify conv and the head. Under
    MoE the MLP counts the top-k experts a token runs and the router's
    logits, not the dispatch and combine products nor dropped slots
    (vitax/telemetry/flops.py:64-67)."""
    d, layers = cfg.embed_dim, cfg.num_blocks
    n = cfg.num_patches
    h = cfg.mlp_hidden_dim
    attn_per_token = 2 * (3 * d * d + d * d)                   # qkv, proj
    attn_block = 2 * 2 * n * n * d                             # QK^T and AV
    if getattr(cfg, "moe_experts", 0) > 0:
        mlp_per_token = (cfg.moe_top_k * 2 * (d * h + h * d)   # top-k experts
                         + 2 * d * cfg.moe_experts)            # router logits
    else:
        mlp_per_token = 2 * (d * h + h * d)                    # fc1, fc2
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
