"""Quantized serving: int8 or fp8 weights resident on the device
(vitax/serve/quant.py, on PyTorch).

A quantized export (vitax/checkpoint/consolidate.py --dtype int8 or
float8_e4m3) loads its quantized leaves at their stored types; the only
extra state is each one's per-output-channel float32 scale, kept beside the
weight as the module's `qscale` (vitax_torch/checkpoint/convert.py). On the
card every Dense site multiplies through the dequant_matmul kernel, and the
patchify conv dequantizes its weight at use. `quantize_params_for_serve`
quantizes a float model's state in memory (no export on disk), and the
accuracy gate compares a quantized engine with a full-precision one.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from vitax_torch.checkpoint.consolidate import QUANT_SCALE_PREFIX, quantize_tensor
from vitax_torch.ops.dequant_matmul import dequantize_leaf  # noqa: F401  (re-exported)

_SITES = ("qkv", "proj", "fc1", "fc2")


def dequant_spec(flat: Mapping[str, torch.Tensor], manifest: Mapping[str, str]) -> Dict[str, dict]:
    """Per-key load spec of a quantized export: {key: {"dtype": stored
    dtype, "quantized": bool, "scale_key": scale entry name or None}}."""
    spec: Dict[str, dict] = {}
    for k, v in flat.items():
        q = manifest.get(k)
        spec[k] = {"dtype": q or str(v.dtype).replace("torch.", ""), "quantized": q is not None,
                   "scale_key": QUANT_SCALE_PREFIX + k if q else None}
    return spec


def dense_site_kind(key: str) -> str:
    """The consumer of a quantized leaf, for a "/"-joined Flax key or a
    "."-joined state_dict name: "block" for the in-block Dense sites (qkv,
    proj, fc1, fc2: act-quant eligible), "head" for the classifier head
    (weight-only always), "" for everything else. The patchify conv is
    named "proj" too; being outside the blocks is what excludes it."""
    parts = key.replace(".", "/").split("/")
    if len(parts) < 2 or parts[-1] not in ("kernel", "weight"):
        return ""
    parent = parts[-2]
    if parent == "head":
        return "head"
    in_blocks = any(p == "blocks" or p.startswith("blocks_") for p in parts)
    return "block" if in_blocks and parent in _SITES else ""


@torch.no_grad()
def quantize_params_for_serve(state: Dict[str, torch.Tensor], dtype: str = "int8") -> Dict[str, torch.Tensor]:
    """The quantized state of a float model's state_dict, on the same
    device: every Linear and conv weight becomes its int8 or fp8 codes and
    a (out,) float32 `qscale` beside it, quantized per output channel as
    consolidate.py --dtype quantizes the export (so the result equals the
    conversion of that export); other leaves pass through by reference.
    Leaf by leaf, each float weight is popped from `state` as it is
    quantized, so a caller that holds no other reference frees it then."""
    out: Dict[str, torch.Tensor] = {}
    for name in list(state):
        leaf = state.pop(name)
        if name.endswith(".weight") and leaf.dim() >= 2:
            q, scale = quantize_tensor(leaf, range(1, leaf.dim()), dtype)
            out[name] = q
            out[name[:-len("weight")] + "qscale"] = scale.reshape(-1)
        else:
            out[name] = leaf
        del leaf
    return out


def topk_accuracy(ids: np.ndarray, labels: np.ndarray) -> Tuple[float, float]:
    """(top1, top5) from predict's ids (n, k) and labels (n,); top5 uses
    min(5, k) columns."""
    labels = np.asarray(labels).reshape(-1, 1)
    top1 = float(np.mean(ids[:, :1] == labels))
    top5 = float(np.mean(np.any(ids[:, :min(5, ids.shape[1])] == labels, axis=1)))
    return top1, top5


def eval_engine(engine, images: np.ndarray, labels: np.ndarray,
                batch: Optional[int] = None) -> Tuple[float, float]:
    """Top-1/top-5 of one engine over (images, labels), batched through the
    same bucketed predict path traffic uses."""
    b = batch or engine.buckets[-1]
    ids = np.concatenate([engine.predict(images[i:i + b])[0] for i in range(0, images.shape[0], b)], axis=0)
    return topk_accuracy(ids, labels)


def run_quant_gate(engine_f32, engine_q, images: np.ndarray, labels: np.ndarray, recorder=None) -> dict:
    """The accuracy gate: quantized vs full-precision top-1/top-5 on one
    eval set; deltas in points. Returns the record and, with a Recorder
    (telemetry/record.py), emits it as one kind "quant_gate" event, which
    tools/metrics_report.py surfaces; the caller decides its threshold."""
    top1_f, top5_f = eval_engine(engine_f32, images, labels)
    top1_q, top5_q = eval_engine(engine_q, images, labels)
    gate = {
        "top1_f32": top1_f, "top5_f32": top5_f,
        "top1_quant": top1_q, "top5_quant": top5_q,
        "delta_top1": round(100.0 * (top1_q - top1_f), 4),
        "delta_top5": round(100.0 * (top5_q - top5_f), 4),
        "n": int(images.shape[0]),
        "weights_dtype": engine_q.weights_dtype,
        "baseline_dtype": engine_f32.weights_dtype,
        "act_quant": getattr(engine_q, "act_quant", "off"),
        "fused_dequant": getattr(engine_q, "fused_dequant", False),
    }
    if recorder is not None:
        recorder.event("quant_gate", **gate)
    return gate
