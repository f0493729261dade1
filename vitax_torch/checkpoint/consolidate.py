"""Reading the consolidated .npz export (vitax/checkpoint/consolidate.py).

The file is the JAX package's save_npz output: "/"-joined Flax param paths
("params/blocks/attn/qkv/kernel", ...), bfloat16 leaves stored as uint16
bit-views listed under the "__bfloat16_keys__" manifest, and quantized
exports marked by a "__quant__" manifest. This module reads it with numpy
and torch only: bf16 leaves come back as torch.bfloat16 tensors viewed from
their uint16 payload, exactly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

BF16_MANIFEST_KEY = "__bfloat16_keys__"
QUANT_MANIFEST_KEY = "__quant__"


def flatten_tree(tree: dict, sep: str = "/") -> Dict[str, object]:
    """Flatten a nested-dict tree to {"a/b/c": leaf}; inverse of unflatten_tree."""
    out: Dict[str, object] = {}

    def walk(node, prefix):
        for key, value in node.items():
            path = f"{prefix}{sep}{key}" if prefix else str(key)
            if isinstance(value, dict):
                walk(value, path)
            else:
                out[path] = value

    walk(tree, "")
    return out


def unflatten_tree(flat: Dict[str, object], sep: str = "/") -> dict:
    """Rebuild the nested dict tree from flatten_tree's "/"-joined keys."""
    tree: dict = {}
    for key, leaf in flat.items():
        parts = key.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def load_npz_raw(path: str) -> Dict[str, torch.Tensor]:
    """Read a save_npz export to {key: CPU tensor} at its stored types, with
    the bf16 uint16 views restored. Raises on a quantized export: int8/fp8
    serving is a later slice of the port."""
    with np.load(path) as data:
        if QUANT_MANIFEST_KEY in data.files:
            raise ValueError(
                f"{path} is a quantized export (__quant__ manifest); quantized serving "
                f"(int8/fp8 weights, the dequant_matmul kernel) is not ported to vitax_torch "
                f"yet: re-export with consolidate.py --dtype float32 or bfloat16")
        bf16 = (set(str(k) for k in data[BF16_MANIFEST_KEY])
                if BF16_MANIFEST_KEY in data.files else set())
        flat = {}
        for k in data.files:
            if k == BF16_MANIFEST_KEY:
                continue
            arr = data[k]
            if k in bf16:
                flat[k] = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
            else:
                flat[k] = torch.from_numpy(np.ascontiguousarray(arr))
        return flat
