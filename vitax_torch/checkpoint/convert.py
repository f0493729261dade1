"""JAX param paths and layouts -> the port's state_dict.

The Flax tree keeps Dense kernels as (in, out), the conv kernel as
(kh, kw, cin, cout), LayerNorm params as scale/bias, and its blocks either
scanned (one "blocks" subtree with a leading (L, ...) axis) or unscanned
("blocks_0", "blocks_1", ...). torch wants Linear weights (out, in), conv
weights (cout, cin, kh, kw) and LayerNorm weight/bias under
vitax_torch/models/vit.py's module names.

A quantized export's int8 / fp8 kernels convert the same way: Dense (in,
out) -> (out, in), so each output channel's row is contiguous in K (the
column-major B operand of the kernel's mma); the conv stays quantized too.
Each one's scale, (1, F) or (L, 1, F) when scanned and (1, 1, 1, F) for
the conv, becomes the module's per-layer (F,) float32 `qscale`.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from vitax_torch.checkpoint.consolidate import Leaf, as_tensor, flatten_tree, unflatten_tree

# Flax leaf name -> torch leaf name ("qscale": a quantized kernel's scales)
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias", "qscale": "qscale"}
_BLOCK_KEY = re.compile(r"^blocks_(\d+)$")


def _to_torch(name: str, leaf: Leaf) -> torch.Tensor:
    t = as_tensor(leaf)
    if name == "kernel" and t.dim() == 4:     # conv (kh, kw, cin, cout)
        return t.permute(3, 2, 0, 1).contiguous()
    if name == "kernel":                      # Dense (in, out)
        return t.t().contiguous()
    if name == "qscale":                      # keepdims per-channel scales -> (F,)
        return t.reshape(-1).contiguous()
    return t.contiguous()


def _layer(node: Mapping, i: int) -> dict:
    """Layer i of a scanned block subtree."""
    return {k: _layer(v, i) if isinstance(v, Mapping) else v[i] for k, v in node.items()}


def _module(prefix: str, node: Mapping, out: Dict[str, torch.Tensor]) -> None:
    """Convert one Flax module subtree (Dense / Conv / LayerNorm / nested)."""
    for name, value in node.items():
        if isinstance(value, Mapping):
            _module(f"{prefix}{name}.", value, out)
        elif name in _LEAVES:
            out[f"{prefix}{_LEAVES[name]}"] = _to_torch(name, value)
        else:
            raise KeyError(f"unexpected param leaf {prefix}{name}")


def params_from_jax(flat: Mapping[str, Leaf],
                    scales: Optional[Mapping[str, Leaf]] = None) -> Dict[str, torch.Tensor]:
    """state_dict for VisionTransformer from the JAX package's parameters,
    keyed as in the consolidated npz ("params/...", "/"-joined), numpy
    arrays or CPU tensors. Leaves keep their stored type. `scales` (a
    quantized export's {kernel key: scales}) become the sibling `qscale`
    of each quantized kernel."""
    flat = dict(flat)
    for key, s in (scales or {}).items():
        if not key.endswith("/kernel") or key not in flat:
            raise KeyError(f"scale for {key!r}, which is no kernel of the tree")
        flat[key[:-len("kernel")] + "qscale"] = s
    tree = unflatten_tree(flat)
    if set(tree) != {"params"}:
        raise KeyError(f"expected keys under 'params/', got top-level {sorted(tree)}")
    params = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        m = _BLOCK_KEY.match(name)
        if name == "pos_embed":
            out["pos_embed"] = as_tensor(node).contiguous()
        elif name == "blocks":                 # scanned: every leaf has a leading (L, ...) axis
            depth = next(iter(flatten_tree(node).values())).shape[0]
            for i in range(depth):
                _module(f"blocks.{i}.", _layer(node, i), out)
        elif m:
            _module(f"blocks.{m.group(1)}.", node, out)
        elif name in ("patch_embed", "norm", "head"):
            _module(f"{name}.", node, out)
        else:
            raise KeyError(f"unexpected param subtree params/{name}")
    return out


def opt_state_from_jax(mu_flat: Mapping[str, Leaf], nu_flat: Mapping[str, Leaf],
                       count: Union[int, np.integer, np.ndarray]
                       ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], torch.Tensor]:
    """The AdamW state of the JAX package (optax ScaleByAdamState mu, nu and
    count) as the port's (mu, nu, count): the moments share the params' tree,
    so each converts as params_from_jax does, keyed by state_dict names;
    count becomes an int32 0-d tensor."""
    return (params_from_jax(mu_flat), params_from_jax(nu_flat),
            torch.tensor(int(np.asarray(count)), dtype=torch.int32))
