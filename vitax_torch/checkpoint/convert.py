"""JAX param paths and layouts -> the port's state_dict.

The Flax tree keeps Dense kernels as (in, out), the conv kernel as
(kh, kw, cin, cout), LayerNorm params as scale/bias, and its blocks either
scanned (one "blocks" subtree with a leading (L, ...) axis) or unscanned
("blocks_0", "blocks_1", ...). torch wants Linear weights (out, in), conv
weights (cout, cin, kh, kw) and LayerNorm weight/bias under
vitax_torch/models/vit.py's module names.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from vitax_torch.checkpoint.consolidate import flatten_tree, unflatten_tree

Leaf = Union[np.ndarray, torch.Tensor]

# Flax leaf name -> torch leaf name
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_BLOCK_KEY = re.compile(r"^blocks_(\d+)$")


def _as_tensor(leaf: Leaf) -> torch.Tensor:
    if isinstance(leaf, np.ndarray) and not leaf.flags.writeable:
        leaf = leaf.copy()                    # torch refuses to alias read-only arrays silently
    return torch.as_tensor(leaf)


def _to_torch(name: str, leaf: Leaf) -> torch.Tensor:
    t = _as_tensor(leaf)
    if name == "kernel" and t.dim() == 4:     # conv (kh, kw, cin, cout)
        return t.permute(3, 2, 0, 1).contiguous()
    if name == "kernel":                      # Dense (in, out)
        return t.t().contiguous()
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


def params_from_jax(flat: Mapping[str, Leaf]) -> Dict[str, torch.Tensor]:
    """state_dict for VisionTransformer from the JAX package's parameters,
    keyed as in the consolidated npz ("params/...", "/"-joined), numpy
    arrays or CPU tensors. Leaves keep their stored type."""
    tree = unflatten_tree(dict(flat))
    if set(tree) != {"params"}:
        raise KeyError(f"expected keys under 'params/', got top-level {sorted(tree)}")
    params = tree["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        m = _BLOCK_KEY.match(name)
        if name == "pos_embed":
            out["pos_embed"] = _as_tensor(node).contiguous()
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
