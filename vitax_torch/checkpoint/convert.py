"""JAX param paths and layouts <-> the port's state_dict.

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

The other way, params_to_jax writes a float state_dict in the JAX layout,
scanned (vitax's default: one "blocks" subtree, each leaf stacked on a
leading L axis) or unscanned, and train_state_to_jax / train_state_from_jax
carry the whole train state in the keys of a flattened JAX TrainState:
"step", "params/params/...", "opt_state/1/0/{count,mu/params/...,
nu/params/...}" and "opt_state/1/2/count" (the schedule's count).
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple, Union

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


# the keys of the AdamW state in a flattened JAX TrainState (optax chain:
# clip, then (adam, decay, schedule); the scale_by_adam state is 1/0, the
# schedule's count 1/2)
_JAX_ADAM = "opt_state/1/0/"
_JAX_SCHEDULE_COUNT = "opt_state/1/2/count"


def _to_jax(torch_leaf: str, t: torch.Tensor) -> Tuple[str, torch.Tensor]:
    """(Flax leaf name, value in the Flax layout) of one state_dict leaf."""
    t = t.detach()
    if torch_leaf == "bias":
        return "bias", t
    if torch_leaf != "weight":
        raise KeyError(f"unexpected state_dict leaf {torch_leaf!r}")
    if t.dim() == 4:                          # conv (cout, cin, kh, kw) -> (kh, kw, cin, cout)
        return "kernel", t.permute(2, 3, 1, 0)
    if t.dim() == 2:                          # Linear (out, in) -> Dense (in, out)
        return "kernel", t.t()
    return "scale", t                         # LayerNorm


def params_to_jax(sd: Mapping[str, torch.Tensor], scanned: bool = True) -> Dict[str, torch.Tensor]:
    """The JAX package's parameters from a float state_dict of
    VisionTransformer, keyed as in its npz export ("params/...",
    "/"-joined), contiguous CPU tensors. scanned=True stacks the blocks
    under "params/blocks/..." on a leading L axis (vitax's default
    scan_blocks); False writes "params/blocks_<i>/...". The inverse of
    params_from_jax."""
    out: Dict[str, torch.Tensor] = {}
    stacks: Dict[str, List[Tuple[int, torch.Tensor]]] = {}
    for name, t in sd.items():
        parts = name.split(".")
        if name == "pos_embed":
            out["params/pos_embed"] = t.detach()
            continue
        leaf, value = _to_jax(parts[-1], t)
        if parts[0] == "blocks":
            rest = "/".join(parts[2:-1] + [leaf])
            if scanned:
                stacks.setdefault(f"params/blocks/{rest}", []).append((int(parts[1]), value))
            else:
                out[f"params/blocks_{parts[1]}/{rest}"] = value
        elif parts[0] in ("patch_embed", "norm", "head"):
            out["params/" + "/".join(parts[:-1] + [leaf])] = value
        else:
            raise KeyError(f"unexpected state_dict entry {name!r}")
    for key, layers in stacks.items():
        layers.sort(key=lambda iv: iv[0])
        if [i for i, _ in layers] != list(range(len(layers))):
            raise KeyError(f"{key}: blocks {[i for i, _ in layers]} are not 0..L-1")
        out[key] = torch.stack([v for _, v in layers])
    return {k: v.to("cpu").contiguous() for k, v in out.items()}


def train_state_to_jax(sd: Mapping[str, torch.Tensor], mu: Mapping[str, torch.Tensor],
                       nu: Mapping[str, torch.Tensor], step: int, count: Union[int, torch.Tensor],
                       scanned: bool = True) -> Dict[str, torch.Tensor]:
    """The whole train state in the keys of a flattened JAX TrainState
    (its npz export with --full_state); step and both counts are int32."""
    def i32(x):
        return torch.tensor(int(x), dtype=torch.int32)
    out = {"step": i32(step)}
    out.update({"params/" + k: v for k, v in params_to_jax(sd, scanned).items()})
    out[_JAX_ADAM + "count"] = i32(count)
    for name, moments in (("mu", mu), ("nu", nu)):
        out.update({f"{_JAX_ADAM}{name}/{k}": v for k, v in params_to_jax(moments, scanned).items()})
    out[_JAX_SCHEDULE_COUNT] = i32(count)
    return out


def train_state_from_jax(flat: Mapping[str, Leaf]) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor],
                                                            Dict[str, torch.Tensor], int, torch.Tensor]:
    """(state_dict, mu, nu, step, count) from the keys of a flattened JAX
    TrainState (a --full_state npz export of either package)."""
    groups: Dict[str, Dict[str, Leaf]] = {"params": {}, "mu": {}, "nu": {}}
    for key, v in flat.items():
        for group, prefix in (("params", "params/"), ("mu", _JAX_ADAM + "mu/"), ("nu", _JAX_ADAM + "nu/")):
            if key.startswith(prefix):
                groups[group][key[len(prefix):]] = v
    missing = {"step", _JAX_ADAM + "count"} - set(flat)
    if missing or not groups["params"]:
        raise KeyError(f"not a full train state: missing {sorted(missing) or 'params/params/...'}")
    mu, nu, count = opt_state_from_jax(groups["mu"], groups["nu"], flat[_JAX_ADAM + "count"])
    return params_from_jax(groups["params"]), mu, nu, int(np.asarray(flat["step"])), count
