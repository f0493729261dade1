"""Which dim of each parameter shards over the "fsdp", "tp" and "ep" mesh
dims (vitax/parallel/rules.py), on the port's state_dict names and torch's
layouts.

The rule table is vitax's, its patterns written over the "."-joined torch
names (`blocks.0.attn.qkv.weight` for vitax's `blocks_0/attn/qkv/kernel`):
an unmatched name raises. The resolver puts "fsdp" on the largest dim
divisible by the fsdp size, as vitax does. The layouts differ: a Linear
weight is the flax kernel transposed, (out, in) for (in, out), and the
patch conv is (out, in, kh, kw) for flax's (kh, kw, in, out). vitax breaks
a tie of sizes toward the later flax dim, so the resolver ranks torch dims
by their flax position (`flax_dims`): the same elements land on the same
shard in both packages. vitax's MoE expert rule is here: at ep > 1 an
expert leaf (`blocks.<i>.moe.{w1,b1,w2,b2}`, the same layout in both
packages) puts "ep" on its experts dim 0 and "fsdp" on the largest of the
remaining dims; the router is a Linear under the dense rules. At tp > 1
vitax's Megatron classes place "tp" first: COLUMN (qkv and fc1, weight
and bias) on the flax output dim, torch dim 0 of both; ROW (the attention
proj's and fc2's weights) on the flax input dim, torch dim 1; their biases
take the dense rule. "fsdp" then takes the largest remaining dim.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Tuple

Spec = Tuple[Optional[str], ...]     # a mesh axis name or None per dim (a PartitionSpec)


# placement classes a rule can declare (vitax's)
COLUMN = "column"   # "tp" on the flax output dim (ndim - 1)
ROW = "row"         # "tp" on the flax input dim (ndim - 2)
EXPERT = "expert"   # "ep" on the experts dim 0


@dataclasses.dataclass(frozen=True)
class PathRule:
    """One ordered table entry: regex over the "."-joined parameter name
    and its placement class (COLUMN, ROW, EXPERT or None)."""
    name: str
    pattern: str
    placement: Optional[str] = None

    def matches(self, name: str) -> bool:
        return re.search(self.pattern, name) is not None

    @property
    def expert(self) -> bool:
        return self.placement == EXPERT


RULE_TABLE: Tuple[PathRule, ...] = (
    PathRule("moe-expert-weights", r"(^|\.)moe\.(?:.*\.)?(w1|b1|w2|b2)$", EXPERT),
    PathRule("megatron-column-qkv-fc1", r"(^|\.)(qkv|fc1)\.", COLUMN),
    PathRule("megatron-row-attn-proj", r"(^|\.)attn\.(?:.*\.)?proj\.weight$", ROW),
    PathRule("megatron-row-fc2", r"(^|\.)fc2\.weight$", ROW),
    PathRule("dense-default", r"(^|\.)(weight|bias|pos_embed)$"),
)


def match_rule(name: str, table: Tuple[PathRule, ...] = RULE_TABLE) -> PathRule:
    """First matching rule for a parameter name; strict (raises)."""
    for r in table:
        if r.matches(name):
            return r
    raise ValueError(f"Partition rule not found for param: {name}")


def _flax_names(name: str) -> Tuple[str, ...]:
    """The flax path of a Dense leaf's torch name in the unscanned params
    tree, as vitax's messages print it (checkpoint/convert.py maps the
    names: blocks.0 -> blocks_0, weight -> kernel)."""
    parts = re.sub(r"(^|\.)blocks\.(\d+)", r"\1blocks_\2", name).split(".")
    return ("params", *parts[:-1], "kernel" if parts[-1] == "weight" else parts[-1])


def flax_dims(name: str, ndim: int) -> Tuple[int, ...]:
    """For each torch dim of the parameter, its position in the flax layout:
    a Linear weight (out, in) is the kernel (in, out) transposed; the conv
    (out, in, kh, kw) is the kernel (kh, kw, in, out) permuted."""
    if name.endswith("weight") and ndim == 2:
        return (1, 0)
    if name.endswith("weight") and ndim == 4:
        return (3, 2, 0, 1)
    return tuple(range(ndim))


def is_expert_leaf(name: str) -> bool:
    """Whether the rule table puts "ep" on this parameter (at ep > 1)."""
    return match_rule(name).expert


def _megatron_dim(rule: PathRule, name: str, ndim: int) -> Optional[int]:
    """The torch dim of `rule`'s Megatron class: the flax output dim of a
    COLUMN leaf, the flax input dim of a ROW leaf; None for other rules."""
    if rule.placement not in (COLUMN, ROW):
        return None
    return flax_dims(name, ndim).index(ndim - 1 if rule.placement == COLUMN else ndim - 2)


def tp_dim(name: str, ndim: int) -> Optional[int]:
    """The torch dim a Megatron rule puts "tp" on (at tp > 1), else None."""
    return _megatron_dim(match_rule(name), name, ndim)


def rule_pspec(name: str, shape: Tuple[int, ...], fsdp: int, ep: int = 1, tp: int = 1,
               table: Tuple[PathRule, ...] = RULE_TABLE) -> Spec:
    """One parameter's spec from the rule table, over torch dims, for an
    fsdp dim of size `fsdp` (1 under --run_without_fsdp), an ep dim of
    size `ep` and a tp dim of size `tp`."""
    ndim = len(shape)
    if ndim == 0 or math.prod(shape) == 1:      # scalar exemption: nothing to shard
        return (None,) * ndim
    rule = match_rule(name, table)
    spec: list = [None] * ndim
    first = 0
    if ep > 1 and rule.expert:
        if shape[0] % ep:
            raise ValueError(f"ep: experts dim 0 of {name} {tuple(shape)} not divisible by ep={ep}")
        spec[0], first = "ep", 1                 # fsdp picks among the remaining dims
    order = flax_dims(name, ndim)
    megatron = _megatron_dim(rule, name, ndim)
    if tp > 1 and megatron is not None:
        if shape[megatron] % tp:
            # vitax's assertion (flax dim, flax names and shape)
            flax_shape = tuple(shape[order.index(i)] for i in range(ndim))
            raise ValueError(f"TP: dim {order[megatron]} of {_flax_names(name)} {flax_shape} not divisible by "
                             f"tp={tp}")
        spec[megatron] = "tp"
    if fsdp > 1:
        # the largest free dim divisible by the fsdp size, ties to the later
        # flax dim; small indivisible params get no fsdp dim
        candidates = [(shape[d], order[d], d) for d in range(first, ndim)
                      if spec[d] is None and shape[d] % fsdp == 0 and shape[d] >= fsdp]
        if candidates:
            spec[max(candidates)[2]] = "fsdp"
    return tuple(spec)
