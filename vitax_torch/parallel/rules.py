"""Which dim of each parameter shards over the "fsdp" and "ep" mesh dims
(vitax/parallel/rules.py), on the port's state_dict names and torch's
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
remaining dims; the router is a Linear under the dense rules. vitax's tp
placements (the Megatron column and row classes of the first three rules)
come with TP (ROADMAP item 11); Config.validate refuses tp > 1 until then.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Tuple

Spec = Tuple[Optional[str], ...]     # a mesh axis name or None per dim (a PartitionSpec)


@dataclasses.dataclass(frozen=True)
class PathRule:
    """One ordered table entry: regex over the "."-joined parameter name;
    `expert` marks the leaves "ep" shards on their experts dim."""
    name: str
    pattern: str
    expert: bool = False

    def matches(self, name: str) -> bool:
        return re.search(self.pattern, name) is not None


RULE_TABLE: Tuple[PathRule, ...] = (
    PathRule("megatron-column-qkv-fc1", r"(^|\.)(qkv|fc1)\."),
    PathRule("megatron-row-attn-proj", r"(^|\.)attn\.(?:.*\.)?proj\.weight$"),
    PathRule("megatron-row-fc2", r"(^|\.)fc2\.weight$"),
    PathRule("moe-expert-weights", r"(^|\.)moe\.(?:.*\.)?(w1|b1|w2|b2)$", expert=True),
    PathRule("dense-default", r"(^|\.)(weight|bias|pos_embed)$"),
)


def match_rule(name: str, table: Tuple[PathRule, ...] = RULE_TABLE) -> PathRule:
    """First matching rule for a parameter name; strict (raises)."""
    for r in table:
        if r.matches(name):
            return r
    raise ValueError(f"Partition rule not found for param: {name}")


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


def rule_pspec(name: str, shape: Tuple[int, ...], fsdp: int, ep: int = 1,
               table: Tuple[PathRule, ...] = RULE_TABLE) -> Spec:
    """One parameter's spec from the rule table, over torch dims, for an
    fsdp dim of size `fsdp` (1 under --run_without_fsdp) and an ep dim of
    size `ep`."""
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
    if fsdp > 1:
        # the largest dim divisible by the fsdp size, ties to the later flax
        # dim; small indivisible params get no fsdp dim
        order = flax_dims(name, ndim)
        candidates = [(shape[d], order[d], d) for d in range(first, ndim)
                      if shape[d] % fsdp == 0 and shape[d] >= fsdp]
        if candidates:
            spec[max(candidates)[2]] = "fsdp"
    return tuple(spec)
