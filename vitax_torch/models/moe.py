"""Mixture-of-Experts MLP (vitax/models/moe.py MoeMlp), with expert
parallelism over the mesh's "ep" dim.

The Switch / GShard formulation of the JAX module, op for op:

- router: an f32 Linear on x in f32, then softmax; top-1 is the max and
  the first argmax; top-2 masks the first choice and renormalizes both
  gates, g / (g1 + g2 + 1e-9);
- capacity: C = ceil(capacity_factor * N / E) slots an expert per sample;
  a token's slot is its rank among the sample's tokens routed to that
  expert (a cumsum over the token axis), and under top-2 every first
  choice ranks before every second choice (the count1 offset); tokens past
  C are dropped (their MoE output is 0, the block's residual passes them);
- load balance: each block returns frac_tokens (the share of first choices
  an expert takes) and mean_prob (its mean router probability), both (E,),
  as values: the step averages them over the batch (and the microbatches)
  before it forms E * sum(frac * prob), and a recomputed block under
  checkpoint returns them again instead of appending to a list twice;
- experts: the leaves w1 (E, D, H), b1 (E, H), w2 (E, H, D), b2 (E, D) in
  vitax's layout, float32, cast to the compute dtype at use; each expert
  is Dense -> exact GELU -> Dense on its (B, C) slots, one batched matmul
  over the experts.

Two dispatch and combine forms (--moe_impl), as in vitax:

- "einsum": the (B, N, E, C) combine tensor, built in the compute dtype
  (gate at the token's (expert, slot)); dispatch is combine > 0; dispatch
  and combine are einsums;
- "gather": the source token of each (expert, slot) scattered into a
  (B, E*C) index map, then gathers move the D-wide rows, with no (B, N, E,
  C) tensor; its backward is a scatter-add over the same unique indices.

Expert parallelism (an `ExpertShard`, parallel/mesh.py): each rank of the
ep group holds E/ep experts (parallel/sharding.py makes the leaves
DTensors sharded on the experts dim) and routes its own batch rows to
all E. One all-to-all over the group sends expert j's slots to its owner,
which runs its experts on every peer's rows; the inverse all-to-all brings
the outputs back (torch.distributed.nn.functional.all_to_all_single,
whose backward is the inverse exchange): the hand-written form of vitax's
manual_ep pair. Routing, capacity and the outputs are those of the
unsharded model on the global batch, since capacity is per sample.

Sequence parallelism (a `TokenShard`, parallel/mesh.py): the rank holds
the slice [i N/S, (i + 1) N/S) of every sample's tokens, and vitax's MoE
runs on the whole (B, N, D) activation, so the capacity is
C = ceil(cf * N / E) over the whole sequence, and a token's slot position
is its rank among all of its sample's tokens routed to that expert: the
rank's own cumsum after the lower sp ranks' tokens of the same sample and
expert, and under top-2 every second choice after the sample's whole
first-choice count and the lower ranks' second choices. The offsets come
from one all-reduce a block of the (K, B, E) per-slice choice counts, each
rank's in its own row (`sequence_counts`); the recompute of a
checkpointed block issues it again, in the same order on every rank. A
kept token's expert output depends on its own row only, so the expert
batches stay on the rank: its (E, B, C, D) buffer holds its kept tokens
at their rank-local slots (first choices from 0, second choices after the
slice's first-choice count), which stay below C and unique wherever the
whole-sequence position is below C, so a rank whose tokens take all of an
expert's C slots still fits. frac_tokens and mean_prob stay means over
the rank's tokens: every rank holds as many, so the step's mean over the
processes is vitax's mean over the global (B, N).

Tensor parallelism: vitax's rule table puts no "tp" on an expert leaf and
the block's MoE input is the whole (replicated) activation, so every tp
rank runs the whole MoE (models/vit.py Block), its experts replicated over
tp and, at ep > 1, sharded over the ep group of the ranks that share its
tp index.

No Pallas kernel computes any of this in the JAX package: every op here is
a PyTorch einsum, bmm or index op.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vitax_torch.parallel.ulysses import exchange

EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


class Choice(NamedTuple):
    """One routing choice (first or second) of every token: its gate, kept
    flag (its slot position over the whole sequence, vitax's slot, below
    C), expert and slot in the rank's buffer, each (B, N), and its one-hot
    (B, N, E) f32."""
    gate: torch.Tensor
    keep: torch.Tensor
    expert: torch.Tensor
    onehot: torch.Tensor
    slot: torch.Tensor


def capacity(num_experts: int, tokens: int, capacity_factor: float) -> int:
    """The static slots an expert per sample: ceil(cf * N / E), at least 1."""
    return max(1, math.ceil(capacity_factor * tokens / num_experts))


def _slots(onehot: torch.Tensor, offset, shift, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot, keep), each (B, N): the token's rank among the slice's tokens
    routed to its expert after `offset` slots taken before it in the rank's
    buffer; kept where that plus `shift` more over the whole sequence (its
    slot position there) is below c. offset and shift are (B, 1, E) or
    scalars."""
    rank = torch.cumsum(onehot, dim=1) * onehot
    slot = (rank + offset * onehot).sum(dim=-1) - 1.0
    return slot.to(torch.int32), slot + (shift * onehot).sum(dim=-1) < c


def sequence_counts(counts: torch.Tensor, shard) -> Tuple[torch.Tensor, torch.Tensor]:
    """(before, total), each (K, B, E): the per-(choice, sample, expert)
    counts of the sp ranks below `shard.index` (a TokenShard) and of the
    whole group, from the rank's `counts` of its token slice. One
    all-reduce over the group of every rank's counts in its own row; every
    rank issues it in the same order."""
    from torch.distributed.nn.functional import all_reduce
    rows = counts.new_zeros((shard.count, *counts.shape))
    rows[shard.index] = counts
    rows = all_reduce(rows, group=shard.group)
    return rows[:shard.index].sum(dim=0), rows.sum(dim=0)


def route(probs: torch.Tensor, top_k: int, c: int,
          sequence: Optional[Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]] = None) -> List[Choice]:
    """The top-1 or top-2 choices of every token from router probabilities
    (B, N, E), with their capacity slots. `sequence` places a token slice
    in its samples' whole sequences: given the slice's choice counts (K, B,
    E) it returns the lower slices' counts and the whole sequence's
    (`sequence_counts` over the rank's TokenShard); None: the tokens are
    whole."""
    e = probs.shape[-1]
    gate1, expert1 = probs.max(dim=-1)
    onehot1 = _one_hot_slot(expert1, e, torch.float32)     # F.one_hot reads the index range back on the CPU
    if top_k not in (1, 2):
        raise ValueError(f"moe top_k must be 1 or 2, got {top_k}")
    onehots = [onehot1]
    if top_k == 2:
        gate2, expert2 = (probs * (1.0 - onehot1)).max(dim=-1)
        onehots.append(_one_hot_slot(expert2, e, torch.float32))
    counts = torch.stack([oh.sum(dim=1) for oh in onehots])                # (K, B, E) over the slice
    before, total = (torch.zeros_like(counts), counts) if sequence is None else sequence(counts)
    counts, before, total = (t[:, :, None, :] for t in (counts, before, total))     # (K, B, 1, E)
    slot1, keep1 = _slots(onehot1, 0.0, before[0], c)
    if top_k == 1:
        return [Choice(gate1, keep1, expert1, onehot1, slot1)]
    onehot2 = onehots[1]
    denom = gate1 + gate2 + 1e-9
    # second choices queue behind every first choice of the sample (the
    # slice's in the buffer, the whole sequence's in position), then the
    # lower slices' second choices
    slot2, keep2 = _slots(onehot2, counts[0], total[0] + before[1] - counts[0], c)
    return [Choice(gate1 / denom, keep1, expert1, onehot1, slot1),
            Choice(gate2 / denom, keep2, expert2, onehot2, slot2)]


def _one_hot_slot(slot: torch.Tensor, c: int, dtype: torch.dtype) -> torch.Tensor:
    """jax.nn.one_hot(slot, c): all zeros where slot is out of [0, c)."""
    return (slot[..., None] == torch.arange(c, device=slot.device)).to(dtype)


def combine_tensor(choices: List[Choice], c: int, dtype: torch.dtype) -> torch.Tensor:
    """The einsum impl's (B, N, E, C) combine in `dtype`: gate * keep at
    each token's (expert, slot), summed over the choices (whose slots are
    disjoint)."""
    out = 0
    for ch in choices:
        out = out + ((ch.gate * ch.keep).to(dtype)[:, :, None, None] * ch.onehot.to(dtype)[:, :, :, None]
                     * _one_hot_slot(ch.slot, c, dtype)[:, :, None, :])
    return out


def _slot_ids(choices: List[Choice], e: int, c: int) -> List[torch.Tensor]:
    """Per choice, the flattened slot id (B, N): expert * C + slot for kept
    tokens, a unique out-of-range sentinel E*C + token for dropped ones."""
    n = choices[0].gate.shape[1]
    tok = torch.arange(n, dtype=torch.int64, device=choices[0].gate.device)[None, :]
    return [torch.where(ch.keep, ch.expert.to(torch.int64) * c + ch.slot.to(torch.int64), e * c + tok)
            for ch in choices]


def dispatch_gather(x: torch.Tensor, choices: List[Choice], e: int, c: int) -> torch.Tensor:
    """(B, N, D) -> (B, E, C, D): each slot's source token row, zero where
    no token fills it. The sentinels land in N scratch columns past E*C."""
    b, n, d = x.shape
    src = torch.full((b, e * c + n), n, dtype=torch.int64, device=x.device)
    tok = torch.arange(n, dtype=torch.int64, device=x.device).expand(b, n)
    for flat in _slot_ids(choices, e, c):
        src.scatter_(1, flat, tok)
    src = src[:, :e * c]
    valid = src < n
    xe = torch.gather(x, 1, torch.where(valid, src, 0)[:, :, None].expand(b, e * c, d))
    xe = torch.where(valid[:, :, None], xe, torch.zeros((), dtype=x.dtype, device=x.device))
    return xe.reshape(b, e, c, d)


def combine_gather(ye: torch.Tensor, choices: List[Choice], e: int, c: int) -> torch.Tensor:
    """(B, E, C, D) -> (B, N, D): each token's slot row times its gate
    (gate * keep, so a dropped token's clamped index adds 0)."""
    b, d = ye.shape[0], ye.shape[-1]
    n = choices[0].gate.shape[1]
    ye_flat = ye.reshape(b, e * c, d)
    out = torch.zeros((b, n, d), dtype=ye.dtype, device=ye.device)
    for flat, ch in zip(_slot_ids(choices, e, c), choices):
        y = torch.gather(ye_flat, 1, torch.where(ch.keep, flat, 0)[:, :, None].expand(b, n, d))
        out = out + (ch.gate * ch.keep).to(ye.dtype)[:, :, None] * y
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    """The rank's experts of an expert leaf: a DTensor's local shard
    (differentiable), any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


class MoeMlp(nn.Module):
    """(B, N, D) -> ((B, N, D), frac_tokens (E,), mean_prob (E,)): the block
    MLP routed over `num_experts` experts. `expert_shard` (parallel/mesh.py
    ExpertShard) runs it expert-parallel over the ep group; `token_shard`
    (a TokenShard) places its (B, N/S, D) input in the whole sequence,
    whose N sets the capacity and orders the slots."""

    def __init__(self, dim: int, hidden_dim: int, num_experts: int, dtype: torch.dtype,
                 capacity_factor: float = 1.25, top_k: int = 1, impl: str = "einsum", device=None,
                 expert_shard=None, token_shard=None):
        super().__init__()
        if impl not in ("einsum", "gather"):
            raise ValueError(f"unknown moe_impl {impl!r}")
        from vitax_torch.models.vit import Linear
        self.dtype = dtype
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.top_k = top_k
        self.impl = impl
        self.expert_shard = expert_shard
        self.token_shard = token_shard
        self.router = Linear(dim, num_experts, device=device)
        self.w1 = nn.Parameter(torch.empty(num_experts, dim, hidden_dim, device=device))
        self.b1 = nn.Parameter(torch.empty(num_experts, hidden_dim, device=device))
        self.w2 = nn.Parameter(torch.empty(num_experts, hidden_dim, dim, device=device))
        self.b2 = nn.Parameter(torch.empty(num_experts, dim, device=device))

    def experts(self, xe: torch.Tensor) -> torch.Tensor:
        """The experts on (E, M, D) rows in the compute dtype: Dense -> exact
        GELU -> Dense, batched over the rank's experts (all E unsharded)."""
        dt = self.dtype
        w1, b1, w2, b2 = (_local(getattr(self, n)).to(dt) for n in EXPERT_LEAVES)
        if self.expert_shard is None:
            return self._mlp(xe, w1, b1, w2, b2)
        group, ep = self.expert_shard.group, self.expert_shard.count
        e, m, d = xe.shape
        el = e // ep
        # expert j's rows to rank j; chunk i back is peer i's rows for my experts
        xr = exchange(xe.reshape(ep, el, m, d), group)                       # (ep, E/ep, M, D)
        y = self._mlp(xr.transpose(0, 1).reshape(el, ep * m, d), w1, b1, w2, b2)
        y = exchange(y.reshape(el, ep, m, -1).transpose(0, 1), group)      # peer i's outputs to peer i
        return y.reshape(e, m, -1)

    @staticmethod
    def _mlp(xe, w1, b1, w2, b2) -> torch.Tensor:
        h = F.gelu(torch.baddbmm(b1[:, None, :], xe, w1))
        return torch.baddbmm(b2[:, None, :], h, w2)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        b, n, d = x.shape
        e, dt = self.num_experts, self.dtype
        shard = self.token_shard
        c = capacity(e, n if shard is None else n * shard.count, self.capacity_factor)
        probs = torch.softmax(self.router(x.float(), torch.float32), dim=-1)      # (B, N, E) f32
        choices = route(probs, self.top_k, c, None if shard is None else partial(sequence_counts, shard=shard))
        frac = choices[0].onehot.mean(dim=(0, 1))
        prob = probs.mean(dim=(0, 1))
        x = x.to(dt)
        if self.impl == "gather":
            xe = dispatch_gather(x, choices, e, c)                                # (B, E, C, D)
            ye = self.experts(xe.transpose(0, 1).reshape(e, b * c, d))
            out = combine_gather(ye.reshape(e, b, c, -1).transpose(0, 1), choices, e, c)
        else:
            combine = combine_tensor(choices, c, dt)                              # (B, N, E, C)
            dispatch = (combine > 0).to(dt)
            xe = torch.einsum("bnec,bnd->ebcd", dispatch, x)                      # (E, B, C, D)
            ye = self.experts(xe.reshape(e, b * c, d))
            out = torch.einsum("bnec,ebcd->bnd", combine, ye.reshape(e, b, c, -1))
        return out, frac, prob
