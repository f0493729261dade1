"""Tensor parallelism over the mesh's "tp" dim: vitax's Megatron placements
(vitax/parallel/rules.py COLUMN and ROW; Megatron-LM, arXiv:1909.08053)
run with whole heads on each rank.

vitax states TP as placements and lets GSPMD insert the collectives. The
port keeps the placements (parallel/sharding.py shard_tp: the qkv and
fc1 weights and biases sharded contiguously on their output dim, the
attention proj's and fc2's weights on their input dim) and writes the
collectives out, one autograd Function each:

- `copy_to_tp` before the qkv and fc1 products: identity forward, the
  input's grad all-reduced over the tp group in the backward (each rank's
  columns give a partial grad of the replicated input);
- `reduce_from_tp` after the proj and fc2 products: the row-parallel
  partial sums all-reduced in the forward, identity backward. The
  replicated bias is added after the reduction, so it is added once.
- `relayout_qkv`: the whole heads. vitax's contiguous qkv shard does not
  align with heads: rows [r 3D/tp, (r + 1) 3D/tp) of the fused (3D, D)
  weight, ordered (q, k, v) x heads, so at tp 2 rank 0 holds all of q and
  half of k. The attention kernels take (B, N, H/tp, Dh) for heads [r
  H/tp, (r + 1) H/tp), so each rank needs the q, k and v rows of its
  heads: 3 D/tp rows. One uneven all-to-all of the gathered weight (its
  bias riding as one more column) hands every rank those rows in (q, k,
  v) order; its backward is the inverse all-to-all of their grads. The
  other choice, an all-to-all of the qkv output (B, N, 3D/tp a rank),
  moves B N / D times the weight's elements: 1.6 times at the 10B width
  (D 5120) with 32 images of 256 tokens a rank, and more at larger
  batches. One call a block forward (again in its recompute), one a block
  backward (`CALLS`).

The attention output (B, N, H/tp, Dh) is then heads-contiguous, which is
the row-parallel proj's input layout, so proj and fc2 need no relayout.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

# collectives issued: "relayout" and "all_reduce" in the forward (1 and 2 a
# block), "relayout_bwd" and "all_reduce_bwd" in the backward (1 and 2)
CALLS = {"relayout": 0, "all_reduce": 0, "relayout_bwd": 0, "all_reduce_bwd": 0}


def reset_calls() -> None:
    for key in CALLS:
        CALLS[key] = 0


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """A SUM all-reduce of a contiguous copy of x over `group`."""
    import torch.distributed as dist
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        CALLS["all_reduce_bwd"] += 1
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        CALLS["all_reduce"] += 1
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, shard) -> torch.Tensor:
    """The replicated input of a column-parallel product: its backward sums
    the ranks' partial grads over the tp group."""
    return _CopyToTP.apply(x, shard.group)


def reduce_from_tp(x: torch.Tensor, shard) -> torch.Tensor:
    """The sum over the tp group of a row-parallel partial product."""
    return _ReduceFromTP.apply(x, shard.group)


def head_rows(rows: int, count: int, index: int) -> torch.Tensor:
    """The global rows of a fused (3D, ...) qkv leaf, (q, k, v) sections of
    D rows with heads contiguous in each, that hold tp rank `index`'s
    heads: the D/count rows of its head group in q, then in k, then in v."""
    d = rows // 3
    part = d // count
    return torch.cat([torch.arange(s * d + index * part, s * d + (index + 1) * part) for s in range(3)])


class RelayoutPlan(NamedTuple):
    """One rank's uneven all-to-all: its local rows in send order (grouped
    by destination, each group in global row order), the row counts it
    sends to and receives from each rank."""
    order: torch.Tensor
    send: Tuple[int, ...]
    recv: Tuple[int, ...]


@functools.lru_cache(maxsize=None)
def relayout_plan(rows: int, count: int, index: int) -> RelayoutPlan:
    """The all-to-all that turns rank `index`'s contiguous rows [index
    rows/count, (index + 1) rows/count) of a fused qkv leaf into the rows
    of its heads (`head_rows`). Sources send in global row order, so the
    received rows, concatenated by source, are in head_rows' order."""
    local = rows // count
    d = rows // 3

    def owner(r: torch.Tensor) -> torch.Tensor:         # the tp rank whose heads row r serves
        return (r % d) // (d // count)

    held = torch.arange(index * local, (index + 1) * local)
    dest = owner(held)
    order = torch.argsort(dest, stable=True)
    send = tuple(int(c) for c in torch.bincount(dest, minlength=count))
    recv = tuple(int(  # vtx: ignore[VTX102] host tensors of a plan built once, not the step
        (owner(torch.arange(a * local, (a + 1) * local)) == index).sum()) for a in range(count))
    return RelayoutPlan(order, send, recv)


class _Relayout(torch.autograd.Function):
    """The qkv rows of a rank's contiguous shard -> the rows of its heads
    (uneven all_to_all_single); the backward sends the grads back."""

    @staticmethod
    def forward(ctx, x, group, plan: RelayoutPlan):
        import torch.distributed as dist
        CALLS["relayout"] += 1
        send = x.index_select(0, plan.order.to(x.device))
        out = send.new_empty((sum(plan.recv),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, send, list(plan.recv), list(plan.send), group=group)
        ctx.group, ctx.plan = group, plan
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        CALLS["relayout_bwd"] += 1
        plan = ctx.plan
        g = g.contiguous()
        back = g.new_empty((sum(plan.send),) + tuple(g.shape[1:]))
        dist.all_to_all_single(back, g, list(plan.send), list(plan.recv), group=ctx.group)
        grad = torch.empty_like(back)
        grad.index_copy_(0, plan.order.to(g.device), back)
        return grad, None, None


def tp_piece(t: torch.Tensor) -> torch.Tensor:
    """The rank's piece of a Megatron leaf, differentiable: the local tensor
    of the tp DTensor FSDP2 gathered (a plain tensor is the piece itself)."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def qkv_rows(attn, dtype: torch.dtype) -> torch.Tensor:
    """The rank's local rows of the fused qkv weight with its bias as one
    more column, (3D/tp, D + 1) in `dtype` (after FSDP2's gather: the
    tp-local tensor of the DTensor param)."""
    w, b = tp_piece(attn.qkv.weight), tp_piece(attn.qkv.bias)
    return torch.cat([w.to(dtype), b.to(dtype)[:, None]], dim=1)


def relayout_qkv(attn, shard, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight (3D/tp, D), bias (3D/tp,)) of the rank's heads, in `dtype`:
    the q, k and v rows of heads [index H/tp, (index + 1) H/tp)."""
    rows = qkv_rows(attn, dtype)
    out = _Relayout.apply(rows, shard.group, relayout_plan(rows.shape[0] * shard.count, shard.count, shard.index))
    return out[:, :-1].contiguous(), out[:, -1]


def tp_local(name: str, full: torch.Tensor, count: int, index: int) -> torch.Tensor:
    """Rank `index`'s contiguous piece of a Megatron leaf (a view), the
    whole tensor for any other leaf: vitax's placement, as shard_tp cuts it."""
    from vitax_torch.parallel.rules import tp_dim
    dim = tp_dim(name, full.dim())
    return full if dim is None else full.chunk(count, dim=dim)[index]
