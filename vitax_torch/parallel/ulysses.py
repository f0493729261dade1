"""Ulysses sequence parallelism: all-to-all head<->token resharding
(vitax/parallel/ulysses.py; DeepSpeed-Ulysses, arXiv:2309.14509).

Activations arrive with the token axis sharded over the S ranks of an sp
group. One all-to-all turns the (B, N/S, H, Dh) shards of q, k and v,
stacked so that it is one collective, into (B, N, H/S, Dh): every token of
H/S heads, rank j holding heads [j H/S, (j + 1) H/S). The whole-sequence
core runs on that head slice (the whole-N kernels, or the streaming ones
past MAX_SEQ_IN_VMEM, as make_attention_impl picks them for N), and a
second all-to-all restores the token sharding. Both are
torch.distributed.nn.functional.all_to_all_single, differentiable: the
backward runs the inverse exchange. Against the ring: two all-to-alls and
one local core, but num_heads must divide over S and each rank holds the
whole sequence's K/V for its heads.

Under dropout the inner core's mask index is the local (b, h) block, which
every rank shares, so the seed is folded over the batch and sp coordinates
(train/step.py), as vitax's fold_shard_seed folds (dp, fsdp, sp), and
under tensor parallelism over tp after them ((dp, fsdp, sp, tp), vitax's
order). Under tp the heads exchanged are the rank's H/tp (models/vit.py),
so (H/tp) % S must hold: make_attention_impl takes Ulysses only when sp *
tp divides num_heads, as vitax does, and the ring otherwise.
"""

from __future__ import annotations

from typing import Callable

import torch


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    """all_to_all_single over `group` of a (S, ...) tensor: chunk j goes to
    rank j, chunk i of the result came from rank i. Differentiable."""
    from torch.distributed.nn.functional import all_to_all_single
    x = x.contiguous()
    return all_to_all_single(torch.empty_like(x), x, group=group)


def ulysses_local(q, k, v, inner: Callable, group) -> torch.Tensor:
    """q, k, v (B, n, H, Dh) local token shards -> o (B, n, H, Dh): scatter
    heads and gather tokens in one all-to-all, the whole-sequence `inner`
    on (B, S n, H/S, Dh), then the inverse all-to-all."""
    import torch.distributed as dist
    count = dist.get_world_size(group)
    b, n, h, dh = q.shape
    hl = h // count
    qkv = torch.stack([q, k, v]).view(3, b, n, count, hl, dh).permute(3, 0, 1, 2, 4, 5)
    qkv = exchange(qkv, group)                                   # (S, 3, B, n, H/S, Dh), token block i from rank i
    qkv = qkv.permute(1, 2, 0, 3, 4, 5).reshape(3, b, count * n, hl, dh)
    o = inner(qkv[0], qkv[1], qkv[2])                             # (B, N, H/S, Dh)
    o = exchange(o.reshape(b, count, n, hl, dh).permute(1, 0, 2, 3, 4), group)   # head group i from rank i
    return o.permute(1, 2, 0, 3, 4).reshape(b, n, h, dh)


def make_ulysses_attention(group, inner: Callable) -> Callable:
    """(B, n, H, Dh) -> (B, n, H, Dh) with tokens sharded over `group`
    outside and heads inside; `inner` is the whole-sequence core."""
    def ulysses_attention(q, k, v):
        return ulysses_local(q, k, v, inner, group)
    ulysses_attention.vitax_name = "ulysses all-to-all (sp)"
    return ulysses_attention


def make_ulysses_dropout(group, inner_drop: Callable) -> Callable:
    """Ulysses with the whole-sequence dropout core inner_drop(q, k, v,
    seed) on the head slice; the seed comes folded over (batch, sp)."""
    def ulysses_dropout(q, k, v, seed):
        return ulysses_local(q, k, v, lambda a, b, c: inner_drop(a, b, c, seed), group)
    return ulysses_dropout
