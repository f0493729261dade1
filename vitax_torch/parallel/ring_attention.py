"""Ring attention: sequence parallelism over the "sp" dim
(vitax/parallel/ring_attention.py).

The token axis of the activations is sharded over the S ranks of an sp
group. Each rank keeps its queries and streams the K/V blocks around the
ring: at step t it holds the block that started on rank (index - t) mod S,
computes that block product with the with-lse kernels, and merges it into
its running result through the two logsumexps (`_merge`, blockwise
attention as in Ring Attention, arXiv:2310.01889). The (N, N) scores never
exist, and a rank holds O(N/S) activations and two K/V blocks.

- **One rotation a step, S - 1 a forward.** K and V ride one stacked (2,
  B, N/S, H, Dh) buffer, so each step is one shift, and the last block
  computes without one. `ROTATIONS` counts them, forward and backward.
- **The shift** (`GroupShift`) sends the buffer to rank index + 1 and
  receives from index - 1 in one `batch_isend_irecv` of an isend and an
  irecv, so no rank blocks on another. It runs inside an autograd Function
  (`_Shift`) whose backward is the reverse shift of the cotangent, as JAX
  transposes ppermute. The next block's shift is issued before the current
  block product and waited on after it is enqueued: on NCCL the transfer
  runs on its own stream beside the kernel. Over gloo a card tensor goes
  through host buffers, and the shift completes when it is issued. A
  checkpointed block's recompute issues its shifts again, in the same
  order on every rank.
- **The block product** takes the local length n = N/S, as vitax passes
  its local nq: the whole-N entry (`flash4_with_lse`, kernels A1/A2) up to
  MAX_SEQ_IN_VMEM, the streaming one (`blocked_bh_with_lse` on BH views,
  A4/A5a/A5b) past it; on the CPU each entry runs its plain version. The
  merge is plain autograd, so the entries see a nonzero lse cotangent.
  Under --no_flash_attention the product is the dense plain version.
- **Dropout.** Step t of rank r masks its product at the global offsets
  (q0, k0) = (r n, ((r - t) mod S) n), so every (q, k) pair is decided
  once, at its global coordinates, and ring dropout equals whole-sequence
  masked attention at the same seed. The seed is folded over the batch
  shard (and the tp index under tensor parallelism, whose ranks hold
  other heads; train/step.py), never over sp.

The rotation and the block function are parameters of the local body
(`ring_attention_local`), as in vitax: `LoopBack` runs the same body for S
virtual shards in one process (the card's check of the ring, where one
card holds no sp group).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from vitax_torch.ops.attention import (
    MAX_SEQ_IN_VMEM,
    Dropout,
    _from_bh,
    _seedvec,
    _to_bh,
    attention_fwd_with_lse,
    flash4_dropout_lse,
    flash4_with_lse,
)

# shifts issued: "forward" in the forward (S - 1 a ring forward), "backward"
# in the backward (the reverse shifts)
ROTATIONS = {"forward": 0, "backward": 0}


def reset_rotations() -> None:
    for key in ROTATIONS:
        ROTATIONS[key] = 0


class GroupShift:
    """The rotation over an sp process group: rank `index` of the group
    sends to index + 1 and receives from index - 1 (mod `count`). gloo
    cannot send a card tensor: over a gloo group a card tensor travels
    through host buffers and the shift completes before start() returns
    (as parallel/pipeline.py's Hop stages its hops)."""

    def __init__(self, group):
        import torch.distributed as dist
        self.group = group
        self.gloo = str(dist.get_backend(group)) == "gloo"
        self.index = dist.get_rank(group)
        self.count = dist.get_world_size(group)
        self._peers = {d: (dist.get_global_rank(group, (self.index + d) % self.count),
                           dist.get_global_rank(group, (self.index - d) % self.count)) for d in (1, -1)}

    def start(self, x: torch.Tensor, direction: int) -> Tuple[torch.Tensor, list]:
        """Send `x` one step in `direction` (+1 or -1) and receive the
        neighbour's into a new buffer: (buffer, the batch's works)."""
        import torch.distributed as dist
        to, frm = self._peers[direction]
        staged = self.gloo and x.is_cuda
        send = x.to("cpu") if staged else x
        buf = torch.empty_like(send)
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, to, self.group),
                                        dist.P2POp(dist.irecv, buf, frm, self.group)])
        if not staged:
            return buf, works
        for work in works:
            work.wait()
        return buf.to(x.device), []

    def shift(self, kv: torch.Tensor) -> Tuple[torch.Tensor, Callable[[], None]]:
        """(the neighbour's block, wait): the shift is issued; wait() makes
        the caller's stream (on the CPU, the host) wait for it."""
        pending: list = []
        nxt = _Shift.apply(kv, self, pending)

        def wait():
            for work in pending:
                work.wait()
        return nxt, wait


class _Shift(torch.autograd.Function):
    """One rotation to index + 1, differentiable: the backward sends the
    cotangent back to index - 1. The forward returns the receive buffer
    with the transfer in flight; its works go to `pending`."""

    @staticmethod
    def forward(ctx, x, ring: GroupShift, pending: list):
        buf, works = ring.start(x.contiguous(), +1)
        pending.extend(works)
        ROTATIONS["forward"] += 1
        ctx.ring = ring
        return buf

    @staticmethod
    def backward(ctx, g):
        buf, works = ctx.ring.start(g.contiguous(), -1)
        for work in works:
            work.wait()
        ROTATIONS["backward"] += 1
        return buf, None, None


class LoopBack:
    """The rotation of virtual shard `index` among S shards in one
    process: its t-th shift hands it the stacked K/V block of shard
    (index - t) mod S from `blocks` (differentiable, no copy), counted in
    ROTATIONS as a real shift is."""

    def __init__(self, blocks: Sequence[torch.Tensor], index: int):
        self.blocks = blocks
        self.index = index
        self.count = len(blocks)
        self._shifts = 0

    def shift(self, kv: torch.Tensor) -> Tuple[torch.Tensor, Callable[[], None]]:
        self._shifts += 1
        ROTATIONS["forward"] += 1
        return self.blocks[(self.index - self._shifts) % self.count], lambda: None


def _merge(o, lse, o_blk, lse_blk):
    """Combine two softmax-normalized partial results through their
    logsumexps: o (B, N, H, Dh) float32, lse (B, H, N)."""
    lse_new = torch.logaddexp(lse, lse_blk)
    w = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w_blk = torch.exp(lse_blk - lse_new).transpose(1, 2)[..., None]
    return o * w + o_blk * w_blk, lse_new


def dense_block(q, k, v, scale: float):
    """The plain block product under plain autograd (--no_flash_attention,
    vitax's _dense_block): (o, lse (B, H, n))."""
    return attention_fwd_with_lse(q, k, v, scale)


def dense_block_drop(q, k, v, seedvec, scale: float, rate: float):
    seed, q0, k0 = seedvec
    return attention_fwd_with_lse(q, k, v, scale, Dropout(seed, float(rate), q0, k0))


def streaming_block(n: int, block_q: int, block_k: int) -> Callable:
    """The streaming block product on BH views (blocked_bh_with_lse,
    kernels A4/A5a/A5b): (o, lse (B, H, n)). block_q and block_k tile its
    plain version (the kernels tile themselves)."""
    from vitax_torch.ops.flash_blocked import blocked_bh_with_lse, block_sizes
    bq, bk = block_sizes(n, block_q, block_k)

    def streaming(q, k, v, scale):
        b, _, h, _ = q.shape
        o, lse = blocked_bh_with_lse(_to_bh(q), _to_bh(k), _to_bh(v), scale, bq, bk)
        return _from_bh(o, q.shape), lse.reshape(b, h, n)
    return streaming


def streaming_block_drop(n: int, block_q: int, block_k: int) -> Callable:
    """streaming_block with the dropout mask at seedvec's global offsets
    (blocked_bh_dropout_lse)."""
    from vitax_torch.ops.flash_blocked import blocked_bh_dropout_lse, block_sizes
    bq, bk = block_sizes(n, block_q, block_k)

    def streaming(q, k, v, seedvec, scale, rate):
        b, _, h, _ = q.shape
        o, lse = blocked_bh_dropout_lse(_to_bh(q), _to_bh(k), _to_bh(v), seedvec, scale, rate, bq, bk)
        return _from_bh(o, q.shape), lse.reshape(b, h, n)
    return streaming


def kernel_block(n: int) -> Callable:
    """The block product for a local length n (vitax block_kernel_with_lse):
    flash4_with_lse up to MAX_SEQ_IN_VMEM, the streaming entry past it at
    the JAX package's tiles."""
    if n <= MAX_SEQ_IN_VMEM:
        return flash4_with_lse
    from vitax_torch.ops.flash_blocked import DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q
    return streaming_block(n, DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)


def kernel_block_drop(n: int) -> Callable:
    """The dropout twin of kernel_block (vitax block_dropout_kernel_with_lse):
    kern(q, k, v, seedvec, scale, rate) -> (o, lse), the mask at the global
    offsets of seedvec = (seed, q0, k0)."""
    if n <= MAX_SEQ_IN_VMEM:
        return flash4_dropout_lse
    from vitax_torch.ops.flash_blocked import DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q
    return streaming_block_drop(n, DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)


def ring_attention_local(q, k, v, *, rotation, scale: float, block_fn: Callable,
                         step_args: Optional[Callable[[int], tuple]] = None) -> torch.Tensor:
    """The ring body on the local token shard: q, k, v (B, n, H, Dh) ->
    o (B, n, H, Dh). `rotation.shift(kv)` returns (the next block, wait);
    step_args(step) gives extra block_fn arguments (dropout's seedvec and
    rate). The next block's shift is issued before the current product and
    waited on after it."""
    count = rotation.count
    kv = torch.stack([k, v])
    o = lse = None
    for step in range(count):
        last = step == count - 1
        if not last:
            kv_next, wait = rotation.shift(kv)
        extra = () if step_args is None else step_args(step)
        o_blk, lse_blk = block_fn(q, kv[0], kv[1], scale, *extra)
        o_blk = o_blk.to(torch.promote_types(o_blk.dtype, torch.float32))     # f32 (f64 stays f64)
        o, lse = (o_blk, lse_blk) if o is None else _merge(o, lse, o_blk, lse_blk)
        if not last:
            wait()
            kv = kv_next
    return o.to(q.dtype)


def ring_attention_local_drop(q, k, v, seed: int, *, rotation, scale: float, rate: float,
                              block_fn: Callable) -> torch.Tensor:
    """The ring body with in-kernel dropout: step t's product masks at
    (q0, k0) = (index n, ((index - t) mod S) n), the global offsets of the
    query shard and of the block it holds then."""
    count, n = rotation.count, q.shape[1]
    q0 = rotation.index * n

    def step_args(step):
        src = (rotation.index - step) % count
        return _seedvec(seed, q0, src * n), rate

    def block_with_drop(q, kk, vv, scale, seedvec, rate):
        return block_fn(q, kk, vv, seedvec, scale, rate)

    return ring_attention_local(q, k, v, rotation=rotation, scale=scale, block_fn=block_with_drop,
                                step_args=step_args)


def make_ring_attention(rotation, use_kernel: bool = True) -> Callable:
    """(B, n, H, Dh) -> (B, n, H, Dh) on the local token shard, rotating
    over `rotation` (a GroupShift); the block product chosen by n at the
    call (kernel_block), or dense_block without the kernels."""
    def ring_attention(q, k, v):
        block_fn = kernel_block(q.shape[1]) if use_kernel else dense_block
        return ring_attention_local(q, k, v, rotation=rotation, scale=q.shape[-1] ** -0.5, block_fn=block_fn)
    ring_attention.vitax_name = "ring attention (sp)"
    return ring_attention


def make_ring_dropout(rotation, rate: float, use_kernel: bool = True) -> Callable:
    """Ring attention with in-kernel attention dropout: (q, k, v, seed) ->
    o, seed folded over the batch shard but not over sp."""
    def ring_dropout(q, k, v, seed):
        block_fn = kernel_block_drop(q.shape[1]) if use_kernel else dense_block_drop
        return ring_attention_local_drop(q, k, v, seed, rotation=rotation, scale=q.shape[-1] ** -0.5,
                                         rate=rate, block_fn=block_fn)
    return ring_dropout


def loop_back_ring(q, k, v, count: int, block_fn: Callable, seed: Optional[int] = None,
                   rate: float = 0.0) -> Tuple[torch.Tensor, List[LoopBack]]:
    """The ring body over `count` virtual shards of whole (B, N, H, Dh)
    operands in one process, each shard's output concatenated: what an sp
    group of `count` ranks computes, block products and merges included.
    With a seed the body is the dropout one and block_fn a dropout block
    (kern(q, k, v, seedvec, scale, rate)). Returns (o, the rotations)."""
    n = q.shape[1] // count
    cut = [slice(j * n, (j + 1) * n) for j in range(count)]
    blocks = [torch.stack([k[:, c], v[:, c]]) for c in cut]
    scale = q.shape[-1] ** -0.5
    rotations = [LoopBack(blocks, j) for j in range(count)]
    outs = []
    for j, c in enumerate(cut):
        if seed is None:
            outs.append(ring_attention_local(q[:, c], k[:, c], v[:, c], rotation=rotations[j], scale=scale,
                                             block_fn=block_fn))
        else:
            outs.append(ring_attention_local_drop(q[:, c], k[:, c], v[:, c], seed, rotation=rotations[j],
                                                  scale=scale, rate=rate, block_fn=block_fn))
    return torch.cat(outs, dim=1), rotations
