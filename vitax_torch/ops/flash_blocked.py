"""Streaming (blocked) flash attention: the port of vitax/ops/flash_blocked.py.

The JAX package takes this path past MAX_SEQ_IN_VMEM tokens, where its
whole-N TPU kernels would hold an (N, N) score tile in VMEM. Its streaming
kernels are A4 (`_fwd_kernel`, the forward over (bq, bk) tiles with an
online softmax), A5a (`_dkv_kernel`, dK and dV over the q blocks) and A5b
(`_dq_kernel`, dQ over the k blocks). On the card their counterparts are
the port's own hand-written kernels, which never hold the scores either:
csrc/flash_attn_fwd.cu streams K/V tiles through shared memory with the
same online softmax (A4; its wgmma kernel through a TMA-fed ring of
128-key tiles, its general kernel 64 at a time; ops/attention.py
`choose_fwd_kernel`), and csrc/flash_attn_bwd.cu runs a delta
pre-pass, a dK/dV kernel over the query tiles (A5a) and a dQ kernel over
the K/V tiles (A5b). Their dropout instantiations hash each score element
at its global (q0 + q, k0 + k) coordinates, as A4 and A5 do.

Each entry is a torch.autograd.Function differentiable in o and lse, as the
JAX custom VJPs are; it saves (q, k, v, o, lse), and under dropout the
seed vector (seed, q0, k0), never a mask.
- On a CUDA tensor it launches those kernels: `blocked_flash_attention` and
  `blocked_dropout_attention` on the strided (B, N, H, Dh) views as given
  (the kernel's block index b*H + h is JAX's BH row, so no relayout), the
  `blocked_bh_*` entries on (B*H, N, 1, Dh) views. block_q and block_k are
  validated and set nothing: the kernels' own tiles apply.
- On a CPU tensor it runs the plain versions below, which follow the TPU
  kernels tile by tile at (block_q, block_k).
Past MAX_SEQ_IN_VMEM tokens the kernel wrappers count their launches under
the streaming keys of `_build.LAUNCHES` (`_build.STREAM_KERNELS`, chosen by
`launch_key`), so the whole-N keys keep counting only the whole-N path.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from vitax_torch.ops.attention import (
    Dropout,
    _acc_dtype,
    _FlashWithLse,
    _from_bh,
    _keep,
    _seedvec,
    _to_bh,
    flash_attn_bwd_cuda,
    flash_attn_fwd_cuda,
)

NEG_INF = -1e30          # large but finite: no inf - inf = nan in the max/exp chain
# The JAX package's measured block defaults (vitax/ops/flash_blocked.py:48-49);
# they set the plain versions' tiling only.
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 1024


def _pad_len(n: int, block: int) -> int:
    return (n + block - 1) // block * block


def block_sizes(n: int, block_q: int, block_k: int) -> Tuple[int, int]:
    """The JAX entries' tiles for a sequence of n: each block capped at n
    rounded up to 128 (vitax/ops/flash_blocked.py:374-375)."""
    _check_blocks(block_q, block_k)
    return min(block_q, _pad_len(n, 128)), min(block_k, _pad_len(n, 128))


def _check_blocks(bq: int, bk: int) -> None:
    if not all(isinstance(b, int) and b >= 1 for b in (bq, bk)):
        raise ValueError(f"streaming attention: block sizes must be positive ints, got ({bq!r}, {bk!r})")


def _pad_seq(x: torch.Tensor, n_pad: int, value: float = 0.0) -> torch.Tensor:
    """Pad axis 1 of a (BH, N, ...) tensor to n_pad."""
    pad = n_pad - x.shape[1]
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((x.shape[0], pad, *x.shape[2:]), value)], dim=1)


def _keep_tile(drop: Dropout, bh: int, r0: int, nr: int, c0: int, nc: int, n: int, like: torch.Tensor
               ) -> torch.Tensor:
    """float {0, 1} keep-mask of the (bh, nr, nc) score tile whose first
    padded row and column are r0 and c0, hashed at global coordinates (q0 +
    row, k0 + column) with `_keep`. Rows and columns past n are padding
    whose P is 0; they are left 1 rather than hashed. Type and device of
    `like`."""
    mask = like.new_ones((bh, nr, nc))
    vr, vc = min(nr, max(0, n - r0)), min(nc, max(0, n - c0))
    if vr and vc:
        idx = dict(dtype=torch.int64, device=like.device)
        rows = torch.arange(r0, r0 + vr, **idx).view(vr, 1) + drop.q0
        cols = torch.arange(c0, c0 + vc, **idx) + drop.k0
        bhs = torch.arange(bh, **idx).view(bh, 1, 1)
        mask[:, :vr, :vc] = _keep(drop.seed, bhs, rows, cols, drop.rate).to(like.dtype)
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor, c0: int, n: int, scale: float) -> torch.Tensor:
    """(BH, rows, cols) f32 scores of q against the k tile starting at
    column c0; columns >= n set to NEG_INF (`_col_mask`)."""
    s = torch.matmul(q, k.transpose(1, 2)) * scale
    return s.masked_fill(torch.arange(c0, c0 + k.shape[1], device=s.device) >= n, NEG_INF)


def streaming_fwd_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, bq: int, bk: int,
                           dropout: Optional[Dropout] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of A4 on (BH, N, Dh): padded to lcm(bq, bk)
    (`_blocked_fwd_impl`), then each K block in order: f32 scores, columns
    past N masked, running max m and sum l (unmasked), the f32 accumulator
    rescaled by alpha, P masked (dropout: numerator only, at global
    coordinates) and cast to V's type before PV. o = acc / (max(l, 1e-30)
    (1 - rate)) in the input type, lse = m + log max(l, 1e-30) (BH, N) f32.
    Query blocks are independent, so all rows advance together."""
    acc = _acc_dtype(q)
    bh, n, dh = q.shape
    n_pad = _pad_len(n, math.lcm(bq, bk))
    qp, kp, vp = (_pad_seq(x, n_pad).to(acc) for x in (q, k, v))
    m = qp.new_full((bh, n_pad, 1), NEG_INF)
    l = qp.new_zeros((bh, n_pad, 1))
    o = qp.new_zeros((bh, n_pad, dh))
    for c0 in range(0, n_pad, bk):
        s = _scores(qp, kp[:, c0:c0 + bk], c0, n, scale)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        if dropout is not None:
            p = p * _keep_tile(dropout, bh, 0, n_pad, c0, bk, n, qp)
        o = o * alpha + torch.matmul(p.to(v.dtype).to(acc), vp[:, c0:c0 + bk])
        m = m_new
    l = l.clamp_min(1e-30)
    o = o / (l * (1.0 - (0.0 if dropout is None else dropout.rate)))
    return o[:, :n].to(q.dtype), (m + torch.log(l))[:, :n, 0]


def _bwd_operands(q, k, v, o, lse, do, dlse, bq, bk):
    """Padded f32 operands of the backward (`_blocked_bwd_impl`): padded q
    rows get lse = +inf, so P = 0 there; delta = rowsum(dO * O) in f32,
    once."""
    acc = _acc_dtype(q)
    n = q.shape[1]
    n_pad = _pad_len(n, math.lcm(bq, bk))
    qp, kp, vp, dop = (_pad_seq(x, n_pad).to(acc) for x in (q, k, v, do))
    delta = (dop * _pad_seq(o, n_pad).to(acc)).sum(dim=-1, keepdim=True)
    lse_p = _pad_seq(lse.to(acc)[..., None], n_pad, float("inf"))
    dlse_p = torch.zeros_like(lse_p) if dlse is None else _pad_seq(dlse.to(acc)[..., None], n_pad)
    return n, n_pad, qp, kp, vp, dop, delta, lse_p, dlse_p


def streaming_dkv(q, k, v, o, lse, do, dlse, scale: float, bq: int, bk: int,
                  dropout: Optional[Dropout] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of A5a on (BH, N, Dh): dK and dV accumulated in f32
    over the q blocks in order. P = exp(S - lse); with ms = mask / (1 -
    rate) under dropout, dV += (P ms)^T dO, dP = (dO V^T) ms, dS = P (dP -
    delta + dlse) scale, dK += dS^T Q. dlse None means zero."""
    n, n_pad, qp, kp, vp, dop, delta, lse_p, dlse_p = _bwd_operands(q, k, v, o, lse, do, dlse, bq, bk)
    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    for r0 in range(0, n_pad, bq):
        qi, doi = qp[:, r0:r0 + bq], dop[:, r0:r0 + bq]
        p = torch.exp(_scores(qi, kp, 0, n, scale) - lse_p[:, r0:r0 + bq])
        dp = torch.matmul(doi, vp.transpose(1, 2))
        a = p
        if dropout is not None:
            ms = _keep_tile(dropout, qp.shape[0], r0, bq, 0, n_pad, n, qp) / (1.0 - dropout.rate)
            a, dp = p * ms, dp * ms
        dv = dv + torch.matmul(a.transpose(1, 2), doi)
        ds = p * (dp - delta[:, r0:r0 + bq] + dlse_p[:, r0:r0 + bq]) * scale
        dk = dk + torch.matmul(ds.transpose(1, 2), qi)
    return dk[:, :n].to(k.dtype), dv[:, :n].to(v.dtype)


def streaming_dq(q, k, v, o, lse, do, dlse, scale: float, bq: int, bk: int,
                 dropout: Optional[Dropout] = None) -> torch.Tensor:
    """Plain version of A5b on (BH, N, Dh): dQ accumulated in f32 over the
    k blocks in order, the mask regenerated at the same global
    coordinates: dQ += dS K."""
    n, n_pad, qp, kp, vp, dop, delta, lse_p, dlse_p = _bwd_operands(q, k, v, o, lse, do, dlse, bq, bk)
    dq = torch.zeros_like(qp)
    for c0 in range(0, n_pad, bk):
        kj = kp[:, c0:c0 + bk]
        p = torch.exp(_scores(qp, kj, c0, n, scale) - lse_p)
        dp = torch.matmul(dop, vp[:, c0:c0 + bk].transpose(1, 2))
        if dropout is not None:
            dp = dp * (_keep_tile(dropout, qp.shape[0], 0, n_pad, c0, bk, n, qp) / (1.0 - dropout.rate))
        ds = p * (dp - delta + dlse_p) * scale
        dq = dq + torch.matmul(ds, kj)
    return dq[:, :n].to(q.dtype)


def streaming_bwd_with_lse(q, k, v, o, lse, do, dlse, scale: float, bq: int, bk: int,
                           dropout: Optional[Dropout] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of A5a and A5b together on (BH, N, Dh): dq, dk, dv in
    the input type."""
    dk, dv = streaming_dkv(q, k, v, o, lse, do, dlse, scale, bq, bk, dropout)
    return streaming_dq(q, k, v, o, lse, do, dlse, scale, bq, bk, dropout), dk, dv


def _streaming_fwd(bq: int, bk: int):
    """The forward dispatcher on (B, N, H, Dh) for _FlashWithLse: a CUDA
    tensor launches A1's kernels (the counterpart of A4; the one
    `choose_fwd_kernel` gives) or raises; a CPU
    tensor runs the plain version at (bq, bk) in the BH layout."""
    def fwd(q, k, v, scale, dropout):
        if q.device.type == "cuda":
            return flash_attn_fwd_cuda(q, k, v, scale, dropout)
        if q.device.type != "cpu":
            raise ValueError(f"streaming attention forward: no path for device {q.device}")
        b, n, h, _ = q.shape
        o, lse = streaming_fwd_with_lse(_to_bh(q), _to_bh(k), _to_bh(v), scale, bq, bk, dropout)
        return _from_bh(o, q.shape), lse.reshape(b, h, n)
    return fwd


def _streaming_bwd(bq: int, bk: int):
    """The backward dispatcher: A2's delta, dK/dV (A5a) and dQ (A5b)
    kernels on the card, the plain versions on the CPU."""
    def bwd(q, k, v, o, lse, do, dlse, scale, dropout):
        if q.device.type == "cuda":
            return flash_attn_bwd_cuda(q, k, v, o, lse, do, dlse, scale, dropout)
        if q.device.type != "cpu":
            raise ValueError(f"streaming attention backward: no path for device {q.device}")
        b, n, h, _ = q.shape
        grads = streaming_bwd_with_lse(*(_to_bh(x) for x in (q, k, v, o)), lse.reshape(b * h, n), _to_bh(do),
                                       None if dlse is None else dlse.reshape(b * h, n), scale, bq, bk, dropout)
        return tuple(_from_bh(g, q.shape) for g in grads)
    return bwd


def blocked_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, bq: int, bk: int,
                     dropout: Optional[Dropout] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse (B, H, N)) of (B, N, H, Dh) operands through the streaming
    dispatchers, differentiable in both: the core of every entry here."""
    _check_blocks(bq, bk)
    return _FlashWithLse.apply(q, k, v, float(scale), dropout, _streaming_fwd(bq, bk), _streaming_bwd(bq, bk))


def _bh(q, k, v, scale, bq, bk, dropout):
    o, lse = blocked_with_lse(q[:, :, None], k[:, :, None], v[:, :, None], scale, bq, bk, dropout)
    return o[:, :, 0], lse[:, 0]


def blocked_bh_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, bq: int,
                        bk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, N, Dh) streaming attention returning (o, lse (BH, N)),
    differentiable in both outputs (the lse cotangent feeds the backward,
    as ring attention's merge needs). bq and bk tile the plain version."""
    return _bh(q, k, v, scale, bq, bk, None)


def blocked_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int = DEFAULT_BLOCK_Q,
                            block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Streaming flash attention, (B, N, H, Dh) -> (B, N, H, Dh),
    differentiable. On the card the kernels take the strided views as
    given and tile them themselves; block_q and block_k (validated) tile the
    plain version on the CPU, capped at N rounded up to 128."""
    bq, bk = block_sizes(q.shape[1], block_q, block_k)
    return blocked_with_lse(q, k, v, q.shape[-1] ** -0.5, bq, bk, None)[0]


blocked_flash_attention.vitax_name = "streaming"


def blocked_bh_dropout_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seedvec: Tuple[int, int, int],
                           scale: float, rate: float, bq: int, bk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, N, Dh) streaming attention with attention dropout, returning
    (o, lse (BH, N)), differentiable in both outputs. seedvec: (seed, q0,
    k0) (`_seedvec`); row i of the BH layout is block index i of the mask."""
    seed, q0, k0 = seedvec
    return _bh(q, k, v, scale, bq, bk, Dropout(seed, float(rate), q0, k0))


def blocked_bh_dropout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: int, scale: float, rate: float,
                       bq: int, bk: int) -> torch.Tensor:
    """(BH, N, Dh) streaming attention with attention dropout."""
    return blocked_bh_dropout_lse(q, k, v, _seedvec(seed), scale, rate, bq, bk)[0]


def blocked_dropout_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seed: int, rate: float,
                              block_q: int = DEFAULT_BLOCK_Q, block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Streaming flash attention with in-kernel attention dropout, (B, N,
    H, Dh) -> (B, N, H, Dh), differentiable in q, k, v; the blocks as in
    blocked_flash_attention."""
    bq, bk = block_sizes(q.shape[1], block_q, block_k)
    seed, q0, k0 = _seedvec(seed)
    return blocked_with_lse(q, k, v, q.shape[-1] ** -0.5, bq, bk, Dropout(seed, float(rate), q0, k0))[0]
