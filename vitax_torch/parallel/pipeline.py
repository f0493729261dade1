"""Pipeline parallelism over the mesh's "pp" dim: the GPipe schedule
(vitax/parallel/pipeline.py make_pp_forward) and the stage and hop code
that the 1F1B schedule (parallel/pipeline_1f1b.py) shares.

- **Stages.** Stage s of S holds blocks [s L/S, (s + 1) L/S) of the whole
  model, under their global names (models/vit.py StageBlocks), beside the
  embedding, the final norm and the head, which every stage holds, as
  vitax replicates them over "pp". The first stage embeds, the last runs
  the tail and the loss: `VisionTransformer.stage_forward`, one call a
  microbatch, an FSDP2 forward method of the root (parallel/sharding.py),
  so ZeRO-3 gathers each block just in time inside it.
- **Microbatches.** The rank's rows are split contiguously into M
  (--pp_microbatches, default S) equal microbatches, as vitax reshapes
  them (M, b/M, ...) (`microbatches`); train/step.py's grad-accumulation
  split is strided and is not this one. Under dropout, which rows share a
  microbatch decides the masks.
- **The hop** (`Hop`). A stage sends its output activations to the next
  stage and, in the backward, their cotangent to the previous one: the
  sends and receives a schedule pairs are posted together in one
  `batch_isend_irecv` over the pp group and waited on, so two stages that
  send to each other at once (1F1B's steady state) never wait on each
  other, on NCCL as on gloo. A gloo group carries host tensors only, so
  under a gloo group the card's tensors go through host buffers (chosen
  by the group's backend, and said so in `Hop.route`); NCCL takes them
  where they are. `HOPS` counts the transfers a rank sends, "forward"
  (activations) and "backward" (cotangents).
- **The backward** of a microbatch is torch.autograd.backward from the
  stage's output with the received cotangent, or from the loss on the
  last stage; the stage's input is a leaf whose grad goes back to the
  previous stage. Each call ends in FSDP2's reduce-scatter of the stage's
  grads, accumulated sharded over the microbatches, as the port's grad
  accumulation does.
- **GPipe** (`gpipe_step`): every microbatch's forward, then every
  backward, in microbatch order.
- **The loss** of microbatch m on the last stage is its CE mean over M:
  the sum over microbatches is the rank's mean, and FSDP2's average over
  the batch ranks makes it the global batch's mean, vitax's loss.
- **MoE** (vitax's pipeline.py:284-341): each layer's frac_tokens and
  mean_prob are averaged over the microbatches and the batch ranks before
  E * sum(frac * prob) is formed, summed over the stages and divided by L.
  frac_tokens is a count with no grad, so once every forward has run the
  aux's grad into microbatch m is a fixed multiple of its mean_prob's:
  each microbatch's backward carries sum(prob_m * c), c = w E frac / (L M)
  (the batch ranks' mean comes from the grads' average over them).
- **Eval** (`pipeline_logits`): the forwards without grad; the last stage
  holds the logits.

Dropout seeds come per (microbatch, global block) from the step
(train/step.py pp_seeds), folded with vitax's pipeline shard index.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

# transfers a rank sent: "forward" activations to the next stage, "backward"
# cotangents to the previous one
HOPS = {"forward": 0, "backward": 0}


def reset_hops() -> None:
    for key in HOPS:
        HOPS[key] = 0


def check_batch(cfg, mesh, pipe) -> int:
    """The microbatch count (--pp_microbatches, 0 meaning the stage count),
    after vitax's check that the global batch divides into the batch
    ranks' microbatches (pipeline.py:119-123)."""
    from vitax_torch.parallel.mesh import batch_shard
    m = cfg.pp_microbatches or pipe.count
    ranks = batch_shard(mesh)[1]
    if cfg.batch_size % (ranks * m):
        raise ValueError(f"batch {cfg.batch_size} must divide by data-axes*microbatches ({ranks}*{m})")
    return m


def microbatches(x: torch.Tensor, m: int) -> List[torch.Tensor]:
    """The rank's rows split contiguously into m equal microbatches
    (vitax's x.reshape(M, b // M, ...)), views."""
    return list(x.chunk(m))


class Hop:
    """The transfers between a stage and its neighbours over the pp group.
    `route` says how they travel: "nccl" (the tensors where they lie) or
    "gloo through the host" (card tensors copied to host buffers and back)
    or "gloo" (host tensors)."""

    def __init__(self, pipe, device: torch.device):
        import torch.distributed as dist
        self.pipe = pipe
        self.device = torch.device(device)
        backend = str(dist.get_backend(pipe.group))
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.route = f"{backend} through the host" if self.staged else backend

    def exchange(self, send: Optional[torch.Tensor], send_to: Optional[int], recv_like: Optional[torch.Tensor],
                 recv_from: Optional[int], kind: str) -> Optional[torch.Tensor]:
        """Send `send` to global rank `send_to` and receive a tensor shaped
        as `recv_like` from `recv_from`, posted together and waited on; a
        side whose peer is None is skipped. Returns the received tensor on
        the stage's device (or None)."""
        import torch.distributed as dist
        send = send if send_to is not None else None
        recv_like = recv_like if recv_from is not None else None
        if send is None and recv_like is None:
            return None
        ops, buf = [], None
        if send is not None:
            out = send.detach()
            out = out.to("cpu") if self.staged else out.contiguous()
            ops.append(dist.P2POp(dist.isend, out, send_to, self.pipe.group))
            HOPS[kind] += 1
        if recv_like is not None:
            buf = torch.empty(recv_like.shape, dtype=recv_like.dtype, device="cpu" if self.staged else self.device)
            ops.append(dist.P2POp(dist.irecv, buf, recv_from, self.pipe.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if buf is not None and self.staged:
            buf = buf.to(self.device)
        return buf


class Record(NamedTuple):
    """One microbatch's forward on a stage: its input (a leaf on every
    stage but the first), its output (activations, or the loss on the
    last stage) and its MoE ingredients (Lps, E) or None."""
    x: Optional[torch.Tensor]
    out: torch.Tensor
    probs: Optional[torch.Tensor]


class Stage:
    """A rank's stage under a schedule: its model (a pipeline stage,
    models/vit.py), the microbatches' images, labels and dropout seeds,
    the hop, and the activation shape a transfer carries."""

    def __init__(self, model, cfg, pipe, hop: Hop, images: List[torch.Tensor], labels: Optional[List[torch.Tensor]],
                 seeds: Callable[[int], object]):
        self.model, self.cfg, self.pipe, self.hop = model, cfg, pipe, hop
        self.images, self.labels, self.seeds = images, labels, seeds
        self.m = len(images)
        shard = model.token_shard
        n = cfg.num_patches // (shard.count if shard is not None else 1)
        self.act = torch.empty((images[0].shape[0], n, cfg.embed_dim), dtype=model.dtype, device="meta")
        self.fracs: List[torch.Tensor] = []
        self.loss = torch.zeros((), dtype=torch.float32, device=hop.device)

    # --- transfers (no-ops past either end of the pipeline) ---
    def recv_forward(self) -> Optional[torch.Tensor]:
        return self.hop.exchange(None, None, self.act, self.pipe.prev, "forward")

    def send_forward(self, out: torch.Tensor) -> None:
        if not self.pipe.last:
            self.hop.exchange(out, self.pipe.next, None, None, "forward")

    def recv_backward(self) -> Optional[torch.Tensor]:
        return None if self.pipe.last else self.hop.exchange(None, None, self.act, self.pipe.next, "backward")

    def send_backward(self, dx: Optional[torch.Tensor]) -> None:
        self.hop.exchange(dx, self.pipe.prev, None, None, "backward")

    def send_forward_recv_backward(self, out: torch.Tensor) -> Optional[torch.Tensor]:
        if self.pipe.last:
            return None
        return self.hop.exchange(out, self.pipe.next, self.act, self.pipe.next, "forward")

    def send_backward_recv_forward(self, dx: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return self.hop.exchange(dx, self.pipe.prev, self.act, self.pipe.prev, "backward")

    # --- compute ---
    def forward(self, k: int, received: Optional[torch.Tensor]) -> Record:
        """Microbatch k's forward: the images on the first stage, else the
        received activations as a leaf; on the last stage the loss, its CE
        mean over M, added to `self.loss` (detached)."""
        x = None
        if self.pipe.first:
            inp = self.images[k]
        else:
            x = inp = received.requires_grad_(torch.is_grad_enabled())
        out, fracs, probs = self.model.stage_forward(inp, self.seeds(k))
        if fracs:
            self.fracs.append(torch.stack(fracs).detach())
            probs = torch.stack(probs)
        if self.pipe.last and self.labels is not None:
            out = F.cross_entropy(out.float(), self.labels[k]) / self.m
            self.loss += out.detach()
        return Record(x, out, probs if fracs else None)

    def backward(self, rec: Record, dy: Optional[torch.Tensor], aux_scale: Optional[torch.Tensor] = None):
        """Microbatch `rec`'s backward from its loss, or from its output
        with the next stage's cotangent `dy`, plus the MoE aux term
        sum(probs * aux_scale); returns the input's grad (None on the
        first stage)."""
        roots, grads = [rec.out], [None if self.pipe.last else dy]
        if aux_scale is not None:
            roots.append((rec.probs * aux_scale).sum())
            grads.append(None)
        torch.autograd.backward(roots, grads)
        return None if rec.x is None else rec.x.grad


def moe_aux(cfg, stage: Stage, probs: List[torch.Tensor]):
    """vitax's pipeline aux (pipeline.py:284-341), from the stage's
    per-microbatch fracs and probs (Lps, E): each layer's means over the
    microbatches and the batch ranks (one all-reduce over every process of
    (L, E) rows, each stage filling its own), then E * sum(frac * prob)
    over every layer / L. Returns (the aux, detached; the scale c (Lps,
    E) of each microbatch's prob term in its backward)."""
    import torch.distributed as dist
    model, pipe = stage.model, stage.pipe
    layers = pipe.layers(cfg.num_blocks)
    both = torch.zeros((2, cfg.num_blocks, cfg.moe_experts), dtype=torch.float32, device=stage.hop.device)
    both[0, layers.start:layers.stop] = torch.stack(stage.fracs).mean(dim=0)
    both[1, layers.start:layers.stop] = torch.stack([p.detach() for p in probs]).mean(dim=0)
    dist.all_reduce(both)
    both /= dist.get_world_size() // pipe.count           # the batch ranks of a stage (MoE has no sp or tp)
    frac, prob = both.unbind(0)
    aux = cfg.moe_experts * (frac * prob).sum() / cfg.num_blocks
    scale = cfg.moe_aux_weight * cfg.moe_experts * frac[layers.start:layers.stop] / (cfg.num_blocks * stage.m)
    return aux, scale


def gpipe_step(stage: Stage) -> Optional[torch.Tensor]:
    """One GPipe step of the rank's stage: every microbatch's forward (the
    activations to the next stage), then every backward (the cotangents to
    the previous one). Returns the MoE aux (None when dense)."""
    records = []
    for k in range(stage.m):
        rec = stage.forward(k, stage.recv_forward())
        stage.send_forward(rec.out)
        records.append(rec)
    aux = scale = None
    if stage.fracs:
        aux, scale = moe_aux(stage.cfg, stage, [r.probs for r in records])
    for rec in records:
        stage.send_backward(stage.backward(rec, stage.recv_backward(), scale))
    return aux


@torch.no_grad()
def pipeline_logits(stage: Stage) -> Optional[torch.Tensor]:
    """The forwards of every microbatch without grad (eval): the logits of
    the rank's rows on the last stage, None on the others."""
    outs = []
    for k in range(stage.m):
        out = stage.forward(k, stage.recv_forward()).out
        stage.send_forward(out)
        outs.append(out)
    return torch.cat(outs) if stage.pipe.last else None
