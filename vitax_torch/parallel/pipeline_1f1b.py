"""The 1F1B pipeline schedule (vitax/parallel/pipeline_1f1b.py
make_1f1b_value_and_grad), on parallel/pipeline.py's stages and hops.

Stage s of S runs min(S - s - 1, M) warmup forwards, then one forward and
one backward a tick until its forwards are done, then the cooldown
backwards: the in-flight microbatches of a stage are at most S - s, where
GPipe holds all M. As in vitax, the last stage runs the tail and the loss
in the forward's own tick, and its backward seeds that microbatch's
cotangent at once. The backward of a microbatch recomputes the stage from
its saved input under --grad_ckpt (vitax's recompute-everything
semantics); the loss is the CE mean over M, whose sum over microbatches
and batch ranks is the global batch's mean, vitax's sum(ce) / batch_size.

The steady tick pairs its transfers as Megatron-LM's schedule does: the
forward's activations go to the next stage in the same batch_isend_irecv
that receives the next stage's cotangent, and the backward's cotangent to
the previous stage in the one that receives the next forward's input, so
two neighbours that send to each other at once post both sides together.
Every microbatch's backward runs in microbatch order, as under GPipe, so
the two schedules accumulate the same grads in the same order.

v1 covers dense runs without dropout at tp 1 and sp 1, as vitax's does
(Config.validate).
"""

from __future__ import annotations

from collections import deque

from vitax_torch.parallel.pipeline import Stage


def one_f_one_b_step(stage: Stage) -> None:
    """One 1F1B step of the rank's stage."""
    s, count, m = stage.pipe.index, stage.pipe.count, stage.m
    warmup = min(count - s - 1, m)
    steady = m - warmup
    pending = deque()
    for k in range(warmup):
        rec = stage.forward(k, stage.recv_forward())
        stage.send_forward(rec.out)
        pending.append(rec)
    received = stage.recv_forward() if steady else None
    for i in range(steady):
        rec = stage.forward(warmup + i, received)
        dy = stage.send_forward_recv_backward(rec.out)
        pending.append(rec)
        dx = stage.backward(pending.popleft(), dy)
        if i == steady - 1:
            stage.send_backward(dx)
        else:
            received = stage.send_backward_recv_forward(dx)
    for _ in range(warmup):
        stage.send_backward(stage.backward(pending.popleft(), stage.recv_backward()))
