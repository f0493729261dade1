#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (vitax_torch), run from the
repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py
    python3 chip_smoke.py --lost-rank    # phase 7e's drill (f) alone, at the 10B width

Phases, each printing one line (or a few), any failure exits non-zero:
  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: every kernel under vitax_torch/csrc/ with nvcc (sm_90a), all
     started together, with seconds and the ptxas registers and spills of
     every instantiation, the attention kernels' dropout ones included;
  3. kernel check: each kernel against its plain PyTorch version on the
     card, at the shapes the serve and train paths give it plus small
     ragged ones (the attention forward on each of its bf16 kernels in
     turn, wgmma and general, each line naming its kernel, also at the
     edges of the wgmma kernel's 128-row tiles, N 127, 129, 383 at Dh 160
     and 4224 at Dh 64, and a misaligned view and a negative scale that
     must take the general kernel: the wgmma kernel forced on them raises,
     its C entry refuses them;
     the attention backward with a nonzero dlse and a bitwise repeat; the
     attention kernels' dropout instantiations at the train
     shape and ragged ones with global offsets, a seed off by one landing
     past every bar; the BH entry points with and without dropout; the
     dropout mask recovered from the kernel bit for bit; the fused
     optimizer over leaves of assorted sizes, with the clip triggered and
     idle, and with per-leaf lr multipliers 0.1 and 1 (the leaves at 1
     bitwise the unscaled step); the dequant matmul weight-only with int8 and fp8 weights, and
     act mode bitwise: its wgmma kernel at the main-path shapes and, on
     both tiles, at shapes with ragged M, F and K tails, its general
     kernel at ragged-K shapes and at proj, each line naming its kernel);
  3L. the streaming entries (vitax_torch/ops/flash_blocked.py, the
     counterparts of A4, A5a and A5b) against their plain versions at N >
     2048: the ViT-L shape (2, 4096, 16, 64), a ragged N 4097 and Dh 160 at
     N 2304, bf16 and f32, rate 0 and 0.1 with global offsets past 2048,
     and phase 7L's (2, 9216, 16, 64) in bf16 at offsets 0, each bf16 case
     on both forward kernels; dlse, a bitwise repeat, a seed off by one
     beyond every bar; the BH entries; the mask read back from the kernel
     past 2048;
  4. kernel timing (CUDA events) of the attention kernels (with and
     without dropout, 4D and BH; the forward's wgmma and general kernels in
     turns, each with its share of the tensor-core peak) and the dequant
     matmul at their main-path shapes, beside the plain version, PyTorch's
     own library call and the least time the card could take; the dequant
     matmul's wgmma kernel, its general kernel and the other wgmma tile in
     turns at bucket 8's and bucket 1's rows, and the host's time per
     wrapper call;
  4L. the streaming path's kernels at the ViT-L shape, N 4096 and 9216,
     rate 0 and 0.1: the forward (both kernels in turns), the backward call
     and (torch.profiler) its dK/dV and dQ kernels, beside SDPA, the bounds
     and (N 4096 only) the plain versions;
  5. model check: the 10B-width ViT at depth 2 with the kernels against the
     dense path on the same weights: logits (no grad), then the loss and
     every parameter's gradient (bf16, batch 8), without dropout and with
     attention and mlp dropout at the same seeds; then its weights
     quantized, with the dequant matmul against its plain versions;
  6. serve main path: a full-width, full-depth 10B InferenceEngine (seeded
     init on the card) behind the HTTP server, answering 32 /predict
     requests from 8 threads and one /predict_batch of 8 images, with every
     kernel's launch count read around exactly that traffic (every
     attention forward on the wgmma kernel, here and in phases 6q to 7s),
     then 8 JPEG /predict bodies on a line of their own, each counted
     under the decode path it must take (native where the decoder builds,
     else PIL), then a profile of one bucket-8 forward;
  6q. quantized serving: that model quantized on the card to int8 and to
     fp8, three engines (int8 weight-only, int8 with int8 activations, fp8
     weight-only) each answering the same traffic over HTTP, with
     dequant_matmul's launches checked at 129 per engine batch, every
     block-site launch on the wgmma kernel, the
     footprint, a profile of one bucket-8 forward, latency, and an accuracy
     gate against the full-precision engine on 64 seeded images;
  6f. the serving fleet: 6q's int8 weights exported (quantized block by
     block on the card by consolidate.py save_npz_from_state) to /dev/shm,
     its codes and scales read back bit for bit 6q's; the f32 engine freed;
     `python -m
     vitax_torch.serve.fleet` with two replicas on the card (each `python -m
     vitax_torch.serve` running A1 and C), admission armed, the cache, a
     5 ms composing window and /chaos; each replica's seconds to ready; 32
     /predict from 8 threads and one /predict_batch of 8 through the router,
     each answer bit for bit 6q's int8 engine on the same image in a bucket
     it ran in, within 1e-2 of it and its top-k equal but for ties; 8
     repeats answered by the cache without a replica; composed groups; client
     latency and images/s beside 6q's single engine; a crash plan POSTed to
     replica 1's /chaos (and a 3 s hang of replica 0's next batch, so the
     group after it goes to replica 1) before bursts of 16: no client
     error, replica 1's exit, restart and re-admission, with 7a's processes
     and 7t's torchrun starting beside it (no figure times this part);
     SIGTERM: the fleet and both replicas exit 0;
     every serve.jsonl parsed, each replica's serve_request and serve_batch
     records accounting for every request it answered, bucket by bucket;
  7a. the chip arbiter on 6f's export (ARB_CELL's note): `python -m
     vitax_torch.arbiter --hosts h0,h1` with two gloo training ranks on
     the card, the fleet CLI with one int8 replica at --max_replicas 1 and
     --arbiter_url, one placement agent; a hang plan and a burst escalate,
     the borrow (both ranks exit 0 on a joint checkpoint, the 2 -> 1 resume
     from the peer store with 0 directory reads, the agent's replica
     adopted), 16 answers of the borrowed replica bit for bit 6q's, the
     return (its drain, the ledger, training back at 2 ranks with finite
     losses), every process's exit, the seconds from the escalation and
     from the return, the card's peak memory (sampled once 7t's torchrun
     has exited), each process's launches, the arbiter's events through
     tools/metrics_report.py;
  7. train main path: train() on the 10B-width model cut to depth 8, batch
     32, fake data, 12 timed steps, the profiler's warm-up step and 2
     steps in the loop's profiler window, and a 2-batch eval, with the
     launch counts of the run checked against the steps, sec/iter,
     images/s, MFU and peak memory; the window's trace (its steps, its
     kernels a step, busy and idle, time by kernel group); the fused
     optimizer on the trained state's own leaf table: one launch held
     element by element against the plain version, then timed; then 3
     steps at --remat_window 2 beside per-block remat from one init and
     batch (losses, attention launches, peak memory);
  7v. the port's program rules (vitax_torch.analysis, vitax's VTX-R001-R010)
     over the card's own programs, on objects phases 6, 6q and 7 built:
     R006 on phase 6's f32 engine; R006, R007 and R009 on each of 6q's
     three engines (129 kernel C launches a forward); one more non-log
     step of phase 7's state under R001 (torch.cuda's sync debug mode at
     "error"), R002 and R008, its launch deltas one step's (1 B, 8 A2, 16
     A1); then that step reading its loss back, which R001 must catch;
     each arm's rule ids, findings and seconds;
  7t. telemetry: phase 7's run twice, with telemetry off and then on
     (--metrics_dir), its launch counts equal in both and to phase 7's;
     the JSONL's 12 step records (REQUIRED_STEP_KEYS, steps 1-12, each MFU
     flops.mfu of its sec/iter, mem_peak_bytes within the run's
     max_memory_allocated), run_start (the card's name, peak 989, one
     device) and the eval event; tools/metrics_report.py --json over it
     (a subprocess: exit 0, no thread crash); sec/iter on and off and their
     ratio, opt_update_s beside phase 7's time of the fused optimizer;
     then the check of `torchrun --nproc_per_node 1 -m vitax_torch.train`
     at depth 2 with --metrics_dir, run beside 6f and 7a's start: through
     the named barriers and orderly_shutdown to exit 0 with its JSONL
     written;
  7d. train main path under dropout: the same run with att_dropout and
     mlp_dropout 0.1, its launch counts (the dropout kernels' forward,
     recompute and backward) checked against the steps, its first loss
     against phase 7's, one step's loss and grad norm repeated bitwise
     from the same state and seeds, sec/iter, images/s, MFU, peak memory
     and a profile of one steady step;
  7L. the long-context train path: train() at the ViT-L width, 4 blocks,
     batch 2, at N 4096 and 9216, N 4096 under att_dropout 0.1 and N 9216
     under remat_policy dots_attn_saveable, each with its launch counts
     checked against the steps, sec/iter, images/s, MFU, peak memory and
     a profile of one steady step;
  7r. sequence parallelism's ring on the one card: the ring body of
     vitax_torch/parallel/ring_attention.py over S virtual shards (its
     rotation the loop-back over the S chunks) at the ViT-L/14 shape of
     the repo's sp configuration (N 256, S 2), phase 7L's ViT-L width at N
     4096 over S 2 and N 9216 over S 4 (local 2304: the streaming entries),
     the 10B width (S 2) and b16_moe's N 196 over S 2 and 4 (local 98 and
     49: partial tiles at global offsets), rate 0 and 0.1: o and dq, dk, dv against the
     whole-sequence kernel call (under dropout its dropout kernel at the
     same seed), S^2 block products a ring run forward and backward, S - 1
     rotations a shard; Ulysses' head slices against the whole call; the
     ring's forward and forward + backward ms beside the whole call's; a
     fresh process whose backward's first node is the whole call (no
     context current on autograd's device thread), its grads finite;
  7p. tensor parallelism on the one card: models/vit.py's Block with a
     TensorShard (the sharded qkv, parallel/tensor_parallel.py's relayout
     to whole heads, the core on local heads, the row-parallel partials
     all-reduced) over tp groups of 2 and 4 ranks, one torchrun of 4
     processes on the card over gloo (NCCL refuses two ranks on one
     device), at the 10B width and phase 7's shape, rate 0 and 0.1,
     against the whole Block: output and every grad on every rank, one
     forward and one backward launch a rank a run on the wgmma kernels,
     the sharded and the whole Block's ms and one all-reduce's; then the
     train CLI under torchrun at tp 2 with both ranks on the card over
     gloo, against one process at tp 1, in float32 and in bf16 (the tp
     Block's torchrun and the four CLI runs at once, one wave);
  7q. pipeline parallelism on the one card: the train CLI under torchrun
     at pp 2 (vitax_torch/parallel/pipeline.py), both stages on the card
     over gloo (the stage hops through host buffers), the 10B width at
     depth 2 (7p's tp-1 runs are its pp-1 runs; the pp-2 runs in two more
     waves, float32 and bf16), batch 8, fake data, 3 steps: GPipe at M 2 and M 4 and 1F1B
     at M 4 in float32 against one process at pp 1; GPipe in bf16 on the
     wgmma kernels against pp 1 in bf16, each number held as 7p holds tp;
     GPipe in bf16 under att_dropout 0.1 on the dropout kernels; each
     rank's attention and fused_adamw launches and its hops against the
     schedule's, and each run's sec/iter;
  7n. the MoE ViT in groups on the one card, every batch row its own
     seeded image through the fake data path: first a forward of the
     seeded b16_moe init on the first batch shows how many first choices
     its first step drops at capacity factor 1.25 (it fails on none), how
     many tokens a rank-local capacity would route otherwise, and that
     each sp-2 slice's route with the cross-slice counts is the whole
     route's slice; then the train CLI under torchrun at b16_moe's full
     width (bench.py:296-298), batch 8, 3 steps, the ranks on the card
     over gloo: sp 2 ring, sp 2 Ulysses, tp 2 and tp 2 x ep 2 against one
     process in float32 (each loss and grad norm within 1e-5), then each
     mesh in bf16 on the wgmma kernels against one bf16 process (within
     3x its distance from float32; each rank's A1, A2 and B launches as
     the schedule says); each run's wall, its ranks' peak reserved memory and the
     card's peak over its wave (its bf16 tp runs beside 7q's bf16 wave,
     the rest in a wave after it);
  7i. phase 7's run from an ImageFolder tree that PIL writes at run time
     (8 classes x 64 JPEGs of 180-640 px, 4 PNGs; val 8 x 8), on the
     native decoder where g++ finds libjpeg's header, else on the PIL
     path asked for by name: launches as phase 7, finite losses, the
     decode counts, the first batch delivered against the dataset's
     load_batch bitwise, sec/iter beside phase 7's, data_wait_s, a
     profiled loader-fed window (device idle) and loader-fed against
     resident-batch steps in turns;
  7s. the tree packed with vitax_torch.tools.make_shards: the stream
     batch against the ImageFolder batch of the same samples bitwise, then
     train() with --data_format stream at depth 2, 8 steps, checked and
     timed as 7i; then the loaders alone (ShardedLoader and StreamLoader,
     uint8 at 224^2, at 4 workers and the host's CPU count) in images/s;
  7c. checkpoint and resume: train() at the 10B width cut to depth 2,
     batch 32, fake data, att_dropout 0.1, two epochs of 3 steps saving
     after each (run A); a resume of A's epoch 1 with --resume_epoch 1
     that trains epoch 2 (run B), its epoch-2 losses and its params, mu,
     nu and step bitwise equal to A's; --resume_epoch -1 past a torn
     epoch_3/ restoring epoch 2 bitwise; the stall save_state puts on the
     loop, the background write (s, GB/s, GB on disk) and the restore
     (s, GB/s); the resumed state exported with consolidate --dtype int8
     and served, one bucket-8 batch through kernel C (9 launches), its
     codes, scales and answers bitwise those of the trained model
     quantized in memory; launch counts of both runs against their steps;
  7e. the failure-reaction drills, each the train CLI under `python -m
     vitax_torch.supervise` (DRILL_MAIN: the CLI's main writing every
     child's launches) at 7c's cell cut to depth 1 (DRILL_CELL: the card
     machine's 96 GiB of host memory and 45 GiB of disk writes a run do
     not hold the depth-2 drills), checkpoints in /dev/shm, in waves,
     against one uninterrupted train() of the cell: (a) a crash (exit 13)
     at step 5 and the restart from epoch 1's checkpoint, the seconds from
     the death to the next first step; (b) SIGTERM at step 2: a committed
     mid-epoch save, exit 0, a resume at step 3; (c) a 15 s hang past
     --hang_timeout_s 12 under checkpoint_exit: the stack and memory dump,
     the emergency save, exit 42 within the hard deadline, the restart;
     (d) --zero_stall_ckpt, each save's stall; (e) --replicate_steps 2 and
     a crash: the restart restored from the peer store with no
     checkpoint-directory read, against (a)'s DCP restore seconds; each
     ends bitwise and launches what its steps launch; (f) two ranks over
     gloo on the card at b16's width, depth 4 (LOST_RANK_CELL, ZeRO-3;
     --replicate_steps 2 --peer_heartbeat_s 1): rank 1 killed at step 4,
     rank 0's exit 42 within the grace plus its deadline, rank 1's store
     deleted, the relaunched pair restored from rank 0's copy (rank 0
     serving it from its own store) and bitwise an uninterrupted pair;
     beside the second wave, at 7c's cell a save's loop-thread stall,
     save_state's snapshot against the pipeline's stage, in turns. `python3 chip_smoke.py
     --lost-rank` runs (f) alone at DRILL_CELL, the 10B width;
  7f. FSDP2 at world size 1: a one-rank NCCL group made here, after every
     unwrapped phase, and destroyed at the end of the phase. First the
     unwrapped reference (phase 7's run cut to 3 steps, on noise images
     with random labels, where fake data's loss collapses after one
     update; cudnn deterministic so the patch conv's wgrad is repeatable;
     made before the group) and a profile of one of its steady steps;
     then train() under ZeRO-3 at phase 7's configuration, its launch
     counts (A1 and A2 per block and step on wgmma, one fused_adamw a
     step), sec/iter, images/s, MFU and peak memory beside phase 7's, and
     a profile of one steady step split into GEMMs, casts, the FSDP
     copy-in/out, all-gather and reduce-scatter, the attention kernels
     and fused_adamw; then 3 steps
     each of ZeRO-3, ZeRO-2 and DP from the same init, their losses, grad
     norms and params bitwise the reference's; then a depth-2 sharded save
     (train() with a checkpoint) restored into a new sharded state, bitwise;
  7x. the transfer tasks (before 7f, unwrapped): a seeded depth-2 model
     exported in bf16 (1.3 GB); the warm start bitwise the export at step
     0 (the head re-initialized); then phase 7's run cut to depth 2 under --task finetune
     (--reinit_head, --backbone_lr_mult 0.1), --task probe and --task
     distill (the export as the teacher), each with its launch counts
     checked against its steps (the teacher adds a forward a block a
     step), sec/iter, images/s, MFU of the student's FLOPs and peak memory
     beside phase 7's; the probe's backbone bitwise the export after its
     run, its moments the head's; 12 finite distill events with kl >= 0;
     then a depth-2 probe run saves its epoch, InferenceEngine.from_checkpoint
     answers a bucket-8 batch bitwise as from_state on the trained params,
     and `python -m vitax_torch.serve --ckpt_dir ... --epoch -1` answers a
     /predict and exits 0 on SIGTERM;
  7m. mixture of experts (before 7f, unwrapped): train() at bench.py's
     b16 and b16_moe presets (ViT-B/16, batch 64; b16_moe's 8 experts,
     top-1, capacity factor 1.25, einsum dispatch), 12 steps each, fake
     data, grad_ckpt, the fused optimizer: each run's launch counts (A1
     and A2 per block and step, all wgmma, B once a step), sec/iter,
     images/s, MFU (b16_moe's FLOPs the MoE count: top-k experts and the
     router) and peak memory side by side, and a profile of one steady
     step of each; then 3 steps each of the gather dispatch and of top-2,
     finite, gather's first loss equal to einsum's within rtol 2e-4; the
     b16_moe model's logits with the kernels and on the plain bf16
     attention path, each against the float32 plain model on the same
     weights (the kernels' error at most 1.5x the plain path's), with the
     tokens whose first choice flips; the trained b16_moe exported (float32 and
     int8) and served, each export's engine answering a bucket-8 batch as
     from_state on the same float weights, bitwise, the int8 one
     dequantized at load (no kernel C launch);
  8. the seconds of each phase, the card's name and power limit, a
     `kernels` JSON line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

It imports nothing of JAX or of the JAX package. Without a card, or
without the vitax_torch package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import base64
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# FLOP/s by input type; bf16 on the tensor cores, float32 outside them (the
# f32 path runs with TF32 off).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# INT32 operations/s: 64 lanes a clock an SM on the ALU pipe (Hopper
# architecture white paper; NVIDIA's throughput table gives compute
# capability 9.0 64 results a clock an SM for 32-bit integer add, shift,
# logic and compare) x 132 SMs x the 1.98 GHz boost clock, the clock at
# which the float32 peak above is 67 TFLOP/s. The dropout hash's compiled
# code takes these ALU instructions a score element (`python -m
# vitax_torch.tools.hash_sass`, the DROP kernels' SASS against the rate-0
# ones on an H100 80GB HBM3; at Dh 160 / 128 / 64): the forward 11.81 /
# 11.83 / 11.81, the dK/dV kernel 12.62 / 12.32 / 12.06, the dQ kernel
# 11.88 / 11.70 / 11.70. Each is 4 SHF, 5 LOP3, the threshold's ISETP, the
# mask's FSEL and a share of adds and moves, while its 4 IMADs issue on the
# FMA pipe beside them (the compiler cancels fmix32's last xor-shift
# against the next one's first and folds the two multiplies left side by
# side). Every dropout bound, forward and backward, counts the fewest of
# them, once an element: the least work that gives the mask.
INT32_OPS_PER_S = 64 * 132 * 1.98e9
HASH_OPS_PER_ELEMENT = 11.70

SERVE_SHAPE = (8, 256, 32, 160)          # (B, N, H, Dh) of the 10B model at bucket 8
SERVE_BLOCKS = 32                        # its depth: attention forwards a serve batch
TRAIN_SHAPE = (32, 256, 32, 160)         # ... at the train path's batch 32
CHECK_SHAPES = (SERVE_SHAPE, (4, 256, 16, 64), (2, 50, 2, 16), (2, 197, 4, 64))
# The edges of the forward's wgmma tiles (128 queries a CTA, 128 keys a K/V
# tile): N one short of, one past and one short of three tiles at Dh 160,
# and 33 tiles at Dh 64.
FWD_EDGE_SHAPES = ((1, 127, 2, 160), (1, 129, 2, 160), (1, 383, 2, 160), (1, 4224, 4, 64))
TOL = {"bfloat16": (1.6e-2, 1e-3), "float32": (1e-5, 1e-5)}   # max |do|, max |dlse|
# Attention backward, for each of dq, dk, dv: max |d| <= tol * max |ref|.
# bf16: the kernel rounds P and dS to bf16 in registers, the plain version
# in memory, in another summation order, so outputs differ by up to one
# bf16 ulp of an entry; f32 (TF32 off): summation order only. The worst
# readings over these shapes on an H100 80GB HBM3 at 700 W are 2.25e-3
# (bf16) and 4.8e-7 (f32) of max |ref| (PERF.md), so the bars are about 3x
# and 4x those. The dlse term must move dq and dk by more than the bar, so
# a kernel that dropped it would fail (it moves them by 0.15 to 0.65).
BWD_TOL = {"bfloat16": 6e-3, "float32": 2e-6}
# The dropout instantiations and the BH entry points against their plain
# versions: max |d| <= tol * max |ref| for o and for each of dq, dk, dv.
# bf16: the kernels round the unnormalised P (and P * ms, dS) to bf16 in
# registers and divide o by l (1 - rate) after the product, the plain
# versions in memory, in another order; f32: summation order only. A first
# call on an H100 80GB HBM3 at 700 W read up to 7.8e-3 absolute on o (about
# one bf16 ulp of its largest entries) and 1.7e-3 of max |ref| on the
# grads in bf16, 1.9e-6 absolute and 3.1e-7 in f32, so the bars are about
# 3x those. The plain version at a seed off by one lands 0.48-0.89 of max
# |ref| away on the grads and 0.69-1.2 absolute on o: far beyond every bar.
DROP_TOL = {"bfloat16": (1.6e-2, 6e-3), "float32": (1e-5, 2e-6)}   # (o, grads)
ADAMW_RTOL, ADAMW_ATOL = 1e-6, 1e-8      # the bar of tests/test_fused_optimizer.py
# The 10B-width model at depth 2, bf16, kernels vs the dense path on the
# same weights and batch: max |dlogits| / max |logits|, and the loss's
# relative difference. Set at about 3.5x the readings on an H100 80GB HBM3
# at 700 W (1.7e-3 and 8.4e-5; PERF.md).
MODEL_REL_TOL = 6e-3
MODEL_LOSS_REL_TOL = 3e-4
# Model gradients: max |dg| / max |g| per leaf, the largest over each leaf
# group. The two attention backwards round P, dP and dS to bf16 at
# different points, which moves each gradient by a few bf16 ulps of its
# largest entry: 7.4e-3 at most on the same card, so the bar is 2.5e-2.
MODEL_GRAD_REL_TOL = 2.5e-2
# Kernel C (dequant_matmul) at the 10B serve path's shapes: (site, K, F,
# launches per bucket-8 forward); M is 8 x 256 = 2048 rows at the block
# sites and 8 (one row an image) at the head.
DEQUANT_SITES = (("qkv", 5120, 15360, 32), ("proj", 5120, 5120, 32), ("fc1", 5120, 20480, 32),
                 ("fc2", 20480, 5120, 32), ("head", 5120, 1000, 1))
# Ragged K (K % 16 != 0): the general kernel takes them.
DEQUANT_CHECK_SHAPES = ((5, 33, 17), (130, 257, 96), (1, 8, 4), (200, 520, 300))
# The wgmma kernel with ragged tails: M, F and K (4112 = 64 x 64 + 16) past
# a tile, and bucket 1's M 256 at the qkv site; each checked on every kernel.
DEQUANT_TAIL_SHAPES = ((2056, 5120, 1000), (130, 528, 392), (200, 4112, 300), (256, 5120, 15360))
# Phase 4 times kernel C at bucket 8's and bucket 1's rows.
DEQUANT_TIMING_M = (2048, 256)
# Weight-only: max |d| <= tol * max |ref| against the f32 plain version. bf16
# x: the tensor cores sum exact bf16 products in another order (and truncate
# inside an mma), f32 x: FMAs in another order. The worst readings at these
# shapes on an H100 80GB HBM3 at 700 W were 2.10e-5 (bf16, K 20480) and
# 2.76e-6 (f32, K 5120) of max |ref| (PERF.md), so the bars are about 3x and
# 3.6x those. The wgmma kernels and the tail shapes read the same 2.10e-5
# (every kernel, fp8 weights, K 20480) and 3.69e-6 (f32 x, the general
# kernel at the tail shapes) on the same card. Act mode must be bitwise equal. A check whose scales are
# dropped, or whose sx is forced to 1, must land beyond the bar (it lands
# 1.6e3-5.7e3 and 21-96 times max |ref| away).
DEQUANT_TOL = {"bfloat16": 6e-5, "float32": 1e-5}
# The 10B-width model at depth 2 quantized (int8 and fp8 weights), the
# kernel at every Dense site against the plain versions at every site, on
# the same quantized weights: max |dlogits| / max |logits|, by activation
# mode. Weight-only: the per-site differences above flip bf16 roundings of
# the site outputs, 1.43e-3 (int8) and 1.51e-3 (fp8) on the same card; act:
# every block site is bitwise, only the weight-only head differs, 4.1e-6.
# The bars are about 3.3x and 3.6x those.
QUANT_MODEL_TOL = {"off": 5e-3, "int8": 1.5e-5}
GATE_IMAGES = 64
# Top-1 agreement with the full-precision engine on GATE_IMAGES seeded
# images (labels = its own top-1). A random-init model's logits have small
# margins, and on uniform noise images its top-1 took only 2 classes, so the
# gate images are blocky colour fields (a 4 x 4 grid of random colours, 56
# pixels a cell). The floor asks that the quantized engine keep most of the
# full-precision answers; a path that loses the scales or the layout gives
# logits unrelated to them and keeps about 1 in the number of classes the
# labels span.
GATE_TOP1_FLOOR = 0.5
TRAIN = dict(num_blocks=8, batch_size=32, fake_data=True, max_steps=12, warmup_steps=4,
             log_step_interval=1, eval_max_batches=2, test_epoch_interval=1)
SEED = 0
DROP_RATE = 0.1                          # phase 7d's att_dropout and mlp_dropout
TRAIN_DROPOUT = dict(TRAIN, att_dropout=DROP_RATE, mlp_dropout=DROP_RATE)
DROP_SEED = 2024
DROP_CHECK_SHAPES = ((2, 197, 4, 64), (2, 50, 2, 16))     # ragged, checked with global offsets
DROP_OFFSETS = (5, 17)                   # q0, k0 of those checks
# Phases 3L, 4L and 7L: past MAX_SEQ_IN_VMEM (2048) tokens the streaming
# entries (vitax_torch/ops/flash_blocked.py, the counterparts of A4, A5a
# and A5b) launch the same kernels, counted under their own keys. The
# long-context configuration is the JAX ladder's (tools/long_context_ladder.py
# :44-47): ViT-L width (D 1024, 16 heads, Dh 64, patch 14), 4 blocks, batch 2.
LONG_SHAPE = (2, 4096, 16, 64)
LONG_OFFSETS = (2100, 3000)              # q0, k0 of the checks: global positions past 2048
# Phase 3L's cases: (shape, types, dropout q0/k0). The ViT-L shape at N 4096,
# a ragged N, Dh 160, and phase 7L's N 9216 in its own type with the offsets
# 0 the model calls the kernels at.
LONG_CHECK_CASES = ((LONG_SHAPE, ("bfloat16", "float32"), LONG_OFFSETS),
                    ((1, 4097, 4, 64), ("bfloat16", "float32"), LONG_OFFSETS),
                    ((1, 2304, 2, 160), ("bfloat16", "float32"), LONG_OFFSETS),
                    ((2, 9216, 16, 64), ("bfloat16",), (0, 0)))
LONG_TILE = 64                           # the plain versions run at 64 x 64 tiles here
LONG_TIME_NS = (4096, 9216)
# The streaming entries against the plain versions (A4's and A5's order at
# 64 x 64 tiles) on the card: max |d| / max |ref| of o and of each of dq,
# dk, dv, and max |dlse| absolute. bf16: the kernels round P (and, in the
# backward, P and dS) to bf16 in registers where A5's order keeps the
# backward in f32, in another summation order; f32: summation order only.
# The worst readings over these shapes on an H100 80GB HBM3 at 700 W were
# 6.1e-3 (o, N 9216 under dropout) and 7.5e-3 (dv, N 9216) in bf16, 2.9e-6
# and 3.0e-6 in f32, and 1.9e-6 on lse (two f32 ulps at N 9216), so the
# bars are about 2.5-3x those. A seed off by one lands 0.37-0.96 of max
# |ref| away, and dropping dlse moves dq and dk by 0.07-0.96.
LONG_TOL = {"bfloat16": (1.6e-2, 2e-2, 5e-6), "float32": (1e-5, 1e-5, 5e-6)}
# Phases 7i and 7s: phase 7's run from an ImageFolder tree that PIL writes at
# run time, and from its packed shards (depth 2, 8 steps); phase 6 also
# sends SERVE_JPEGS JPEG bodies. The loaders alone run at LOADER_IMAGE.
DATA_CLASSES, DATA_TRAIN_PER_CLASS, DATA_VAL_PER_CLASS, DATA_PNGS = 8, 64, 8, 4
TRAIN_TREE = dict(TRAIN, fake_data=False)
TRAIN_STREAM = dict(TRAIN, fake_data=False, num_blocks=2, max_steps=8, data_format="stream")
SERVE_JPEGS = 8
LOADER_IMAGE = 224
TURNS, TURN_STEPS = 4, 3                 # loader-fed against resident-batch steps, in alternating rounds
TRAIN_LONG = dict(patch_size=14, embed_dim=1024, num_heads=16, num_blocks=4, batch_size=2, num_classes=1000,
                  fake_data=True, max_steps=8, warmup_steps=4, log_step_interval=1, eval_max_batches=1,
                  test_epoch_interval=1)
# Phase 7c: checkpoint and resume at the 10B width cut to depth 2 (7.66 GB
# of f32 params, mu and nu): two epochs of three steps under att_dropout,
# a save after each, then a resume of epoch 1; the export then serves one
# bucket-8 batch through kernel C (4 block sites a block and the head).
TRAIN_CKPT = dict(num_blocks=2, batch_size=32, fake_data=True, warmup_steps=4, log_step_interval=1,
                  eval_max_batches=1, att_dropout=DROP_RATE, steps_per_epoch=3, num_epochs=2,
                  ckpt_epoch_interval=1)
# Phase 7m: bench.py's b16 and b16_moe presets (bench.py:288-297) at one
# card's batch, timed 12 steps each, then 3-step check arms of b16_moe
B16 = dict(image_size=224, patch_size=16, embed_dim=768, num_heads=12, num_blocks=12, batch_size=64,
           num_classes=1000, fake_data=True, max_steps=12, warmup_steps=4, log_step_interval=1,
           eval_max_batches=1, test_epoch_interval=1)
B16_MOE = dict(B16, moe_experts=8)
MOE_ARMS = (("gather", dict(moe_impl="gather")), ("top-2", dict(moe_top_k=2)))
MOE_ARM_STEPS = 3
MOE_LOSS_RTOL = 2e-4                     # gather's first loss against einsum's: the CPU tests' bar
# The MoE model with the kernels may be at most this many times further from
# the float32 plain model than the bf16 plain attention path is (max |d| of
# the logits over max |logits|): at b16_moe's depth 12 both paths carry bf16
# rounding through twelve blocks and their routers, where phase 5's fixed
# 6e-3 bar was set at depth 2.
MOE_MODEL_RATIO = 1.5
LONG_RUNS = (("N 4096", dict(image_size=896)), ("N 9216", dict(image_size=1344)),
             (f"N 4096, att_dropout {DROP_RATE}", dict(image_size=896, att_dropout=DROP_RATE)),
             ("N 9216, remat_policy dots_attn_saveable", dict(image_size=1344, remat_policy="dots_attn_saveable")))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def qkv_views(torch, shape, dtype, seed):
    """q, k, v as strided views of one (B, N, 3, H, Dh) tensor from numpy."""
    b, n, h, dh = shape
    arr = np.random.default_rng(seed).standard_normal((b, n, 3, h, dh)).astype(np.float32)
    qkv = torch.from_numpy(arr).to("cuda", getattr(torch, dtype))
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def attention_bound_ms(shape, dtype: str):
    """Least time for one launch: q, k, v read once, o and lse written once,
    over HBM bandwidth; 4 B H N^2 Dh FLOP over the tensor-core peak."""
    b, n, h, dh = shape
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = 4 * b * n * h * dh * elem + b * h * n * 4
    flops = 4 * b * h * n * n * dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def attention_bwd_bound_ms(shape, dtype: str):
    """Least time for one backward call as the train path makes it (dlse
    None): q, k, v, o, dO and lse read once, dq, dk, dv written once, over
    HBM bandwidth; 10 B H N^2 Dh FLOP (S recomputed, dV, dP, dQ, dK) over
    the tensor-core peak."""
    b, n, h, dh = shape
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = 8 * b * n * h * dh * elem + b * h * n * 4
    flops = 10 * b * h * n * n * dh
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def attention_drop_bound_ms(shape, dtype: str, backward: bool):
    """Least time for one forward or backward call under dropout: A1's or
    A2's bytes and tensor FLOPs, and the hash's integer operations (once
    an element: the least work that gives the mask) over the INT32 rate;
    the largest of the three."""
    b, n, h, dh = shape
    t, by, nbytes, flops = (attention_bwd_bound_ms if backward else attention_bound_ms)(shape, dtype)
    int_ops = HASH_OPS_PER_ELEMENT * b * h * n * n
    t_int = int_ops / INT32_OPS_PER_S * 1e3
    return max(t, t_int), ("operations" if t_int > t else by), nbytes, flops, int_ops


def adamw_bound_ms(numel: int):
    """Least time for one optimizer step: p, g, mu, nu read and p, mu, nu
    written, 4 bytes each, over HBM bandwidth (about 20 FLOP an element is
    far below the float32 peak's share)."""
    nbytes = 28 * numel
    flops = 20 * numel
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def time_ms(torch, fn, iters: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_env(torch):
    card = card_line()
    say(f"[1 env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} capability {torch.cuda.get_device_capability(0)}")
    say(card)
    return card


def kernel_label(mangled: str) -> str:
    """`name<template args>` of a mangled kernel symbol: the first
    length-prefixed name ending in `kernel`, then its integer, bool and
    element-type template arguments (f32, bf16)."""
    import re
    for p in range(len(mangled)):
        m = re.match(r"\d+", mangled[p:])
        if not m or int(m.group()) == 0:
            continue
        name = mangled[p + m.end():p + m.end() + int(m.group())]
        if not (name.endswith("kernel") and name.isidentifier()):
            continue
        rest, args = mangled[p + m.end() + len(name):], []
        if rest.startswith("I"):
            for tok in re.finditer(r"L[a-z](\d+)E|13__nv_bfloat16|f|E", rest[1:]):
                if tok.group() == "E":
                    break
                args.append(tok.group(1) or ("bf16" if tok.group().startswith("13") else "f32"))
        return name + (f"<{','.join(args)}>" if args else "")
    return mangled


def ptxas_entries(report: str):
    """(kernel<template args>, registers, spill store bytes, spill load
    bytes) of each entry in an `nvcc -Xptxas -v` report."""
    import re
    entries, name, spills = [], None, (0, 0)
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = kernel_label(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None:
            entries.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return entries


def phase_build():
    from vitax_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name, log in logs.items():
        say(f"[2 build] {name}: {log['seconds']:.1f}s nvcc ({'cached' if log['cached'] else 'built'})")
        for entry, regs, st, ld in ptxas_entries(log["ptxas"]):
            say(f"[2 build]   {entry}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    say(f"[2 build] all kernels in {time.perf_counter() - t0:.1f}s")


def fwd_kernels(q, k, v):
    """The forward kernels that take these operands, the one
    `choose_fwd_kernel` gives first: both bf16 kernels where the wgmma
    kernel takes them, else the general one."""
    from vitax_torch.ops.attention import FWD_KERNELS, choose_fwd_kernel, wgmma_takes
    chosen = choose_fwd_kernel(q, k, v)
    return [chosen] + [kn for kn in FWD_KERNELS if kn != chosen and (kn == "general" or wgmma_takes(q, k, v))]


def bwd_kernels(q, k, v, o, do):
    """The backward kernels that take these operands, the one
    `choose_bwd_kernel` gives first: both bf16 kernel families where the
    wgmma kernels take them, else the general one."""
    from vitax_torch.ops.attention import BWD_KERNELS, bwd_wgmma_takes, choose_bwd_kernel
    chosen = choose_bwd_kernel(q, k, v, o, do)
    return [chosen] + [kn for kn in BWD_KERNELS
                       if kn != chosen and (kn == "general" or bwd_wgmma_takes(q, k, v, o, do))]


def phase_kernel_check(torch):
    from vitax_torch.ops.attention import attention_fwd_with_lse, flash_attn_fwd_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    with torch.inference_mode():
        for shape in CHECK_SHAPES + FWD_EDGE_SHAPES:
            for dtype in ("bfloat16", "float32"):
                q, k, v = qkv_views(torch, shape, dtype, SEED)
                scale = shape[-1] ** -0.5
                o_ref, lse_ref = attention_fwd_with_lse(q, k, v, scale)
                kernels = fwd_kernels(q, k, v)
                for kern in kernels:
                    o, lse = flash_attn_fwd_cuda(q, k, v, scale, kernel=kern)
                    torch.cuda.synchronize()
                    d_o = (o.float() - o_ref.float()).abs().max().item()
                    d_lse = (lse - lse_ref).abs().max().item()
                    finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
                    tol_o, tol_lse = TOL[dtype]
                    ok = finite and d_o <= tol_o and d_lse <= tol_lse
                    say(f"[3 check] flash_attn_fwd {shape} {dtype}, {kern}{' (chosen)' if kern == kernels[0] else ''}: "
                        f"max|do| {d_o:.3e} (<= {tol_o}) max|dlse| {d_lse:.3e} (<= {tol_lse}) {'ok' if ok else 'FAIL'}")
                    if not ok:
                        fail(f"flash_attn_fwd ({kern}) disagrees with its plain version at {shape} {dtype}")
                    errs[(shape, dtype, kern)] = d_o
                del q, k, v, o, lse, o_ref, lse_ref
    check_general_only_operands(torch)
    errs.update(check_attention_backward(torch))
    errs.update(check_dropout_kernels(torch))
    errs.update(check_bh_entries(torch))
    check_mask_recovery(torch)
    errs["fused_adamw"] = check_fused_adamw(torch)
    errs.update(check_dequant_matmul(torch))
    return errs


def check_general_only_operands(torch):
    """Operands only the general kernel takes: q, k, v views of a qkv tensor
    whose base sits one element (2 bytes) off 16 bytes, and aligned ones
    with a negative scale (the wgmma kernel takes the max of the raw scores
    and needs scale > 0). `choose_fwd_kernel` gives the general kernel,
    which agrees with the plain version; the wgmma kernel forced on them
    raises in Python, and its C entry, called directly, refuses them too."""
    import ctypes
    from vitax_torch.ops import _build
    from vitax_torch.ops.attention import (FWD_KERNELS, KERNEL, _DTYPE_CODES, _kernel_dropout_args,
                                           attention_fwd_with_lse, choose_fwd_kernel, flash_attn_fwd_cuda)
    b, n, h, dh = shape = (2, 197, 4, 64)
    for offset, scale in ((1, dh ** -0.5), (0, -(dh ** -0.5))):
        arr = np.random.default_rng(SEED).standard_normal(b * n * 3 * h * dh + offset).astype(np.float32)
        qkv = torch.from_numpy(arr).to("cuda", torch.bfloat16)[offset:].view(b, n, 3, h, dh)
        q, k, v = qkv.unbind(2)
        with torch.inference_mode():
            chosen = choose_fwd_kernel(q, k, v, scale)
            o, lse = flash_attn_fwd_cuda(q, k, v, scale)
            o_ref, lse_ref = attention_fwd_with_lse(q, k, v, scale)
            torch.cuda.synchronize()
            d_o = (o.float() - o_ref.float()).abs().max().item()
            d_lse = (lse - lse_ref).abs().max().item()
            try:
                flash_attn_fwd_cuda(q, k, v, scale, kernel="wgmma")
                raised = False
            except ValueError:
                raised = True
            lib = _build.load(KERNEL)
            strides = (ctypes.c_int64 * 9)(*(st for x in (q, k, v) for st in x.stride()[:3]))
            err = lib.vitax_flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                                           _DTYPE_CODES[q.dtype], b, n, h, dh, strides, scale,
                                           *_kernel_dropout_args(None), FWD_KERNELS["wgmma"],
                                           torch.cuda.current_stream().cuda_stream)
        tol_o, tol_lse = TOL["bfloat16"]
        ok = chosen == "general" and d_o <= tol_o and d_lse <= tol_lse and raised and err != 0
        say(f"[3 check] flash_attn_fwd {shape} bfloat16, base {q.data_ptr() % 16} bytes off 16, scale {scale:+.4f}: "
            f"takes {chosen}, max|do| {d_o:.3e} max|dlse| {d_lse:.3e}; wgmma forced raises {raised}, its C entry "
            f"returns {err} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("operands only the general kernel takes did not take it, or the wgmma kernel took them")


def dequant_operands(torch, m, k, f, dtype, seed):
    """x (m, k) f32 and a per-channel quantized (f, k) weight of normal
    draws, made on the card from a seed."""
    from vitax_torch.checkpoint.consolidate import quantize_tensor
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device="cuda")
    w = torch.randn(f, k, generator=gen, device="cuda") * 0.02
    q, s = quantize_tensor(w, (1,), dtype)
    return x, q, s.reshape(-1).contiguous()


def check_dequant_matmul(torch) -> dict:
    """Kernel C against its plain versions, every kernel that takes the
    operands (each line names it, and marks the one `choose_kernel` gives):
    weight-only with int8 and fp8 weights and bf16 x at the five main-path
    (K, F) pairs (M 2048, and the head at M 1 and 8), at the tail shapes and
    at the ragged-K shapes (the general kernel alone); f32 x below M 2048
    (the general kernel); act mode (int8 x int8) bitwise at all of them.
    Each check also measures how far a broken kernel would land (scales
    dropped; sx forced to 1) and fails unless that is beyond the bar.
    Returns max |d| of weight-only at the main-path shapes, on the chosen
    kernel and on the general one."""
    from vitax_torch.ops.dequant_matmul import (KERNELS, _matmul_plain, choose_kernel, dequant_matmul_cuda,
                                                kernel_takes, quantize_activations)
    main = [(2048, k, f) for _, k, f, n in DEQUANT_SITES if n > 1] + [(1, 5120, 1000), (8, 5120, 1000)]
    shapes = main + list(DEQUANT_TAIL_SHAPES) + list(DEQUANT_CHECK_SHAPES)
    worst = {"dequant_matmul": 0.0, "dequant_matmul_general": 0.0}
    with torch.inference_mode():
        for i, (m, k, f) in enumerate(shapes):
            on_path = (m, k, f) in main
            for dtype in ("int8", "float8_e4m3"):
                x, q, s = dequant_operands(torch, m, k, f, dtype, SEED + i)
                for xx in ((x.to(torch.bfloat16),) if m == 2048 else (x.to(torch.bfloat16), x)):
                    xdt = str(xx.dtype).replace("torch.", "")
                    chosen = choose_kernel(xx, q)
                    want = _matmul_plain(xx, q, s, None)
                    dropped = _matmul_plain(xx, q, torch.ones_like(s), None)
                    ref = want.abs().max().item()
                    bar = DEQUANT_TOL[xdt] * ref
                    for kern in [kn for kn in KERNELS if kernel_takes(kn, xx, q)]:
                        got = dequant_matmul_cuda(xx, q, s, kernel=kern)
                        torch.cuda.synchronize()
                        d = (got - want).abs().max().item()
                        d_broken = (got - dropped).abs().max().item()
                        ok = bool(torch.isfinite(got).all()) and d <= bar and d_broken > bar
                        say(f"[3 check] dequant_matmul {m}x{k}x{f} {dtype} w, {xdt} x, {kern}"
                            f"{' (chosen)' if kern == chosen else ''}: max|d| {d:.3e} (<= {bar:.3e}, max|ref| "
                            f"{ref:.3e}, ratio {d / ref:.2e}); scales dropped: {d_broken:.3e} {'ok' if ok else 'FAIL'}")
                        if not ok:
                            fail(f"dequant_matmul ({kern}) disagrees with its plain version at {m}x{k}x{f} {dtype} "
                                 f"{xdt}")
                        if on_path and xdt == "bfloat16" and kern in (chosen, "general"):
                            key = "dequant_matmul_general" if kern == "general" else "dequant_matmul"
                            worst[key] = max(worst[key], d)
                if dtype == "int8":
                    xq, sx = quantize_activations(x.to(torch.bfloat16))
                    chosen = choose_kernel(xq, q)
                    want = _matmul_plain(xq, q, s, sx)
                    forced = _matmul_plain(xq, q, s, torch.ones_like(sx))
                    for kern in [kn for kn in KERNELS if kernel_takes(kn, xq, q)]:
                        got = dequant_matmul_cuda(xq, q, s, sx, kernel=kern)
                        torch.cuda.synchronize()
                        equal = torch.equal(got, want)
                        d_broken = (got - forced).abs().max().item()
                        ok = equal and d_broken > DEQUANT_TOL["bfloat16"] * want.abs().max().item()
                        say(f"[3 check] dequant_matmul {m}x{k}x{f} act int8 x int8, {kern}"
                            f"{' (chosen)' if kern == chosen else ''}: bitwise equal {equal}; sx forced to 1: "
                            f"max|d| {d_broken:.3e} {'ok' if ok else 'FAIL'}")
                        if not ok:
                            fail(f"dequant_matmul ({kern}) act mode is not bitwise equal to its plain version at "
                                 f"{m}x{k}x{f}")
                del x, q, s
    torch.cuda.empty_cache()
    return worst


def check_attention_backward(torch) -> dict:
    """Each backward kernel that takes the operands (wgmma and general in
    bf16 at Dh 64 and 160) against the plain version, bf16 and f32, with a
    nonzero dlse, at the train shape and the ragged shapes; each call twice,
    bitwise equal. Returns max |d| at the train shape in bf16, by kernel."""
    from vitax_torch.ops.attention import attention_bwd_with_lse, flash_attn_bwd_cuda, flash_attn_fwd_cuda
    worst = {}
    with torch.inference_mode():
        for shape in (TRAIN_SHAPE,) + CHECK_SHAPES[1:]:
            b, n, h, dh = shape
            for dtype in ("bfloat16", "float32"):
                q, k, v = qkv_views(torch, shape, dtype, SEED + 1)
                rng = np.random.default_rng(SEED + 2)
                do = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", getattr(torch, dtype))
                dlse = torch.from_numpy(rng.standard_normal((b, h, n)).astype(np.float32)).cuda(0)
                scale = dh ** -0.5
                o, lse = flash_attn_fwd_cuda(q, k, v, scale)
                want = attention_bwd_with_lse(q, k, v, o, lse, do, dlse, scale)
                no_dlse = attention_bwd_with_lse(q, k, v, o, lse, do, None, scale)
                refs = [w.float().abs().max().item() for w in want]
                bars = [BWD_TOL[dtype] * r for r in refs]
                dlse_term = [(w.float() - w0.float()).abs().max().item() for w, w0 in zip(want[:2], no_dlse[:2])]
                visible = all(t > b for t, b in zip(dlse_term, bars[:2]))
                kernels = bwd_kernels(q, k, v, o, do)
                for kern in kernels:
                    got = flash_attn_bwd_cuda(q, k, v, o, lse, do, dlse, scale, kernel=kern)
                    again = flash_attn_bwd_cuda(q, k, v, o, lse, do, dlse, scale, kernel=kern)
                    torch.cuda.synchronize()
                    errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, want)]
                    repeat = all(torch.equal(a, a2) for a, a2 in zip(got, again))
                    finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
                    ok = finite and repeat and visible and all(e <= b for e, b in zip(errs, bars))
                    say(f"[3 check] flash_attn_bwd {shape} {dtype}, {kern}{' (chosen)' if kern == kernels[0] else ''}: "
                        + ", ".join(f"{nm} max|d| {e:.3e} (<= {b:.3e}, max|ref| {r:.3e}, ratio {e / r:.2e})"
                                    for nm, e, b, r in zip(("dq", "dk", "dv"), errs, bars, refs))
                        + f"; dlse term moves dq {dlse_term[0]:.3e} dk {dlse_term[1]:.3e}; bitwise repeat "
                        f"{repeat} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        fail(f"flash_attn_bwd ({kern}) disagrees with its plain version at {shape} {dtype}")
                    if shape == TRAIN_SHAPE and dtype == "bfloat16":
                        worst["flash_attn_bwd" + ("" if kern == "wgmma" else "_general")] = max(errs)
                    del got, again
    return worst


def attention_operands(torch, shape, dtype, seed):
    """Strided q, k, v views, and dO (B, N, H, Dh) and dlse (B, H, N) from
    numpy draws."""
    b, n, h, dh = shape
    q, k, v = qkv_views(torch, shape, dtype, seed)
    rng = np.random.default_rng(seed + 1)
    do = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", getattr(torch, dtype))
    dlse = torch.from_numpy(rng.standard_normal((b, h, n)).astype(np.float32)).cuda(0)
    return q, k, v, do, dlse


def rel_err(torch, got, want) -> float:
    return (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()


def check_dropout_kernels(torch):
    """The dropout instantiations of the forward and backward kernels
    (A6c, A6d) against their plain versions: at the train shape (bf16,
    offsets 0 as the train path calls them) and at ragged shapes in bf16
    and f32 with global offsets, a nonzero dlse and a bitwise repeat of
    the backward; each forward kernel that takes the operands in turn. The
    plain version at a seed off by one must land beyond every bar. Returns
    max |d| of o and of the gradients at the train shape (the chosen
    kernel)."""
    from vitax_torch.ops.attention import (Dropout, attention_bwd_with_lse, attention_fwd_with_lse,
                                           flash_attn_bwd_cuda, flash_attn_fwd_cuda)
    errs = {}
    cases = [(TRAIN_SHAPE, "bfloat16", (0, 0))]
    cases += [(shape, dtype, DROP_OFFSETS) for shape in DROP_CHECK_SHAPES for dtype in ("bfloat16", "float32")]
    with torch.inference_mode():
        for shape, dtype, (q0, k0) in cases:
            q, k, v, do, dlse = attention_operands(torch, shape, dtype, SEED + 10)
            drop = Dropout(DROP_SEED, DROP_RATE, q0, k0)
            off = drop._replace(seed=DROP_SEED + 1)
            scale = shape[-1] ** -0.5
            o_ref, lse_ref = attention_fwd_with_lse(q, k, v, scale, drop)
            o_off, _ = attention_fwd_with_lse(q, k, v, scale, off)
            kernels = fwd_kernels(q, k, v)
            for kern, bkern in ((kn, bk) for kn in kernels for bk in bwd_kernels(q, k, v, o_ref, do)):
                o, lse = flash_attn_fwd_cuda(q, k, v, scale, drop, kernel=kern)
                got = flash_attn_bwd_cuda(q, k, v, o, lse, do, dlse, scale, drop, kernel=bkern)
                again = flash_attn_bwd_cuda(q, k, v, o, lse, do, dlse, scale, drop, kernel=bkern)
                want = attention_bwd_with_lse(q, k, v, o, lse, do, dlse, scale, drop)
                wrong = attention_bwd_with_lse(q, k, v, o, lse, do, dlse, scale, off)
                torch.cuda.synchronize()
                tol_o, tol_g = DROP_TOL[dtype]
                e_o, e_off = rel_err(torch, o, o_ref), rel_err(torch, o, o_off)
                d_lse = (lse - lse_ref).abs().max().item()
                e_g = [rel_err(torch, a, w) for a, w in zip(got, want)]
                e_g_off = [rel_err(torch, a, w) for a, w in zip(got, wrong)]
                repeat = all(torch.equal(a, a2) for a, a2 in zip(got, again))
                finite = bool(torch.isfinite(o.float()).all()) and all(bool(torch.isfinite(a.float()).all())
                                                                       for a in got)
                ok = (finite and repeat and e_o <= tol_o < e_off and d_lse <= TOL[dtype][1]
                      and all(e <= tol_g < e2 for e, e2 in zip(e_g, e_g_off)))
                say(f"[3 check] flash_attn dropout {shape} {dtype} rate {DROP_RATE} q0/k0 {q0}/{k0}, forward {kern}"
                    f"{' (chosen)' if kern == kernels[0] else ''}, backward {bkern}: o max|d|/max|ref| {e_o:.2e} "
                    f"(<= {tol_o}; seed off "
                    f"by one {e_off:.2e}), max|dlse| {d_lse:.2e}; "
                    + ", ".join(f"{nm} {e:.2e} (<= {tol_g}; seed off by one {e2:.2e})"
                                for nm, e, e2 in zip(("dq", "dk", "dv"), e_g, e_g_off))
                    + f"; bitwise repeat {repeat} {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"the dropout attention kernels ({kern} forward, {bkern} backward) disagree with their plain "
                         f"versions at {shape} {dtype}")
                if shape == TRAIN_SHAPE and kern == kernels[0] and bkern == "wgmma":
                    errs["flash_attn_fwd_drop"] = (o.float() - o_ref.float()).abs().max().item()
                    errs["flash_attn_bwd_drop"] = max((a.float() - w.float()).abs().max().item()
                                                      for a, w in zip(got, want))
                del o, lse, got, again, want, wrong
            del q, k, v, do, dlse, o_ref, o_off
    torch.cuda.empty_cache()
    return errs


def check_bh_entries(torch):
    """The BH entry points on (B*H, N, Dh): flash_bh_with_lse (A3, A3b)
    and flash_bh_dropout_lse (A6a, A6b), forward and autograd backward with
    a nonzero dlse, against the plain versions in the BH kernels' order on
    (B*H, N, 1, Dh) views; at the train shape's rows (bf16, each forward
    kernel in turn) and a ragged f32 shape with offsets. Returns max |d| of
    each entry at the train shape (the chosen kernel)."""
    from vitax_torch.ops.attention import (Dropout, _to_bh, attention_bwd_with_lse, attention_fwd_with_lse,
                                           flash_bh_dropout_lse, flash_bh_with_lse, forced_bwd_kernel,
                                           forced_fwd_kernel)
    errs = {}
    for shape, dtype, (q0, k0) in ((TRAIN_SHAPE, "bfloat16", (0, 0)), (DROP_CHECK_SHAPES[0], "float32", DROP_OFFSETS)):
        q4, k4, v4, do4, dlse = attention_operands(torch, shape, dtype, SEED + 12)
        q, k, v, do = (_to_bh(x).contiguous() for x in (q4, k4, v4, do4))
        dlse = dlse.reshape(-1, shape[1])
        scale = shape[-1] ** -0.5
        del q4, k4, v4, do4
        kernels = fwd_kernels(*(x[:, :, None] for x in (q, k, v)))
        bkernels = bwd_kernels(*(x[:, :, None] for x in (q, k, v, torch.empty_like(q), do)))
        for drop in (None, Dropout(DROP_SEED, DROP_RATE, q0, k0)):
            for kern, bkern in ((kn, bk) for kn in kernels for bk in bkernels):
                leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
                with forced_fwd_kernel(kern), forced_bwd_kernel(bkern):
                    if drop is None:
                        o, lse = flash_bh_with_lse(*leaves, scale)
                    else:
                        o, lse = flash_bh_dropout_lse(*leaves, (drop.seed, drop.q0, drop.k0), scale, drop.rate)
                    torch.autograd.backward((o, lse), (do, dlse))
                with torch.no_grad():
                    views = [x[:, :, None] for x in (q, k, v)]
                    o_ref, lse_ref = attention_fwd_with_lse(*views, scale, drop, normalize_first=False)
                    want = attention_bwd_with_lse(*views, o.detach()[:, :, None], lse.detach()[:, None],
                                                  do[:, :, None], dlse[:, None], scale, drop)
                torch.cuda.synchronize()
                tol_o, tol_g = DROP_TOL[dtype]
                e_o = rel_err(torch, o.detach(), o_ref[:, :, 0])
                d_lse = (lse.detach() - lse_ref[:, 0]).abs().max().item()
                e_g = [rel_err(torch, x.grad, w[:, :, 0]) for x, w in zip(leaves, want)]
                ok = e_o <= tol_o and d_lse <= TOL[dtype][1] and all(e <= tol_g for e in e_g)
                name = "flash_bh" + ("" if drop is None else "_drop")
                say(f"[3 check] {name} {tuple(q.shape)} {dtype}" + ("" if drop is None else f" q0/k0 {q0}/{k0}")
                    + f", forward {kern}{' (chosen)' if kern == kernels[0] else ''}, backward {bkern}"
                    + f"{' (chosen)' if bkern == bkernels[0] else ''}: o max|d|/max|ref| {e_o:.2e} "
                    f"(<= {tol_o}), max|dlse| {d_lse:.2e}; "
                    + ", ".join(f"{nm} {e:.2e}" for nm, e in zip(("dq", "dk", "dv"), e_g))
                    + f" (<= {tol_g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"{name} ({kern} forward, {bkern} backward) disagrees with its plain version at "
                         f"{tuple(q.shape)} {dtype}")
                if shape == TRAIN_SHAPE and kern == kernels[0] and bkern == bkernels[0]:
                    suffix = "" if drop is None else "_drop"
                    errs["flash_bh_fwd" + suffix] = (o.detach().float() - o_ref[:, :, 0].float()).abs().max().item()
                    errs["flash_bh_bwd" + suffix] = max((x.grad.float() - w[:, :, 0].float()).abs().max().item()
                                                        for x, w in zip(leaves, want))
                del leaves, o, lse, o_ref, lse_ref, want
        del q, k, v, do, dlse
    torch.cuda.empty_cache()
    return errs


def check_mask_recovery(torch):
    """The mask read back from the kernel: q = k = 0 makes P uniform and V
    = I (N = Dh = 128) makes o = mask / (N (1 - rate)), so the nonzero
    pattern of o is the kernel's keep-mask. It must equal the plain
    dropout_keep_mask bit for bit on the 4D and the BH entry, with global
    offsets, for each forward kernel that takes the operands, and differ
    from the mask of a seed off by one."""
    from vitax_torch.ops.attention import (Dropout, _to_bh, flash_attn_fwd_cuda, flash_bh_dropout_lse,
                                           forced_fwd_kernel, keep_mask_bhqk)
    b, h, n = 2, 3, 128
    drop = Dropout(DROP_SEED, DROP_RATE, 3, 1000)
    mask = keep_mask_bhqk(drop, b, h, n, n, "cuda")
    off = keep_mask_bhqk(drop._replace(seed=DROP_SEED + 1), b, h, n, n, "cuda")
    with torch.inference_mode():
        for dtype in ("bfloat16", "float32"):
            zero = torch.zeros(b, n, h, n, device="cuda", dtype=getattr(torch, dtype))
            eye = torch.eye(n, device="cuda", dtype=zero.dtype)[None, :, None, :].expand(b, n, h, n).contiguous()
            for kern in fwd_kernels(zero, zero, eye):
                with forced_fwd_kernel(kern):
                    o4, _ = flash_attn_fwd_cuda(zero, zero, eye, 1.0, drop)
                    obh, _ = flash_bh_dropout_lse(_to_bh(zero), _to_bh(zero), _to_bh(eye),
                                                  (drop.seed, drop.q0, drop.k0), 1.0, drop.rate)
                pat4 = (o4 != 0).float().transpose(1, 2)
                patbh = (obh != 0).float().reshape(b, h, n, n)
                kept = o4.float().transpose(1, 2)[mask.bool()]
                value = 1.0 / (n * (1.0 - DROP_RATE))
                spread = (kept / value - 1).abs().max().item()
                n_off = int((pat4 != off).sum().item())
                ok = (torch.equal(pat4, mask) and torch.equal(patbh, mask) and n_off > 0
                      and spread <= (8e-3 if dtype == "bfloat16" else 1e-6))
                say(f"[3 check] dropout mask from the kernel, {dtype}, {kern}, (B {b}, H {h}, N {n}), q0/k0 "
                    f"{drop.q0}/{drop.k0}: 4D pattern == plain mask {torch.equal(pat4, mask)}, BH pattern == plain "
                    f"mask {torch.equal(patbh, mask)}, kept share {mask.mean().item():.4f}, kept values within "
                    f"{spread:.1e} of 1/(N(1-rate)); a seed off by one differs at {n_off} of {mask.numel()} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"the kernel's dropout mask is not the plain mask ({dtype}, {kern})")


def check_streaming(torch):
    """Phase 3L: the streaming entries against the plain versions on the
    card at N > 2048: blocked_with_lse (the 4D entries' core) on strided
    views of one qkv tensor, with autograd, at LONG_CHECK_CASES (the ViT-L
    shape at N 4096, a ragged N and Dh 160 in bf16 and f32 with global
    offsets past 2048; phase 7L's N 9216 in bf16 at offsets 0), rate 0 and
    0.1, each forward kernel that takes the operands in turn and under each
    backward kernel that does, a nonzero dlse, and each backward run twice,
    bitwise equal. The plain versions run at 64 x 64 tiles on the kernels' o
    and lse.
    Under dropout the plain version at a seed off by one, at rate 0 without
    dlse, must land beyond the bars. Then the BH entries once, and the mask
    read back. Every case prints before the phase fails. Returns max |d| of
    o and of dk/dv and dq (and the general backward's) at the ViT-L shape in
    bf16 at rate 0."""
    from vitax_torch.ops.attention import Dropout, _from_bh, _to_bh, forced_bwd_kernel, forced_fwd_kernel
    from vitax_torch.ops.flash_blocked import blocked_with_lse, streaming_bwd_with_lse, streaming_fwd_with_lse
    torch.backends.cuda.matmul.allow_tf32 = False
    errs, bad = {}, []
    for shape, dtypes, offsets in LONG_CHECK_CASES:
        b, n, h, dh = shape
        scale = dh ** -0.5
        for dtype in dtypes:
            q, k, v, do, dlse = attention_operands(torch, shape, dtype, SEED + 20)
            qkv = torch.stack((q, k, v), dim=2)
            bkernels = bwd_kernels(*qkv.unbind(2), torch.empty_like(q), do)
            for rate, kern in ((r, kn) for r in (0.0, DROP_RATE) for kn in fwd_kernels(*qkv.unbind(2))):
                drop = Dropout(DROP_SEED, rate, *offsets) if rate else None
                runs = {}
                for bkern in bkernels:
                    runs[bkern] = []
                    for _ in range(2):
                        leaf = qkv.clone().requires_grad_(True)
                        with forced_fwd_kernel(kern), forced_bwd_kernel(bkern):
                            o, lse = blocked_with_lse(*leaf.unbind(2), scale, LONG_TILE, LONG_TILE, drop)
                            torch.autograd.backward((o, lse), (do, dlse))
                        runs[bkern].append(leaf.grad.unbind(2))
                o, lse = o.detach(), lse.detach()
                with torch.no_grad():
                    bh = [_to_bh(x) for x in (q, k, v)]
                    args = (*bh, _to_bh(o), lse.reshape(b * h, n), _to_bh(do))
                    o_ref, lse_ref = streaming_fwd_with_lse(*bh, scale, LONG_TILE, LONG_TILE, drop)
                    want = streaming_bwd_with_lse(*args, dlse.reshape(b * h, n), scale, LONG_TILE, LONG_TILE, drop)
                    if drop is None:
                        o_off = None
                        other = streaming_bwd_with_lse(*args, None, scale, LONG_TILE, LONG_TILE)
                    else:
                        off = drop._replace(seed=DROP_SEED + 1)
                        o_off = _from_bh(streaming_fwd_with_lse(*bh, scale, LONG_TILE, LONG_TILE, off)[0], shape)
                        other = streaming_bwd_with_lse(*args, dlse.reshape(b * h, n), scale, LONG_TILE,
                                                       LONG_TILE, off)
                o_ref = _from_bh(o_ref, shape)
                want = [_from_bh(w, shape) for w in want]
                other = [_from_bh(w, shape) for w in other]
                torch.cuda.synchronize()
                tol_o, tol_g, tol_lse = LONG_TOL[dtype]
                e_o = rel_err(torch, o, o_ref)
                d_lse = (lse - lse_ref.reshape(b, h, n)).abs().max().item()
                e_o_off = None if o_off is None else rel_err(torch, o, o_off)
                for bkern, grads in runs.items():
                    e_g = [rel_err(torch, a, w) for a, w in zip(grads[0], want)]
                    e_other = [rel_err(torch, a, w) for a, w in zip(grads[0], other)]
                    repeat = all(torch.equal(a, a2) for a, a2 in zip(*grads))
                    finite = bool(torch.isfinite(o.float()).all()) and all(bool(torch.isfinite(a.float()).all())
                                                                           for a in grads[0])
                    # the other arm must be told apart: every grad under a wrong seed, dq and dk without dlse
                    told = e_other if drop is not None else e_other[:2]
                    ok = (finite and repeat and e_o <= tol_o and d_lse <= tol_lse and all(e <= tol_g for e in e_g)
                          and all(e > tol_g for e in told) and (e_o_off is None or e_o_off > tol_o))
                    what = "seed off by one" if drop is not None else "plain without dlse"
                    say(f"[3L check] blocked_with_lse {shape} {dtype} rate {rate}"
                        + (f" q0/k0 {drop.q0}/{drop.k0}" if drop else "")
                        + f", forward {kern}, backward {bkern}: o max|d|/max|ref| {e_o:.2e} (<= {tol_o}"
                        + ("" if e_o_off is None else f"; seed off by one {e_o_off:.2e}")
                        + f"), max|dlse| {d_lse:.2e} (<= {tol_lse}); "
                        + ", ".join(f"{nm} {e:.2e}" for nm, e in zip(("dq", "dk", "dv"), e_g))
                        + f" (<= {tol_g}; {what}: " + ", ".join(f"{e:.2e}" for e in e_other)
                        + f"); bitwise repeat {repeat} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        bad.append(f"{shape} {dtype} rate {rate} {kern} forward, {bkern} backward")
                    if shape == LONG_SHAPE and dtype == "bfloat16" and drop is None and kern == "wgmma":
                        suffix = "" if bkern == "wgmma" else "_general"
                        errs["flash_attn_fwd_stream"] = (o.float() - o_ref.float()).abs().max().item()
                        dkdv = max((a.float() - w.float()).abs().max().item() for a, w in zip(grads[0][1:], want[1:]))
                        dq = (grads[0][0].float() - want[0].float()).abs().max().item()
                        errs["flash_attn_bwd_stream" + suffix] = max(dkdv, dq)
                        if bkern == "wgmma":
                            errs["flash_attn_bwd_stream_dkdv"], errs["flash_attn_bwd_stream_dq"] = dkdv, dq
                del leaf, runs, grads, o, lse, o_ref, lse_ref, want, other, o_off, bh, args
            del q, k, v, do, dlse, qkv
        torch.cuda.empty_cache()
    bad += check_streaming_bh(torch)
    bad += check_stream_mask_recovery(torch)
    if bad:
        fail(f"the streaming entries disagree with their plain versions: {bad}")
    return errs


def check_streaming_bh(torch):
    """blocked_bh_with_lse and blocked_bh_dropout_lse on a (B*H, N, Dh)
    copy of the ragged long shape, f32, with offsets: forward and autograd
    backward with dlse against the plain versions. Returns the failures."""
    from vitax_torch.ops.attention import Dropout, _to_bh
    from vitax_torch.ops.flash_blocked import (blocked_bh_dropout_lse, blocked_bh_with_lse, streaming_bwd_with_lse,
                                               streaming_fwd_with_lse)
    shape = LONG_CHECK_CASES[1][0]
    b, n, h, dh = shape
    scale = dh ** -0.5
    q4, k4, v4, do4, dlse = attention_operands(torch, shape, "float32", SEED + 22)
    q, k, v, do = (_to_bh(x).contiguous() for x in (q4, k4, v4, do4))
    dlse = dlse.reshape(b * h, n)
    bad = []
    tol_o, tol_g, tol_lse = LONG_TOL["float32"]
    for drop in (None, Dropout(DROP_SEED, DROP_RATE, *LONG_OFFSETS)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        if drop is None:
            o, lse = blocked_bh_with_lse(*leaves, scale, LONG_TILE, LONG_TILE)
        else:
            o, lse = blocked_bh_dropout_lse(*leaves, (drop.seed, drop.q0, drop.k0), scale, drop.rate, LONG_TILE,
                                            LONG_TILE)
        torch.autograd.backward((o, lse), (do, dlse))
        with torch.no_grad():
            o_ref, lse_ref = streaming_fwd_with_lse(q, k, v, scale, LONG_TILE, LONG_TILE, drop)
            want = streaming_bwd_with_lse(q, k, v, o.detach(), lse.detach(), do, dlse, scale, LONG_TILE,
                                          LONG_TILE, drop)
        torch.cuda.synchronize()
        e_o = rel_err(torch, o.detach(), o_ref)
        d_lse = (lse.detach() - lse_ref).abs().max().item()
        e_g = [rel_err(torch, x.grad, w) for x, w in zip(leaves, want)]
        ok = e_o <= tol_o and d_lse <= tol_lse and all(e <= tol_g for e in e_g)
        name = "blocked_bh" + ("_with_lse" if drop is None else "_dropout_lse")
        say(f"[3L check] {name} {tuple(q.shape)} float32 q0/k0 {LONG_OFFSETS[0]}/{LONG_OFFSETS[1]}: o max|d|/max|ref| "
            f"{e_o:.2e} (<= {tol_o}), max|dlse| {d_lse:.2e} (<= {tol_lse}); "
            + ", ".join(f"{nm} {e:.2e}" for nm, e in zip(("dq", "dk", "dv"), e_g)) + f" (<= {tol_g}) "
            + ("ok" if ok else "FAIL"))
        if not ok:
            bad.append(name)
    return bad


def check_stream_mask_recovery(torch):
    """The mask read back out of the kernel through the streaming entries
    at N 4096, past 2048: q = k = 0 makes P uniform, and V[key, d] = 1 for
    key = 2112 + d (Dh 128) makes o[q, d] = mask(q, 2112 + d) / (N (1 -
    rate)), a 128-key window of the mask at global offsets (2100, 3000).
    It must equal the plain hash bit for bit on the 4D and the BH entry and
    differ from a seed off by one. Returns the failures."""
    from vitax_torch.ops.attention import Dropout, _keep, _to_bh, forced_fwd_kernel
    from vitax_torch.ops.flash_blocked import blocked_bh_dropout_lse, blocked_with_lse
    b, h, n, dh, kw = 1, 2, 4096, 128, 2112
    drop = Dropout(DROP_SEED, DROP_RATE, *LONG_OFFSETS)
    idx = dict(dtype=torch.int64, device="cuda")
    bhs = torch.arange(b * h, **idx).view(-1, 1, 1)
    rows = torch.arange(n, **idx).view(n, 1) + drop.q0
    cols = torch.arange(kw, kw + dh, **idx) + drop.k0
    mask = _keep(drop.seed, bhs, rows, cols, drop.rate)
    off = _keep(drop.seed + 1, bhs, rows, cols, drop.rate)
    bad = []
    with torch.inference_mode():
        for dtype in ("bfloat16", "float32"):
            zero = torch.zeros(b, n, h, dh, device="cuda", dtype=getattr(torch, dtype))
            v = zero.clone()
            v[:, kw:kw + dh] = torch.eye(dh, device="cuda", dtype=zero.dtype)[None, :, None, :]
            for kern in fwd_kernels(zero, zero, v):
                with forced_fwd_kernel(kern):
                    o4, _ = blocked_with_lse(zero, zero, v, 1.0, LONG_TILE, LONG_TILE, drop)
                    obh, _ = blocked_bh_dropout_lse(_to_bh(zero), _to_bh(zero), _to_bh(v),
                                                    (drop.seed, drop.q0, drop.k0), 1.0, drop.rate, LONG_TILE,
                                                    LONG_TILE)
                pat4 = _to_bh(o4) != 0
                patbh = obh != 0
                kept = _to_bh(o4).float()[mask]
                spread = (kept * (n * (1.0 - DROP_RATE)) - 1).abs().max().item()
                n_off = int((pat4 != off).sum().item())
                ok = (torch.equal(pat4, mask) and torch.equal(patbh, mask) and n_off > 0
                      and spread <= (8e-3 if dtype == "bfloat16" else 1e-5))
                say(f"[3L check] dropout mask from the kernel through the streaming entries, {dtype}, {kern}, (B {b}, "
                    f"H {h}, N {n}), keys {kw}-{kw + dh - 1}, q0/k0 {drop.q0}/{drop.k0}: 4D pattern == plain mask "
                    f"{torch.equal(pat4, mask)}, BH pattern == plain mask {torch.equal(patbh, mask)}, kept share "
                    f"{mask.float().mean().item():.4f}, kept values within {spread:.1e} of 1/(N(1-rate)); a seed off "
                    f"by one differs at {n_off} of {mask.numel()} {'ok' if ok else 'FAIL'}")
                if not ok:
                    bad.append(f"mask read back ({dtype}, {kern})")
    return bad

def adamw_diff(torch, got, ref):
    """(max |d|, elements outside rtol / atol) of the kernel's p, mu, nu
    lists against the plain version's."""
    torch.cuda.synchronize()
    d, bad = 0.0, 0
    for gots, wants in zip(got, ref):
        for a, w in zip(gots, wants):
            diff = (a - w).abs()
            d = max(d, diff.max().item())
            bad += int((diff > ADAMW_ATOL + ADAMW_RTOL * w.abs()).sum().item())
    return d, bad


def check_fused_adamw(torch) -> float:
    """The fused optimizer kernel against clip_adamw_ over leaves of
    assorted sizes: odd lengths, lengths not a multiple of 4, one leaf whose
    base is not 16-byte aligned, and one 10B-width block's leaves; the clip
    triggered and idle. Returns the largest |d| over p, mu, nu."""
    from vitax_torch.ops.fused_optimizer import clip_adamw_, fused_adamw_cuda, global_norm, step_scalars
    from vitax_torch.train.schedule import warmup_cosine_schedule
    from vitax_torch.train.state import ADAMW_HPARAMS
    d_, h_ = 5120, 20480
    shapes = [(7,), (5, 3), (4099,), (1,), (3 * d_, d_), (3 * d_,), (d_, d_), (h_, d_), (d_, h_), (h_,), (d_,)]
    hp = (ADAMW_HPARAMS["b1"], ADAMW_HPARAMS["b2"], ADAMW_HPARAMS["eps"], 0.1)
    sched = warmup_cosine_schedule(1e-3, 4, 100)
    worst = 0.0
    for clip in (1.0, 1e9):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)

        def leaf(shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale

        p, g = [leaf(s_, 0.02) for s_ in shapes], [leaf(s_, 1e-3) for s_ in shapes]
        mu, nu = [leaf(s_, 1e-4) for s_ in shapes], [leaf(s_, 1e-4).square() for s_ in shapes]
        base = leaf((1000,))
        p.append(base[1:])                 # 4 bytes past an aligned base: the scalar path
        g.append(leaf((999,), 1e-3))
        mu.append(leaf((999,), 1e-4))
        nu.append(leaf((999,), 1e-4).square())
        ref = [[x.clone() for x in xs] for xs in (p, mu, nu)]
        norm = global_norm(g)
        scal = step_scalars(torch.tensor(5, dtype=torch.int32, device="cuda"), norm, sched, clip,
                            hp[0], hp[1])
        # the same step with --backbone_lr_mult's per-leaf multipliers, 0.1
        # and 1 in turns: against the plain version with the same, and the
        # leaves at 1 bitwise the step without multipliers
        mults = [0.1 if i % 2 == 0 else 1.0 for i in range(len(p))]
        scaled = [[x.clone() for x in xs] for xs in (p, mu, nu)]
        scaled_ref = [[x.clone() for x in xs] for xs in (p, mu, nu)]
        fused_adamw_cuda(p, g, mu, nu, scal, hp)
        clip_adamw_(ref[0], g, ref[1], ref[2], scal, hp)
        d, bad = adamw_diff(torch, (p, mu, nu), ref)
        fused_adamw_cuda(scaled[0], g, scaled[1], scaled[2], scal, hp, mults)
        clip_adamw_(scaled_ref[0], g, scaled_ref[1], scaled_ref[2], scal, hp, mults)
        d_m, bad_m = adamw_diff(torch, scaled, scaled_ref)
        unit_bitwise = all(torch.equal(scaled[0][i], p[i]) for i, m in enumerate(mults) if m == 1.0)
        moved = all(not torch.equal(scaled[0][i], p[i]) for i, m in enumerate(mults) if m != 1.0)
        ok = bad == 0 and bad_m == 0 and unit_bitwise and moved and all(bool(torch.isfinite(a).all()) for a in p)
        say(f"[3 check] fused_adamw {len(p)} leaves ({sum(x.numel() for x in p):,} params), clip "
            f"{'triggered' if scal[0].item() < 1 else 'idle'} (scale {scal[0].item():.4g}): max|d| {d:.3e}, "
            f"{bad} elements outside rtol {ADAMW_RTOL} / atol {ADAMW_ATOL}; lr multipliers 0.1 and 1 in turns: "
            f"max|d| {d_m:.3e}, {bad_m} outside, the leaves at 1 bitwise the unscaled step {unit_bitwise}, those "
            f"at 0.1 moved {moved} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("fused_adamw disagrees with its plain version, or its multiplier 1 is not the unscaled step")
        worst = max(worst, d, d_m)
        del p, g, mu, nu, ref, scaled, scaled_ref
        torch.cuda.empty_cache()
    return worst


def time_in_turns(torch, call, kernels, iters):
    """Kernels on the same operands, in turns (wgmma, general, general,
    wgmma), CUDA events: {kernel: (best, "a / b")}. `call(kernel)` makes
    one call."""
    got = {}
    for kern in kernels + kernels[::-1]:
        got.setdefault(kern, []).append(time_ms(torch, lambda: call(kern), iters=iters))
    return {kern: (min(ts), " / ".join(f"{t:.4f}" for t in ts)) for kern, ts in got.items()}


def time_fwd_kernels(torch, q, k, v, scale, d=None, iters=50):
    """The forward's wgmma and general kernels in turns (`time_in_turns`).
    Operands the wgmma kernel does not take time the general kernel alone."""
    from vitax_torch.ops.attention import flash_attn_fwd_cuda
    return time_in_turns(torch, lambda kern: flash_attn_fwd_cuda(q, k, v, scale, d, kernel=kern),
                         fwd_kernels(q, k, v), iters)


def fwd_time_text(times, bound_ms, flops) -> str:
    """`wgmma a / b ms (x% of the tensor-core peak), general ...`."""
    return ", ".join(f"{kern} {shown} ms ({flops / PEAK_FLOPS['bfloat16'] * 1e3 / best * 100:.1f}% of the tensor-core "
                     f"peak, {bound_ms / best * 100:.1f}% of the bound)" for kern, (best, shown) in times.items())


def phase_kernel_timing(torch, card):
    import torch.nn.functional as F
    from vitax_torch.ops.attention import attention_fwd_with_lse, flash_attn_fwd_cuda
    q, k, v = qkv_views(torch, SERVE_SHAPE, "bfloat16", SEED)
    scale = SERVE_SHAPE[-1] ** -0.5
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    bound_ms, bound_by, nbytes, flops = attention_bound_ms(SERVE_SHAPE, "bfloat16")
    with torch.inference_mode():
        times = time_fwd_kernels(torch, q, k, v, scale, iters=100)
        plain_ms = time_ms(torch, lambda: attention_fwd_with_lse(q, k, v, scale), iters=20)
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), iters=100)
        host = {}
        for kern in times:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                flash_attn_fwd_cuda(q, k, v, scale, kernel=kern)
            host[kern] = (time.perf_counter() - t0) / 20 * 1e6
            torch.cuda.synchronize()
        device = {kern: profiled_ms(torch, lambda: flash_attn_fwd_cuda(q, k, v, scale, kernel=kern),
                                    {kern: FWD_KERNEL_NAMES[kern]}, 50)[kern] for kern in times}
    say(f"[4 time] flash_attn_fwd {SERVE_SHAPE} bf16, CUDA events over back-to-back calls: "
        f"{fwd_time_text(times, bound_ms, flops)}; plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) [{card}]")
    say("[4 time] flash_attn_fwd host time per wrapper call (enqueue, no sync): "
        + ", ".join(f"{kern} {us:.1f} us" for kern, us in host.items())
        + f" (the wgmma kernel encodes three tensor maps a call; a bucket-8 forward makes {SERVE_BLOCKS} calls); "
        "the kernels' own device time per launch (torch.profiler): "
        + fwd_time_text({kern: (ms, f"{ms:.4f}") for kern, ms in device.items()}, bound_ms, flops) + f" [{card}]")
    # a wrapper call's host time exceeds the wgmma kernel's here, so the
    # profiler's device time is the kernel's time
    timing = {f"flash_attn_fwd{'' if kern == 'wgmma' else '_general'}": {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        for kern, ms in device.items()}
    timing.update(time_attention_train_shape(torch, card))
    timing.update(time_dropout_and_bh(torch, card))
    timing.update(time_dequant_matmul(torch, card))
    return timing


def dequant_bound_ms(m, k, f, act: bool):
    """Least time for one call: x (bf16, or int8 codes in act mode), the
    1-byte weight and the scales read once, the f32 output written once,
    over HBM bandwidth; 2 M K F operations over the bf16 (weight-only) or
    int8 (act) tensor-core peak."""
    nbytes = m * k * (1 if act else 2) + f * k + 4 * f + 4 * m * f + (4 if act else 0)
    ops = 2 * m * k * f
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS["int8" if act else "bfloat16"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def time_dequant_matmul(torch, card):
    """Kernel C at each main-path site, at bucket 8's M 2048 and bucket 1's
    M 256 (the head at M 8 and 1), CUDA events, in turns for each mode
    (weight-only with int8 and fp8 weights and bf16 x, act mode): the
    kernel `choose_kernel` gives ("new"), the general mma.sync kernel
    ("old"), the wgmma kernel's other tile, then new and old again; beside the plain versions (M 2048), the bound, the share of the
    tensor-core peak and the library yardsticks (weight-only: F.linear on a
    weight dequantized to bf16 beforehand, which reads 2 bytes a weight
    where the kernel reads 1; act: torch._int_mm and the same epilogue).
    Sums over the 129 launches of a forward, and the host's time per call
    of the wrapper (the wgmma kernel encodes two tensor maps each call).
    Returns the `kernels` line's entries: the chosen kernels' weight-only
    int8 time summed over bucket 8's 129 launches, and the general
    kernel's."""
    import torch.nn.functional as F
    from vitax_torch.ops.dequant_matmul import (KERNELS, _matmul_plain, choose_kernel, dequant_matmul_cuda,
                                                kernel_takes, quantize_activations)
    result = {}
    with torch.inference_mode():
        for big_m in DEQUANT_TIMING_M:
            sums: dict = {}
            fwd_bytes = fwd_ops = 0

            def add(key, v, n):
                sums[key] = sums.get(key, 0.0) + n * v

            for i, (site, k, f, n) in enumerate(DEQUANT_SITES):
                m = big_m if n > 1 else big_m // 256
                x, q, s = dequant_operands(torch, m, k, f, "int8", SEED + 40 + i)
                xb = x.to(torch.bfloat16)
                _, q8, s8 = dequant_operands(torch, m, k, f, "float8_e4m3", SEED + 40 + i)
                wd = (q.float() * s[:, None]).to(torch.bfloat16)
                xq, sx = quantize_activations(xb)
                iters = 20 if m >= 2048 else 100
                calls = {"wo": (lambda kern: dequant_matmul_cuda(xb, q, s, kernel=kern), xb),
                         "fp8": (lambda kern: dequant_matmul_cuda(xb, q8, s8, kernel=kern), xb),
                         "act": (lambda kern: dequant_matmul_cuda(xq, q, s, sx, kernel=kern), xq)}
                b_ms, b_by, nbytes, ops = dequant_bound_ms(m, k, f, act=False)
                a_ms, _, _, _ = dequant_bound_ms(m, k, f, act=True)
                parts = []
                for mode in (("wo", "fp8", "act") if n > 1 else ("wo", "fp8")):   # the head never act-quantizes
                    fn, xin = calls[mode]
                    chosen = choose_kernel(xin, q)
                    others = [kn for kn in KERNELS if kn not in (chosen, "general") and kernel_takes(kn, xin, q)]
                    t = {}
                    for turn, kern in enumerate([chosen, "general", *others, chosen, "general"]):
                        v = time_ms(torch, lambda: fn(kern), iters=iters)
                        t.setdefault(kern, []).append(v)
                    best = {kern: min(v) for kern, v in t.items()}
                    bound = a_ms if mode == "act" else b_ms
                    parts.append(f"{mode}: new {chosen} {t[chosen][0]:.4f} / {t[chosen][1]:.4f}, old general "
                                 f"{t['general'][0]:.4f} / {t['general'][1]:.4f}"
                                 + "".join(f", {kn} {best[kn]:.4f}" for kn in others)
                                 + f" ms; new at {bound / best[chosen] * 100:.1f}% of its bound")
                    modes_here = [mode] + (["act"] if mode == "wo" and n == 1 else [])   # the act forward
                    for md in modes_here:                                          # runs the head weight-only
                        add(f"{md} new", best[chosen], n)
                        for turn in (0, 1):
                            add(f"{md} new {turn}", t[chosen][turn], n)
                            add(f"{md} old {turn}", t["general"][turn], n)
                        for kern in (best if md == mode else ("general", "wgmma_ss_n128", "wgmma_ss_n256")):
                            add(f"{md} k {kern}", best.get(kern, best[chosen]), n)
                lib = time_ms(torch, lambda: F.linear(xb, wd), iters=iters)
                lib_act = (time_ms(torch, lambda: (torch._int_mm(xq, q.t()).float() * sx) * s, iters=iters)
                           if n > 1 else lib)
                line = (f"[4 time] dequant_matmul {site} {m}x{k}x{f}: " + "; ".join(parts)
                        + f"; F.linear bf16 {lib:.4f} ms" + (f", _int_mm + epilogue {lib_act:.4f} ms" if n > 1 else "")
                        + f"; bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP), act "
                        f"{a_ms:.4f} ms")
                if big_m == 2048:
                    plain = time_ms(torch, lambda: _matmul_plain(xb, q, s, None), iters=3)
                    plain_act = time_ms(torch, lambda: _matmul_plain(xq, q, s, sx), iters=3) if n > 1 else plain
                    line += f"; plain {plain:.4f} ms, act {plain_act:.4f} ms"
                    add("plain", plain, n)
                    add("plain_act", plain_act, n)
                say(line + f" [{card}]")
                add("lib", lib, n)
                add("lib_act", lib_act, n)
                add("bound", b_ms, n)
                add("bound_act", a_ms if n > 1 else b_ms, n)
                fwd_bytes, fwd_ops = fwd_bytes + n * nbytes, fwd_ops + n * ops
                if site == "proj" and big_m == 2048:
                    host = {}
                    for kern in (choose_kernel(xb, q), "general"):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        for _ in range(20):
                            dequant_matmul_cuda(xb, q, s, kernel=kern)
                        host[kern] = (time.perf_counter() - t0) / 20 * 1e6
                        torch.cuda.synchronize()
                    say(f"[4 time] dequant_matmul host time per wrapper call (enqueue, no sync): "
                        + ", ".join(f"{kern} {us:.1f} us" for kern, us in host.items())
                        + " (the wgmma kernel encodes two tensor maps a call)")
                del x, q, s, xb, q8, s8, wd, xq
            torch.cuda.empty_cache()
            n_launch = sum(n for *_, n in DEQUANT_SITES)
            per_mode = []
            for mode, bound in (("wo", sums["bound"]), ("fp8", sums["bound"]), ("act", sums["bound_act"])):
                per_kernel = sorted(((key.split(" ", 2)[2], v) for key, v in sums.items()
                                     if key.startswith(mode + " k ")), key=lambda kv: KERNELS[kv[0]])
                per_mode.append(f"{mode}: new {sums[mode + ' new']:.3f} ms (in turns {sums[mode + ' new 0']:.3f}, "
                                f"{sums[mode + ' new 1']:.3f}; {bound / sums[mode + ' new'] * 100:.1f}% of the bound), "
                                f"old (general) in turns {sums[mode + ' old 0']:.3f}, {sums[mode + ' old 1']:.3f} ms; "
                                f"each kernel at every site: "
                                + ", ".join(f"{kern} {v:.3f}" for kern, v in per_kernel) + " ms")
            say(f"[4 time] dequant_matmul at M {big_m}, one forward's {n_launch} launches (head at M {big_m // 256}"
                f"; act runs it weight-only): " + "; ".join(per_mode)
                + f"; F.linear bf16 {sums['lib']:.3f} ms, _int_mm {sums['lib_act']:.3f} ms; bound {sums['bound']:.3f} "
                f"ms, act {sums['bound_act']:.3f} ms"
                + (f"; plain {sums['plain']:.3f} ms, act {sums['plain_act']:.3f} ms" if "plain" in sums else "")
                + f" [{card}]")
            if big_m == 2048:
                # the forward's 129 calls as one piece of work: its bytes and its operations
                t_bytes, t_ops = fwd_bytes / HBM_BYTES_PER_S * 1e3, fwd_ops / PEAK_FLOPS["bfloat16"] * 1e3
                bound = {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
                result = {"dequant_matmul": {"ms": sums["wo new"], "plain_ms": sums["plain"],
                                             "library_ms": sums["lib"], **bound},
                          "dequant_matmul_general": {"ms": sums["wo k general"], "plain_ms": sums["plain"],
                                                     "library_ms": sums["lib"], **bound}}
    return result


def bwd_time_text(times, bound_ms, lib_ms) -> str:
    """`wgmma a / b ms (x% of the bound, y x sdpa), general ...`."""
    return ", ".join(f"{kern} {shown} ms ({bound_ms / best * 100:.1f}% of the bound, {best / lib_ms:.2f}x sdpa)"
                     for kern, (best, shown) in times.items())


def time_attention_train_shape(torch, card):
    """The forward and the backward kernels at the train shape (bf16, dlse
    None as the train path calls it), the backward's wgmma and general
    kernels in turns. library_ms of the backward is PyTorch's
    flash-attention backward op on the outputs of its own flash forward
    (torch.ops.aten._scaled_dot_product_flash_attention_backward). Returns
    the timing of both backward kernels."""
    import torch.nn.functional as F
    from vitax_torch.ops.attention import (attention_bwd_with_lse, attention_fwd_with_lse,
                                           flash_attn_bwd_cuda, flash_attn_fwd_cuda)
    q, k, v = qkv_views(torch, TRAIN_SHAPE, "bfloat16", SEED + 3)
    scale = TRAIN_SHAPE[-1] ** -0.5
    rng = np.random.default_rng(SEED + 4)
    do = torch.from_numpy(rng.standard_normal(TRAIN_SHAPE).astype(np.float32)).to("cuda", torch.bfloat16)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    with torch.inference_mode():
        fwd_times = time_fwd_kernels(torch, q, k, v, scale)
        fwd_plain_ms = time_ms(torch, lambda: attention_fwd_with_lse(q, k, v, scale), iters=10)
        fwd_lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), iters=50)
        o, lse = flash_attn_fwd_cuda(q, k, v, scale)
        sdpa = torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, False, False, scale=scale)

        def library_bwd():
            return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                dot, qt, kt, vt, sdpa[0], sdpa[1], sdpa[2], sdpa[3], sdpa[4], sdpa[5], 0.0, False,
                sdpa[6], sdpa[7], scale=scale)

        call = lambda kern: flash_attn_bwd_cuda(q, k, v, o, lse, do, None, scale, kernel=kern)  # noqa: E731
        kernels = bwd_kernels(q, k, v, o, do)
        times = time_in_turns(torch, call, kernels, 50)
        plain_ms = time_ms(torch, lambda: attention_bwd_with_lse(q, k, v, o, lse, do, None, scale), iters=10)
        library_ms = time_ms(torch, library_bwd, iters=50)
        split = {kern: bwd_kernel_ms(torch, lambda: call(kern)) for kern in kernels}
    fb_ms, fb_by, fb_bytes, fb_flops = attention_bound_ms(TRAIN_SHAPE, "bfloat16")
    say(f"[4 time] flash_attn_fwd {TRAIN_SHAPE} bf16: {fwd_time_text(fwd_times, fb_ms, fb_flops)}; plain "
        f"{fwd_plain_ms:.4f} ms, sdpa {fwd_lib_ms:.4f} ms, bound {fb_ms:.4f} ms ({fb_by}: {fb_bytes / 1e6:.1f} MB, "
        f"{fb_flops / 1e9:.2f} GFLOP) [{card}]")
    bound_ms, bound_by, nbytes, flops = attention_bwd_bound_ms(TRAIN_SHAPE, "bfloat16")
    say(f"[4 time] flash_attn_bwd {TRAIN_SHAPE} bf16, in turns: {bwd_time_text(times, bound_ms, library_ms)}; "
        f"plain {plain_ms:.4f} ms, sdpa flash backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); per launch (torch.profiler) "
        + "; ".join(f"{kern} dK/dV {sp['dkdv']:.4f}, dQ {sp['dq']:.4f}, delta {sp['delta']:.4f} ms"
                    for kern, sp in split.items()) + f" [{card}]")
    return {f"flash_attn_bwd{'' if kern == 'wgmma' else '_general'}": {
        "ms": best, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        for kern, (best, _) in times.items()}


def time_dropout_and_bh(torch, card):
    """CUDA events at the train shape (bf16; dlse None as the train path
    calls the backward): the dropout forward (both forward kernels in turns)
    and backward beside A1 and A2 on the same inputs, the plain versions, PyTorch's flash attention with
    dropout_p (its own Philox mask: a yardstick of time only) and the
    bound; then the BH entries' kernels on (B*H, N, 1, Dh) views of a
    (B*H, N, Dh) copy, with and without dropout, beside their plain
    versions and the same library calls on (1, B*H, N, Dh)."""
    import torch.nn.functional as F
    from vitax_torch.ops.attention import (Dropout, _to_bh, attention_bwd_with_lse, attention_fwd_with_lse,
                                           flash_attn_bwd_cuda, flash_attn_fwd_cuda)
    b, n, h, dh = TRAIN_SHAPE
    scale = dh ** -0.5
    drop = Dropout(DROP_SEED, DROP_RATE)
    q, k, v, do, _ = attention_operands(torch, TRAIN_SHAPE, "bfloat16", SEED + 14)
    layouts = {"4d": (q, k, v, do, tuple(x.transpose(1, 2) for x in (q, k, v, do)), True)}
    bh = [_to_bh(x).contiguous() for x in (q, k, v, do)]
    layouts["bh"] = (*(x[:, :, None] for x in bh), tuple(x[None] for x in bh), False)
    timing = {}
    sdpa_fwd = torch.ops.aten._scaled_dot_product_flash_attention
    sdpa_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    with torch.inference_mode():
        for layout, (q_, k_, v_, do_, lib, first) in layouts.items():
            for d in (None, drop) if layout == "bh" else (drop,):
                rate = 0.0 if d is None else d.rate
                fwd = lambda: flash_attn_fwd_cuda(q_, k_, v_, scale, d)  # noqa: E731
                f_times = time_fwd_kernels(torch, q_, k_, v_, scale, d)
                a1_ms = time_ms(torch, lambda: flash_attn_fwd_cuda(q_, k_, v_, scale), iters=50)
                plain_ms = time_ms(torch, lambda: attention_fwd_with_lse(q_, k_, v_, scale, d, first), iters=3,
                                   warmup=1)
                lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(*lib[:3], dropout_p=rate,
                                                                               scale=scale), iters=50)
                o, lse = fwd()
                o0, lse0 = flash_attn_fwd_cuda(q_, k_, v_, scale)
                sd = sdpa_fwd(*lib[:3], rate, False, False, scale=scale)
                b_times = time_in_turns(
                    torch, lambda kern: flash_attn_bwd_cuda(q_, k_, v_, o, lse, do_, None, scale, d, kernel=kern),
                    bwd_kernels(q_, k_, v_, o, do_), 30)
                a2_ms = time_ms(torch, lambda: flash_attn_bwd_cuda(q_, k_, v_, o0, lse0, do_, None, scale), iters=30)
                b_plain = time_ms(torch, lambda: attention_bwd_with_lse(q_, k_, v_, o, lse, do_, None, scale, d),
                                  iters=3, warmup=1)
                b_lib = time_ms(torch, lambda: sdpa_bwd(lib[3], *lib[:3], sd[0], sd[1], sd[2], sd[3], sd[4], sd[5],
                                                        rate, False, sd[6], sd[7], scale=scale), iters=30)
                fb = (attention_drop_bound_ms(TRAIN_SHAPE, "bfloat16", False) if d is not None
                      else (*attention_bound_ms(TRAIN_SHAPE, "bfloat16"), 0))
                bb = (attention_drop_bound_ms(TRAIN_SHAPE, "bfloat16", True) if d is not None
                      else (*attention_bwd_bound_ms(TRAIN_SHAPE, "bfloat16"), 0))
                base = ("flash_attn" if layout == "4d" else "flash_bh")
                suffix = "" if d is None else "_drop"
                label = f"{base}{suffix} {'(B*H, N, 1, Dh) view' if layout == 'bh' else TRAIN_SHAPE} bf16" + (
                    "" if d is None else f" rate {rate}")
                for kind, (k_ms, shown), ref_ms, p_ms, l_ms, bound in (
                        ("fwd", f_times["wgmma"], a1_ms, plain_ms, lib_ms, fb),
                        ("bwd", b_times["wgmma"], a2_ms, b_plain, b_lib, bb)):
                    shown = (fwd_time_text(f_times, bound[0], bound[3]) if kind == "fwd"
                             else "in turns: " + bwd_time_text(b_times, bound[0], l_ms))
                    say(f"[4 time] {label} {kind}: {shown}, rate-0 kernel on the same inputs {ref_ms:.4f} ms, plain "
                        f"{p_ms:.4f} ms, sdpa flash (dropout_p {rate}) {l_ms:.4f} ms, bound {bound[0]:.4f} ms "
                        f"({bound[1]}: {bound[2] / 1e6:.1f} MB, {bound[3] / 1e9:.2f} GFLOP"
                        + (f", {bound[4] / 1e9:.3f} G INT32 ops of the hash" if d is not None else "") + f") [{card}]")
                    name = ("flash_attn_" if layout == "4d" else "flash_bh_") + kind + suffix
                    timing[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                    "bound_ms": bound[0], "bound_by": bound[1]}
                del o, lse, o0, lse0, sd
    del q, k, v, do, bh, layouts
    torch.cuda.empty_cache()
    return timing


def long_bound_ms(shape, dtype: str, tensors: int, rows: int, flop_units: int, dropout: bool):
    """Least time of one streaming kernel or call on (B, N, H, Dh):
    `tensors` (B, N, H, Dh) tensors each read or written once and `rows`
    (B, H, N) float32 rows (lse, delta), over HBM bandwidth; flop_units B H
    N^2 Dh FLOP over the tensor-core peak; under dropout also the hash, once
    an element, over the INT32 rate. Returns (ms, bound_by, bytes, FLOP,
    INT32 operations)."""
    b, n, h, dh = shape
    elem = 2 if dtype == "bfloat16" else 4
    nbytes = tensors * b * n * h * dh * elem + rows * b * h * n * 4
    flops = flop_units * b * h * n * n * dh
    int_ops = HASH_OPS_PER_ELEMENT * b * h * n * n if dropout else 0
    times = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": max(flops / PEAK_FLOPS[dtype],
                                                                  int_ops / INT32_OPS_PER_S)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by, nbytes, flops, int_ops


# (tensors, f32 rows, FLOP units) of each streaming piece: the forward (q,
# k, v read, o written; lse; QK^T and PV), the dK/dV kernel (q, k, v, dO
# read, dk, dv written; lse and delta; S, dP, dV, dK), the dQ kernel (q, k,
# v, dO read, dq written; S, dP, dQ) and the backward call (q, k, v, o, dO
# read, dq, dk, dv written; lse; the five products once).
LONG_PIECES = {"fwd": (4, 1, 4), "dkdv": (6, 2, 8), "dq": (5, 2, 6), "bwd": (8, 1, 10)}
STREAM_TIMING_NAMES = {"fwd": "flash_attn_fwd_stream", "bwd": "flash_attn_bwd_stream",
                       "dkdv": "flash_attn_bwd_stream_dkdv", "dq": "flash_attn_bwd_stream_dq"}
BWD_KERNEL_NAMES = {"dkdv": "bwd_dkdv", "dq": "bwd_dq", "delta": "delta_kernel"}
FWD_KERNEL_NAMES = {"wgmma": "flash_attn_fwd_wgmma_kernel", "general": "flash_attn_fwd_(bf16|f32)_kernel"}


def profiled_ms(torch, fn, patterns, calls: int):
    """Device ms per launch of the kernels whose names match each of
    `patterns` ({piece: regex}), from torch.profiler over `calls` calls of
    `fn` (vitax_torch.tools.attn_fwd_ab.profiled_ms). Unlike CUDA events
    around back-to-back calls, this is the kernels' own time where the
    wrapper's host time exceeds it."""
    from vitax_torch.tools.attn_fwd_ab import profiled_ms as device_ms
    for _ in range(3):                  # a profiler cycle can come back without a kernel's events: profile again
        out = device_ms(fn, patterns, calls)
        missing = [piece for piece, ms in out.items() if not ms > 0]
        if not missing:
            return out
    fail(f"torch.profiler recorded no device time for the {missing[0]} kernel in three tries")


def bwd_kernel_ms(torch, bwd, calls: int = 3):
    """Device ms per launch of each of the backward call's three kernels
    (one launch each a call; one kernel family at a time)."""
    return profiled_ms(torch, bwd, BWD_KERNEL_NAMES, calls)


def time_streaming(torch, card):
    """Phase 4L: the streaming path's kernels at the ViT-L shape, N 4096
    and 9216, bf16, offsets 0 as the model calls them, rate 0 and 0.1
    (CUDA events): the forward (its wgmma and general kernels in turns) and
    the backward call (dlse None; its wgmma and general kernels in turns),
    each backward's dK/dV and dQ kernels and the delta pre-pass apart
    (torch.profiler),
    PyTorch's flash attention (F.scaled_dot_product_attention and its flash
    backward on (B, H, N, Dh), dropout_p as the row's rate: its own Philox
    mask, a yardstick of time only), the bounds, and at N 4096 only the
    plain versions at 64 x 64 tiles, timed once. Returns the `kernels`
    line's timing of A4, A5a and A5b (N 4096, rate 0), and of the general
    backward."""
    import torch.nn.functional as F
    from vitax_torch.ops.attention import Dropout, _to_bh, flash_attn_bwd_cuda, flash_attn_fwd_cuda
    from vitax_torch.ops.flash_blocked import streaming_dkv, streaming_dq, streaming_fwd_with_lse
    sdpa_fwd = torch.ops.aten._scaled_dot_product_flash_attention
    sdpa_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    timing = {}
    for n in LONG_TIME_NS:
        shape = (LONG_SHAPE[0], n, *LONG_SHAPE[2:])
        b, _, h, dh = shape
        scale = dh ** -0.5
        q, k, v, do, _ = attention_operands(torch, shape, "bfloat16", SEED + 30)
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        with torch.inference_mode():
            for rate in (0.0, DROP_RATE):
                d = Dropout(DROP_SEED, rate) if rate else None
                fwd = lambda: flash_attn_fwd_cuda(q, k, v, scale, d)  # noqa: E731
                f_times = time_fwd_kernels(torch, q, k, v, scale, d, iters=20)
                f_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, dropout_p=rate,
                                                                              scale=scale), iters=20)
                o, lse = fwd()
                call = lambda kern: flash_attn_bwd_cuda(q, k, v, o, lse, do, None, scale, d, kernel=kern)  # noqa: E731
                kernels = bwd_kernels(q, k, v, o, do)
                b_times = time_in_turns(torch, call, kernels, 10)
                sd = sdpa_fwd(qt, kt, vt, rate, False, False, scale=scale)
                b_lib = time_ms(torch, lambda: sdpa_bwd(dot, qt, kt, vt, sd[0], sd[1], sd[2], sd[3], sd[4], sd[5],
                                                        rate, False, sd[6], sd[7], scale=scale), iters=10)
                split = {kern: bwd_kernel_ms(torch, lambda: call(kern)) for kern in kernels}
                plain = {}
                if n == LONG_TIME_NS[0]:
                    bh = [_to_bh(x) for x in (q, k, v)]
                    bargs = (*bh, _to_bh(o), lse.reshape(b * h, n), _to_bh(do), None, scale, LONG_TILE, LONG_TILE, d)
                    plain["fwd"] = time_ms(torch, lambda: streaming_fwd_with_lse(*bh, scale, LONG_TILE, LONG_TILE, d),
                                           iters=1, warmup=1)
                    plain["dkdv"] = time_ms(torch, lambda: streaming_dkv(*bargs), iters=1, warmup=1)
                    plain["dq"] = time_ms(torch, lambda: streaming_dq(*bargs), iters=1, warmup=1)
                    plain["bwd"] = plain["dkdv"] + plain["dq"]
                    del bh, bargs
                got = {"fwd": (f_times["wgmma"][0], None, f_lib), "bwd": (b_times["wgmma"][0], None, b_lib),
                       "dkdv": (split["wgmma"]["dkdv"], None, b_lib), "dq": (split["wgmma"]["dq"], None, b_lib)}
                for piece, (ms, _, lib) in got.items():
                    bound = long_bound_ms(shape, "bfloat16", *LONG_PIECES[piece], d is not None)
                    if piece == "fwd":
                        shown = fwd_time_text(f_times, bound[0], bound[3])
                    elif piece == "bwd":
                        shown = "in turns: " + bwd_time_text(b_times, bound[0], lib) + " (delta pre-pass " + ", ".join(
                            f"{kern} {sp['delta']:.4f}" for kern, sp in split.items()) + " ms besides)"
                    else:
                        shown = ", ".join(f"{kern} {sp[piece]:.4f} ms" for kern, sp in split.items())
                    say(f"[4L time] streaming {piece} {shape} bf16 rate {rate}: {shown}"
                        + (f", plain (64 x 64 tiles, timed once) {plain[piece]:.1f} ms" if plain else "")
                        + f", sdpa flash {'backward, whole call' if piece != 'fwd' else 'forward'} (dropout_p "
                        f"{rate}) {lib:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}: {bound[2] / 1e6:.1f} MB, "
                        f"{bound[3] / 1e12:.3f} TFLOP" + (f", {bound[4] / 1e9:.2f} G INT32 ops of the hash"
                                                          if d is not None else "")
                        + f"; the wgmma kernels' tensor-core share "
                        f"{bound[3] / PEAK_FLOPS['bfloat16'] * 1e3 / ms * 100:.1f}%) [{card}]")
                    if n == LONG_TIME_NS[0] and d is None:
                        # no PyTorch call computes dK/dV or dQ alone: SDPA's
                        # backward stands beside the whole call only
                        timing[STREAM_TIMING_NAMES[piece]] = {
                            "ms": ms, "plain_ms": plain[piece], "library_ms": None if piece in ("dkdv", "dq") else lib,
                            "bound_ms": bound[0], "bound_by": bound[1]}
                        if piece == "bwd":
                            timing["flash_attn_bwd_stream_general"] = dict(timing["flash_attn_bwd_stream"],
                                                                           ms=b_times["general"][0])
                del o, lse, sd
        del q, k, v, do, qt, kt, vt, dot
        torch.cuda.empty_cache()
    return timing

def phase_model_check(torch):
    from vitax_torch.config import Config
    from vitax_torch.models.vit import build_model
    from vitax_torch.ops.attention import make_attention_impl
    from vitax_torch.train.step import prepare_images
    cfg = Config(num_blocks=2, seed=SEED).validate()
    dense_cfg = Config(num_blocks=2, seed=SEED, use_flash_attention=False).validate()
    model = build_model(cfg, "cuda", attention_impl=make_attention_impl(cfg, "cuda"))
    dense = build_model(dense_cfg, "cuda", attention_impl=make_attention_impl(dense_cfg, "cuda"), init=False)
    dense.load_state_dict(model.state_dict(), assign=True)     # the same tensors
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(rng.integers(0, 256, (8, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)).cuda(0)
    with torch.inference_mode():
        x = prepare_images(images)
        got, want = model(x).float(), dense(x).float()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    ok = bool(torch.isfinite(got).all()) and rel <= MODEL_REL_TOL
    say(f"[5 model] 10B width, depth 2, bf16: max|dlogits|/max|logits| {rel:.3e} (<= {MODEL_REL_TOL}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("model with the kernel disagrees with the dense model")
    del got, want

    # loss and gradients: the kernels (forward, and backward through the
    # autograd Function, under per-block recompute) against dense autograd
    from vitax_torch.ops import _build
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, 8)).cuda(0)
    x = prepare_images(images)             # not an inference tensor: autograd saves it
    losses, grads = [], []
    before = dict(_build.LAUNCHES)
    for m in (model, dense):
        m.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(m(x).float(), labels)
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad for n, p in m.named_parameters()})
    bwd_calls = {k: _build.LAUNCHES[k] - before[k] for k in ("flash_attn_bwd", *_build.FLASH_BWD_KERNELS)}
    if bwd_calls != {"flash_attn_bwd": cfg.num_blocks, "flash_attn_bwd_wgmma": cfg.num_blocks,
                     "flash_attn_bwd_general": 0}:
        fail(f"the model's backward did not go through flash_attn_bwd's wgmma kernels once per block: {bwd_calls}")
    groups = grad_groups(torch, grads[0], grads[1])
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    worst = max(groups.values())
    ok = loss_rel <= MODEL_LOSS_REL_TOL and worst <= MODEL_GRAD_REL_TOL
    say(f"[5 model] loss kernels {losses[0]:.6f} dense {losses[1]:.6f} (rel {loss_rel:.2e} <= {MODEL_LOSS_REL_TOL}); "
        f"grads max|dg|/max|g| per leaf group (<= {MODEL_GRAD_REL_TOL}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(groups.items())) + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("model gradients with the kernels disagree with the dense model's")
    del dense, x, grads
    check_dropout_model(torch, model, images, labels)
    check_quant_model(torch, model, images)
    del model
    torch.cuda.empty_cache()


def grad_groups(torch, grads_k, grads_d):
    """max |dg| / max |g| per leaf group (block leaves pooled over blocks)."""
    groups = {}
    for name, g_k in grads_k.items():
        g_d = grads_d[name]
        key = "blocks." + name.split(".", 2)[2] if name.startswith("blocks.") else name
        r = ((g_k - g_d).abs().max() / g_d.abs().max().clamp_min(1e-30)).item()
        groups[key] = max(groups.get(key, 0.0), r if bool(torch.isfinite(g_k).all()) else float("inf"))
    return groups


def check_dropout_model(torch, model, images, labels):
    """The depth-2 model under att_dropout and mlp_dropout at one set of
    seeds: the dropout kernels (forward, recompute under grad_ckpt,
    backward) against the dense path with the same counter-hash mask
    (make_dense_dropout) and the same proj/mlp masks, on the same weights:
    the loss and every parameter's gradient at the rate-0 arm's bars, and
    the launches (two forwards and one backward a block)."""
    from vitax_torch.config import Config
    from vitax_torch.models.vit import build_model
    from vitax_torch.ops import _build
    from vitax_torch.ops.attention import make_attention_impl
    from vitax_torch.train.step import dropout_seeds, prepare_images
    x = prepare_images(images)
    losses, grads, launched = [], [], []
    for flash in (True, False):
        cfg = Config(num_blocks=2, seed=SEED, att_dropout=DROP_RATE, mlp_dropout=DROP_RATE,
                     use_flash_attention=flash).validate()
        m = build_model(cfg, "cuda", attention_impl=make_attention_impl(cfg, "cuda"), init=False)
        m.load_state_dict(model.state_dict(), assign=True)      # the same tensors
        m.zero_grad(set_to_none=True)
        before = dict(_build.LAUNCHES)
        loss = torch.nn.functional.cross_entropy(m(x, dropout_seeds(cfg, 0, 0)).float(), labels)
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad for n, p in m.named_parameters()})
        launched.append({k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]})
        del m
    want = {"flash_attn_fwd_drop": 2 * cfg.num_blocks, "flash_attn_bwd_drop": cfg.num_blocks,
            "flash_attn_fwd_wgmma": 2 * cfg.num_blocks, "flash_attn_bwd_wgmma": cfg.num_blocks}
    groups = grad_groups(torch, grads[0], grads[1])
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    worst = max(groups.values())
    ok = loss_rel <= MODEL_LOSS_REL_TOL and worst <= MODEL_GRAD_REL_TOL and launched == [want, {}]
    say(f"[5 model] dropout att {DROP_RATE} mlp {DROP_RATE}: loss kernels {losses[0]:.6f} dense {losses[1]:.6f} "
        f"(rel {loss_rel:.2e} <= {MODEL_LOSS_REL_TOL}); grads max|dg|/max|g| per leaf group (<= "
        f"{MODEL_GRAD_REL_TOL}): " + ", ".join(f"{k} {v:.2e}" for k, v in sorted(groups.items()))
        + f"; launches {launched[0]} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the model under dropout with the kernels disagrees with the dense path's")
    del grads, x


def check_quant_model(torch, model, images):
    """The depth-2 model's weights quantized on the card (int8 and fp8),
    run with the kernel at every Dense site against the same quantized
    weights through the plain versions (called explicitly here, and only
    here), weight-only and with int8 activations: the logits bar, and 4
    launches per block plus the head."""
    from vitax_torch.config import Config
    from vitax_torch.models.vit import Quant, build_model
    from vitax_torch.ops import _build
    from vitax_torch.ops.attention import make_attention_impl
    from vitax_torch.ops.dequant_matmul import dequant_matmul_plain, make_quant_matmul
    from vitax_torch.serve.quant import quantize_params_for_serve
    from vitax_torch.train.step import prepare_images
    with torch.inference_mode():
        x = prepare_images(images)
        for dtype, act in (("int8", "off"), ("int8", "int8"), ("float8_e4m3", "off")):
            cfg = Config(num_blocks=2, seed=SEED, serve_quant_dtype=dtype, serve_act_quant=act).validate()
            qstate = quantize_params_for_serve(dict(model.state_dict()), dtype)

            def plain_matmul(x, w, s, act=True, act_mode=act == "int8"):
                return dequant_matmul_plain(x, w, s, act=act_mode and act)

            logits, launched = [], []
            for qm in (make_quant_matmul(cfg), plain_matmul):
                m = build_model(cfg, "cuda", attention_impl=make_attention_impl(cfg, "cuda"), init=False,
                                quant=Quant(dtype, qm))
                m.load_state_dict(qstate, strict=True, assign=True)
                before = _build.LAUNCHES["dequant_matmul"]
                logits.append(m(x).float())
                launched.append(_build.LAUNCHES["dequant_matmul"] - before)
                del m
            got, want = logits
            rel = ((got - want).abs().max() / want.abs().max()).item()
            bar = QUANT_MODEL_TOL[act]
            ok = bool(torch.isfinite(got).all()) and rel <= bar and launched == [4 * cfg.num_blocks + 1, 0]
            say(f"[5 model] 10B width, depth 2, {dtype} weights, activations {act}: kernel vs plain versions "
                f"max|dlogits|/max|logits| {rel:.3e} (<= {bar}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"the quantized model with the kernel disagrees with its plain versions ({dtype}, act {act})")
            del qstate, logits, got, want


def ppm_bytes(rng, size: int = 256) -> bytes:
    arr = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    return f"P6\n{size} {size}\n255\n".encode() + arr.tobytes()


def http(url: str, body: bytes = None, ctype: str = "image/x-portable-pixmap") -> dict:
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype} if body else {})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.load(resp)


def check_answer(ans: dict, k: int, num_classes: int) -> None:
    classes, probs = ans["classes"], ans["probs"]
    if len(classes) != k or len(probs) != k:
        fail(f"answer has {len(classes)} classes / {len(probs)} probs, expected {k}: {ans}")
    if not all(0 <= c < num_classes for c in classes) or len(set(classes)) != k:
        fail(f"class ids out of range or repeated: {classes}")
    if not all(0.0 < p <= 1.0 for p in probs) or any(a < b for a, b in zip(probs, probs[1:])):
        fail(f"probs not descending in (0, 1]: {probs}")


# First match wins: the dropout instantiations (template flag `true`) before
# the rate-0 ones; delta_kernel serves both backwards.
KERNEL_GROUPS = (("flash_attn_fwd_drop", r"flash_attn_fwd_\w+_kernel<\d+, true>"),
                 ("flash_attn_fwd", r"flash_attn_fwd"),
                 ("flash_attn_bwd_drop", r"(bwd_dkdv|bwd_dq)_\w+_kernel<\d+, true>"),
                 ("flash_attn_bwd", r"bwd_dkdv|bwd_dq|delta_kernel"),
                 ("fused_adamw", r"fused_adamw"), ("dequant_matmul_wgmma", r"dequant_matmul_wgmma"),
                 ("dequant_matmul_general", r"dequant_matmul"),
                 ("gemm", r"gemm|xmma|nvjet|cutlass|sm90_"))


def profile_device(torch, fn, label: str, card: str, phase: str, top: int = 8, kernel_groups=None):
    """Where one call of `fn` spends device time (torch.profiler): wall,
    device busy and idle, time by kernel group (KERNEL_GROUPS unless
    given), the top kernels. Returns (wall ms, device busy ms)."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # a record_function range around device work (FSDP2 marks its steps so)
    # shows as a device event too: it is no kernel, and would count twice
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False) and not e.key.startswith("FSDP::")]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if not kernels or busy_ms <= 0:
        fail(f"torch.profiler recorded no device time for {label}")
    kernel_groups = kernel_groups or KERNEL_GROUPS
    groups = {name: 0.0 for name, _ in kernel_groups}
    groups["other"] = 0.0
    for name, ms, _ in kernels:
        key = next((g for g, pat in kernel_groups if re.search(pat, name)), "other")
        groups[key] += ms
    say(f"[{phase} profile] {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"(idle {max(0.0, 1 - busy_ms / wall_ms) * 100:.1f}%); "
        + ", ".join(f"{k} {v:.2f} ms ({v / busy_ms * 100:.1f}%)" for k, v in groups.items() if v > 0)
        + f" [{card}]")
    for name, ms, count in sorted(kernels, key=lambda k: -k[1])[:top]:
        say(f"[{phase} profile]   {ms:8.3f} ms  x{count:<4d} {name[:110]}")
    return wall_ms, busy_ms


def profile_forward(torch, engine, cfg, card):
    """Where one bucket-8 forward's device time goes, after the main path's
    counts were read."""
    x = np.zeros((8, cfg.image_size, cfg.image_size, 3), np.uint8)
    profile_device(torch, lambda: engine.predict(x), "bucket-8 forward", card, "6")


def serve_over_http(torch, engine, cfg, label: str, extra=None):
    """Put `engine` behind the HTTP server and send it the main path's
    traffic: 32 /predict requests from 8 threads, then one /predict_batch of
    8 images, with every kernel's launch count read around exactly that
    traffic. Checks the answers and the server's counts; then runs
    `extra(url, ctx)`, if given, before the server stops. Returns (launches,
    /metrics, engine batches, client latencies, wall seconds)."""
    from vitax_torch.ops import _build
    from vitax_torch.serve import start_server, stop_server
    httpd, ctx = start_server(cfg, engine, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    rng = np.random.default_rng(SEED)
    singles = [ppm_bytes(rng) for _ in range(32)]
    batch = [ppm_bytes(rng) for _ in range(8)]
    answers, latencies, errors = [None] * 32, [0.0] * 32, []

    def client(worker: int) -> None:
        for i in range(worker, 32, 8):
            t = time.perf_counter()
            try:
                answers[i] = http(url + "/predict", singles[i])
            except Exception as e:  # noqa: BLE001 - reported below, the run fails
                errors.append(f"request {i}: {e!r}")
            latencies[i] = time.perf_counter() - t

    try:
        _build.reset_launches()
        t_start = time.perf_counter()
        threads = [threading.Thread(target=client, args=(w,)) for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wire = {"items": [base64.b64encode(b).decode() for b in batch],
                "content_types": ["image/x-portable-pixmap"] * 8}
        batch_reply = http(url + "/predict_batch", json.dumps(wire).encode(), "application/json")
        wall = time.perf_counter() - t_start
        launches = dict(_build.LAUNCHES)
        if errors or any(t.is_alive() for t in threads):
            fail(f"{label}: requests failed: {errors[:4]}")
        health = http(url + "/healthz")
        metrics = http(url + "/metrics")
        if extra is not None:
            extra(url, ctx)
    finally:
        stop_server(httpd, ctx)

    for ans in answers:
        check_answer(ans, cfg.serve_topk, cfg.num_classes)
    items = batch_reply["results"]
    if len(items) != 8 or any(it["status"] != 200 for it in items):
        fail(f"{label}: /predict_batch items failed: {items}")
    batch_answers = [json.loads(it["body"]) for it in items]
    for ans in batch_answers:
        check_answer(ans, cfg.serve_topk, cfg.num_classes)
    if not health["ready"]:
        fail(f"{label}: /healthz not ready: {health}")
    if metrics["requests_total"] != 40 or metrics["errors_total"] != 0:
        fail(f"{label}: /metrics counts {metrics['requests_total']} requests, {metrics['errors_total']} errors; "
             f"expected 40 and 0")
    batches = metrics["batches_flushed"]
    if launches["flash_attn_fwd"] != cfg.num_blocks * batches:
        fail(f"{label}: flash_attn_fwd launched {launches['flash_attn_fwd']} times for {batches} engine batches; "
             f"expected {cfg.num_blocks} per batch")
    if (launches["flash_attn_fwd_wgmma"], launches["flash_attn_fwd_general"]) != (launches["flash_attn_fwd"], 0):
        fail(f"{label}: of {launches['flash_attn_fwd']} attention forwards, {launches['flash_attn_fwd_wgmma']} took "
             f"the wgmma kernel and {launches['flash_attn_fwd_general']} the general one; every one must take wgmma")
    return launches, metrics, batches, np.sort(np.asarray(latencies)), wall


def traffic_line(metrics, batches, lat, wall) -> str:
    return (f"40 requests in {wall:.3f}s = {40 / wall:.2f} images/s; /predict latency p50 "
            f"{np.percentile(lat, 50) * 1e3:.1f} ms p95 {np.percentile(lat, 95) * 1e3:.1f} ms (client), "
            f"server p50 {metrics['latency_s_p50'] * 1e3:.1f} ms p95 {metrics['latency_s_p95'] * 1e3:.1f} ms; "
            f"{batches} engine batches, occupancy {metrics['batch_occupancy_mean']}")


# Phase 7v: the port's program rules (vitax_torch.analysis.rules, vitax's
# VTX-R001-R010) over the card's own programs, on objects other phases built:
# after phase 6's traffic, R006 on its f32 engine; after each of 6q's
# engines' gate, R006, R007 and R009 on it (129 kernel C launches a forward:
# 4 Dense sites a block and the head); inside phase 7, after its run, one
# more non-log step of its 10B-width, depth-8 state under the rules the
# `fused` arm applies (R001 under torch.cuda.set_sync_debug_mode("error"),
# R002, R008), whose launch deltas must be one step's (1 B, 8 A2, 16 A1
# under none_saveable); then that step wrapped to read its loss back
# (.item()), which R001 must catch. Each arm prints its rule ids, finding
# count and seconds; an ERROR finding fails the run.
V_TRAIN_RULES = ("VTX-R001", "VTX-R002", "VTX-R008")
V_SERVE_RULES = ("VTX-R006", "VTX-R007", "VTX-R009")
V_LOG = []                              # (arm, rule ids, findings, seconds) of phase 7v, in order


def vet(program, wanted, label: str, card: str) -> list:
    """Run the rules of `wanted` that apply to `program`, print the arm's
    line, fail on any ERROR finding. Returns the findings."""
    from vitax_torch.analysis.rules import rules_for
    t0 = time.perf_counter()
    ran, findings = [], []
    for r in rules_for(program):
        if r.id in wanted:
            ran.append(r.id)
            findings.extend(r.check(program, program.config))
    seconds = time.perf_counter() - t0
    V_LOG.append((label, ran, len(findings), seconds))
    say(f"[7v {label}] rules {', '.join(ran) or 'none'}: {len(findings)} finding(s) in {seconds:.2f}s [{card}]")
    for f in findings:
        say(f"[7v {label}]   {f.rule} [{f.severity}] {f.message}")
    if any(f.severity == "ERROR" for f in findings):
        fail(f"7v {label}: {len(findings)} finding(s) of the program rules")
    return findings


def rules_serve(engine, cfg, arm: str, card: str) -> None:
    """Phase 7v on one warmed engine: the serve rules that apply. On a
    quantized engine R009 holds kernel C's launches a forward to its
    quantized Dense sites, which must be 4 a block and the head."""
    from vitax_torch.analysis.rules import quant_dense_sites, serve_program
    vet(serve_program(engine, cfg, arm), V_SERVE_RULES, arm, card)
    if cfg.serve_quant_dtype:
        sites = quant_dense_sites(engine.model)
        say(f"[7v {arm}] {sites} quantized Dense sites, so {sites} kernel C launches a forward under VTX-R009 "
            f"[{card}]")
        if sites != 4 * cfg.num_blocks + 1:
            fail(f"7v {arm}: {sites} quantized Dense sites at depth {cfg.num_blocks}; want "
                 f"{4 * cfg.num_blocks + 1}")


def rules_train(  # vtx: ignore[VTX103] train_program synchronizes the card around the recorded step
        torch, card: str, cfg, state) -> None:
    """Phase 7v on phase 7's trained state: one warm step, then one more
    non-log step as the program (R001, R002, R008), its launch deltas held
    to one step's; then the seeded violation, which R001 must catch."""
    from vitax_torch.analysis.rules import NO_HOST_TRANSFER, seeded_batch, train_program
    from vitax_torch.train.state import build_optimizer
    from vitax_torch.train.step import make_train_step
    t0 = time.perf_counter()
    optimizer, _ = build_optimizer(cfg, 100)
    step = make_train_step(cfg, optimizer, "cuda")
    batch = seeded_batch(cfg, cfg.batch_size, "cuda", seed=SEED)
    state.model.train()
    step(state, batch)
    program = train_program(cfg, state, step, batch, arm="train", device="cuda", optimizer=optimizer)
    t_step = time.perf_counter() - t0
    deltas = program.launches.launches
    want = {k: v for k, v in step_launches(cfg).items() if v}
    say(f"[7v train] one non-log step of phase 7's state (width {cfg.embed_dim}, depth {cfg.num_blocks}, batch "
        f"{cfg.batch_size}) recorded in {t_step:.2f}s with its warm step: {len(program.ops.rows)} aten ops, "
        f"launch deltas {deltas} (expected {want}), dispatcher calls {program.launches.calls}, "
        f"memory_allocated {program.memory_before / 1e9:.3f} -> {program.memory_after / 1e9:.3f} GB [{card}]")
    if deltas != want:
        fail(f"7v train: the step launched {deltas}; one step launches {want}")
    vet(program, V_TRAIN_RULES, "train", card)

    def with_item(state, batch):
        state, metrics = step(state, batch)
        metrics["loss"].item()
        return state, metrics

    t0 = time.perf_counter()
    seeded = train_program(cfg, state, with_item, batch, arm="train+item", device="cuda", optimizer=optimizer)
    caught = NO_HOST_TRANSFER.check(seeded, cfg)
    V_LOG.append(("train+item (seeded)", [NO_HOST_TRANSFER.id], len(caught), time.perf_counter() - t0))
    say(f"[7v train+item] the step wrapped to read its loss back: {NO_HOST_TRANSFER.id} gave {len(caught)} "
        f"finding(s): " + "; ".join(f.message for f in caught) + f" [{card}]")
    if not caught:
        fail("7v: the seeded host sync (.item() on the loss) went through VTX-R001 unseen")
    say(f"[7v] {len(V_LOG)} arms, {sum(n for _, _, n, _ in V_LOG[:-1])} findings outside the seeded one, "
        f"{sum(s for *_, s in V_LOG) + t_step:.2f}s in all: "
        + "; ".join(f"{a} {'/'.join(r)} {n} {s:.2f}s" for a, r, n, s in V_LOG) + f" [{card}]")


def phase_main_path(torch, card):
    """The full 10B engine (f32 params, bf16 compute) over HTTP. Returns
    (launches, the engine), kept for the quantized phase."""
    from vitax_torch.config import Config
    from vitax_torch.models.vit import build_model, count_params
    from vitax_torch.ops.attention import make_attention_impl
    from vitax_torch.serve import InferenceEngine

    cfg = Config(seed=SEED, serve_port=0).validate()      # the 10B flagship, bf16 compute
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda", attention_impl=make_attention_impl(cfg, "cuda"))
    engine = InferenceEngine(cfg, model, "cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = count_params(model)
    warm = engine.warmup()
    say(f"[6 main] 10B engine: {n_params:,} params ({engine.weights_dtype}, "
        f"{engine.param_bytes() / 1e9:.1f} GB) depth {cfg.num_blocks} width {cfg.embed_dim} "
        f"heads {cfg.num_heads} patch {cfg.patch_size} image {cfg.image_size}, init {t_init:.1f}s, "
        f"warmup " + ", ".join(f"{b}:{s:.2f}s" for b, s in warm.items()))
    jpeg = {}
    launches, metrics, batches, lat, wall = serve_over_http(
        torch, engine, cfg, "6 main", extra=lambda url, ctx: jpeg.update(serve_jpegs(url, ctx, cfg)))
    say(f"[6 main] {traffic_line(metrics, batches, lat, wall)}; "
        f"flash_attn_fwd launches {launches['flash_attn_fwd']} (wgmma {launches['flash_attn_fwd_wgmma']}, general "
        f"{launches['flash_attn_fwd_general']}); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")
    say(f"[6 jpeg] {SERVE_JPEGS} JPEG /predict bodies ({jpeg['sizes']}) after that traffic, one a thread: decoded "
        f"{jpeg['decoded']} ({jpeg['why']}); latency p50 {np.percentile(jpeg['lat'], 50) * 1e3:.1f} ms max "
        f"{jpeg['lat'].max() * 1e3:.1f} ms (client) in {jpeg['wall']:.3f}s [{card}]")
    profile_forward(torch, engine, cfg, card)
    rules_serve(engine, cfg, "serve", card)
    return launches, engine


def phase_quant_serve(torch, card, engine_f32):
    """Quantized serving: phase 6's full-width, full-depth 10B model
    quantized on the card to int8 and to fp8, three engines (int8
    weight-only, int8 with int8 activations, fp8 weight-only) over HTTP,
    each with its launch counts, footprint, profile, latency and accuracy
    gate against the full-precision engine. Returns (the launches of each
    kernel summed over the three engines' traffic, {"int8": the int8 state
    on the card} for phase 6f, the int8 weight-only engine's client
    latencies and wall seconds)."""
    from vitax_torch.config import Config
    from vitax_torch.serve import InferenceEngine
    from vitax_torch.serve.quant import quantize_params_for_serve, run_quant_gate

    rng = np.random.default_rng(SEED + 6)
    cfg0 = engine_f32.cfg
    cell = cfg0.image_size // 4
    images = np.repeat(np.repeat(rng.integers(0, 256, (GATE_IMAGES, 4, 4, 3), dtype=np.uint8), cell, axis=1),
                       cell, axis=2)
    labels = np.concatenate([engine_f32.predict(images[i:i + 8])[0][:, 0] for i in range(0, GATE_IMAGES, 8)])
    counts = np.bincount(labels)
    say(f"[6q gate] labels: the full-precision engine's top-1 on {GATE_IMAGES} seeded colour-field images: "
        f"{int((counts > 0).sum())} distinct classes, the most common {counts.max() / GATE_IMAGES:.4f} of them")
    states = {}
    for dtype in ("int8", "float8_e4m3"):
        t0 = time.perf_counter()
        states[dtype] = quantize_params_for_serve(dict(engine_f32.model.state_dict()), dtype)
        torch.cuda.synchronize()
        say(f"[6q quant] {dtype}: quantized the 10B model on the card in {time.perf_counter() - t0:.2f}s; "
            f"memory_allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB (the f32 engine kept for the gate)")
    per_forward = 4 * cfg0.num_blocks + 1
    total = {}
    for dtype, act in (("int8", "off"), ("int8", "int8"), ("float8_e4m3", "off")):
        label = f"6q {dtype}" + (" act int8" if act != "off" else "")
        cfg = Config(seed=SEED, serve_port=0, serve_quant_dtype=dtype, serve_act_quant=act).validate()
        torch.cuda.reset_peak_memory_stats()
        engine = InferenceEngine.from_state(cfg, states[dtype], "cuda", dtype)
        warm = engine.warmup()
        say(f"[{label}] engine: weights_dtype {engine.weights_dtype}, act_quant {engine.act_quant}, "
            f"fused_dequant {engine.fused_dequant}, param_bytes {engine.param_bytes():,} "
            f"({engine.param_bytes() / 1e9:.2f} GB; f32 engine {engine_f32.param_bytes() / 1e9:.2f} GB), "
            f"warmup " + ", ".join(f"{b}:{s:.2f}s" for b, s in warm.items()))
        launches, metrics, batches, lat, wall = serve_over_http(torch, engine, cfg, label)
        if launches["dequant_matmul"] != per_forward * batches:
            fail(f"{label}: dequant_matmul launched {launches['dequant_matmul']} times for {batches} engine "
                 f"batches; expected {per_forward} per batch")
        # every block site (K 5120 or 20480, M 256-2048) takes the wgmma
        # kernel; the head (M 1-8) takes what choose_kernel gives it
        wgmma, general = launches["dequant_matmul_wgmma"], launches["dequant_matmul_general"]
        if wgmma + general != launches["dequant_matmul"] or wgmma < (per_forward - 1) * batches:
            fail(f"{label}: {wgmma} wgmma and {general} general launches for {batches} engine batches; every one "
                 f"of the {(per_forward - 1) * batches} block-site launches must take the wgmma kernel")
        if metrics["weights_dtype"] != dtype or metrics["act_quant"] != act or metrics["fused_dequant"] is not True:
            fail(f"{label}: /metrics reports {metrics['weights_dtype']}, {metrics['act_quant']}, "
                 f"{metrics['fused_dequant']}")
        total = {name: total.get(name, 0) + v for name, v in launches.items()}
        if (dtype, act) == ("int8", "off"):
            traffic = (lat, wall)
        say(f"[{label}] {traffic_line(metrics, batches, lat, wall)}; dequant_matmul launches "
            f"{launches['dequant_matmul']} ({per_forward} per batch): wgmma {wgmma}, general {general}; "
            f"flash_attn_fwd {launches['flash_attn_fwd']} (wgmma {launches['flash_attn_fwd_wgmma']}); "
            f"memory_allocated {torch.cuda.memory_allocated() / 1e9:.2f} GB, max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")
        x = np.zeros((8, cfg.image_size, cfg.image_size, 3), np.uint8)
        profile_device(torch, lambda: engine.predict(x), f"{label} bucket-8 forward", card, "6q")
        gate = run_quant_gate(engine_f32, engine, images, labels)
        floor = GATE_TOP1_FLOOR
        ok = gate["top1_quant"] >= floor
        say(f"[{label} gate] {json.dumps(gate)}; top-1 floor {floor} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{label}: top-1 agreement with the full-precision engine {gate['top1_quant']} below {floor}")
        rules_serve(engine, cfg, {"int8": "serve_quant", "float8_e4m3": "serve_fp8"}[dtype] if act == "off"
                    else "serve_actquant", card)
        del engine
    states.pop("float8_e4m3")
    return total, states, traffic


# Phase 6f: the serving fleet through its CLI, on an int8 export of phase
# 6q's weights in /dev/shm (the card machine allows 45 GiB of disk writes a
# call): `python -m vitax_torch.serve.fleet` with two replicas, each a
# `python -m vitax_torch.serve` process on the card running A1 and C.
FLEET_REPLICAS = 2
FLEET_TOPK = 6                  # the references keep one class past the served top-5: a tie at the 5th
FLEET_PROB_BAR = 1e-2           # |p - 6q's p| for a request run in another bucket than the reference's
FLEET_SLO_MS = 30000.0          # admission armed; the predicted wait at this load stays seconds below it
FLEET_FLAGS = ["--serve_max_batch", "8", "--serve_allow_chaos", "--serve_cache_max", "64",
               "--serve_batch_window_ms", "5", "--slo_p99_ms", str(FLEET_SLO_MS), "--serve_quant_dtype", "int8"]
FLEET_BURSTS = 3                # bursts of 16 offered until replica 1 takes a batch and dies
FLEET_CRASH = '{"site": "engine_predict", "at": 1, "action": "crash", "exit_code": 13}'
# The composer sends one group at a time to the least-loaded replica, ties to the lower EWMA latency, so
# one replica can take every group (on an H100 80GB HBM3 at 700 W replica 0 once took 34 of 40 requests
# and all 48 of the bursts).
# Replica 0's next batch is held FLEET_SLOW_S (a hang at batcher_flush through its /chaos): its EWMA
# rises past replica 1's, and the group after it goes to replica 1, which dies on it.
FLEET_SLOW_S = 3.0
FLEET_SLOW = json.dumps({"site": "batcher_flush", "at": 1, "action": "hang", "seconds": FLEET_SLOW_S})


def http_raw(url: str, body: bytes = None, ctype: str = "image/x-portable-pixmap") -> bytes:
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype} if body is not None else {})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.read()


def free_port_pair() -> int:
    """A port p with p and p + 1 both free (the replicas' --base_port)."""
    import socket
    for _ in range(200):
        p = free_port()
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", p + 1))
            return p
        except OSError:
            continue
    fail("6f: found no two consecutive free ports")


def fleet_references(cfg, device, state, images) -> dict:
    """{bucket: [(top-6 ids, top-6 probs) an image]}: 6q's int8 engine (its
    state, shared) on every image in each bucket, full batches in order."""
    from vitax_torch.serve import InferenceEngine
    cfg = dataclasses.replace(cfg, serve_quant_dtype="int8", serve_topk=FLEET_TOPK).validate()
    engine = InferenceEngine.from_state(cfg, state, device, "int8")
    engine.warmup()
    refs = {}
    for b in engine.buckets:
        rows = []
        for i in range(0, len(images), b):
            ids, probs = engine.predict(images[i:i + b])
            rows += list(zip(ids, probs))
        refs[b] = rows
    del engine
    return refs


def topk_within(ids, probs, ref_ids, ref_p, bar) -> bool:
    """Top-1 equal; each prob within `bar` of the reference's at its rank;
    another class at a rank only where the reference holds it within `bar`
    of that rank's prob (a tie the rounding may flip)."""
    if ids[0] != ref_ids[0]:
        return False
    rank = {int(c): j for j, c in enumerate(ref_ids)}
    for j, (c, p) in enumerate(zip(ids, probs)):
        if abs(p - float(ref_p[j])) > bar:
            return False
        if c != int(ref_ids[j]) and (c not in rank or abs(float(ref_p[rank[c]]) - float(ref_p[j])) > bar):
            return False
    return True


def judge_answer(ans: dict, refs: dict, i: int, k: int):
    """(buckets whose reference the answer equals bit for bit, the least prob
    gap to a reference, whether some bucket's reference holds it within the
    bar)."""
    exact, gaps, ok = [], [], False
    for b, rows in refs.items():
        ref_ids, ref_p = rows[i]
        if ans["classes"] == ref_ids[:k].tolist() and ans["probs"] == [float(p) for p in ref_p[:k]]:
            exact.append(b)
        gaps.append(max(abs(p - float(q)) for p, q in zip(ans["probs"], ref_p[:k])))
        ok = ok or topk_within(ans["classes"], ans["probs"], ref_ids, ref_p, FLEET_PROB_BAR)
    return exact, min(gaps), ok


def jsonl_events(path: str) -> list:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def replica_accounting(name: str, events: list) -> dict:
    """One replica's serve.jsonl: each serve_batch's bucket the power of two
    its size fills, and its serve_request records those batches' rows, bucket
    by bucket. Returns {bucket: requests}."""
    from vitax_torch.serve.engine import next_bucket
    batches = [e for e in events if e["kind"] == "serve_batch"]
    by_req, by_batch = {}, {}
    for e in events:
        if e["kind"] == "serve_request":
            by_req[e["bucket"]] = by_req.get(e["bucket"], 0) + 1
    for e in batches:
        if e["bucket"] != next_bucket(e["batch_size"], (1, 2, 4, 8)):
            fail(f"[6f] {name}: a batch of {e['batch_size']} ran in bucket {e['bucket']}")
        by_batch[e["bucket"]] = by_batch.get(e["bucket"], 0) + e["batch_size"]
    if by_req != by_batch:
        fail(f"[6f] {name}: serve_request records by bucket {by_req} against its batches' rows {by_batch}")
    return by_req


def phase_fleet(torch, card, engine_f32, states: dict) -> dict:
    """Phase 6f, its first half: the int8 export of 6q's weights (block by
    block on the card, consolidate.py save_npz_from_state, into /dev/shm),
    its codes and scales read back bit for bit 6q's, and 6q's int8 engine's
    references on every image the fleet phases send. `states["int8"]` is
    popped and freed. Returns the export (its path and dir, the bodies, the
    references, the config), which run_fleet serves once main has freed the
    f32 engine, and phase 7a after it.

    run_fleet, the second half: the fleet CLI with two replicas on it; 40
    requests (32 /predict from 8 threads, one /predict_batch of 8) through
    the router, each answer against 6q's int8 engine on the same
    image (bit for bit the bucket it ran in, else top-k and probs within
    FLEET_PROB_BAR); 8 repeats answered by the cache without a replica;
    composed groups; replica 1 crashed through its /chaos mid-burst with no
    client error, its restart and re-admission; SIGTERM: the fleet and both
    replicas exit 0; every serve.jsonl parsed and each replica's records
    accounting for every request it answered."""
    from vitax_torch.checkpoint.consolidate import load_npz_raw, save_npz_from_state
    from vitax_torch.data.transforms import ValTransform
    from vitax_torch.serve.engine import npz_state
    from vitax_torch.serve.server import decode_image_bytes

    state = states.pop("int8")
    work = tempfile.mkdtemp(prefix="vitax_torch_6f_", dir="/dev/shm" if os.path.isdir("/dev/shm") else None)
    path = os.path.join(work, "int8.npz")
    try:
        t0 = time.perf_counter()
        save_npz_from_state(path, engine_f32.model.state_dict(), "int8")
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        flat, scales, manifest = load_npz_raw(path, mapped=True)
        back = npz_state(flat, scales, engine_f32.device)       # as a replica loads it, onto the card
        t_read = time.perf_counter() - t0
        differ = sorted(k for k in state if k not in back or not torch.equal(back[k], state[k]))
        say(f"[6f export] int8 export of 6q's weights, quantized block by block on the card: "
            f"{os.path.getsize(path) / 1e9:.2f} GB in {t_write:.1f} s to {work}; {len(manifest)} quantized "
            f"leaves; read back onto the card as a replica reads it in {t_read:.1f} s, "
            f"{len(state) - len(differ)} of {len(state)} leaves (codes, scales, float leaves) bit for bit 6q's "
            f"in-memory state")
        if differ or set(back) != set(state):
            fail(f"[6f] the export differs from 6q's quantized state: {differ[:8]} "
                 f"{sorted(set(back) ^ set(state))[:8]}")
        del back

        rng = np.random.default_rng(SEED + 20)
        bodies = [ppm_bytes(rng) for _ in range(40 + 16 * FLEET_BURSTS + ARB_BODIES)]     # the last ones 7a's
        tf = ValTransform(engine_f32.cfg.image_size)
        images = np.stack([decode_image_bytes(b, tf) for b in bodies])
        t0 = time.perf_counter()
        refs = fleet_references(engine_f32.cfg, engine_f32.device, state, images)
        say(f"[6f refs] 6q's int8 engine on the {len(bodies)} images in buckets {sorted(refs)}: "
            f"{time.perf_counter() - t0:.1f} s")
        del state
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    # run_fleet and phase 7a serve the export and hold their answers to the references
    return {"path": path, "work": work, "bodies": bodies, "refs": refs, "first": len(bodies) - ARB_BODIES,
            "cfg": engine_f32.cfg}


def run_fleet(torch, card, export: dict, q8_traffic, start_beside) -> None:
    """The fleet CLI on the export: phase 6f's traffic, crash and shutdown.
    start_beside() is called once the traffic's figures are taken, so that
    what it starts (phase 7a's processes, phase 7t's torchrun) comes up
    beside the crash drill and the drain, which no figure times."""
    import signal
    cfg, path, work, bodies, refs = (export[key] for key in ("cfg", "path", "work", "bodies", "refs"))
    k = cfg.serve_topk
    mdir = os.path.join(work, "m")
    port, base = free_port(), free_port_pair()
    url = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "vitax_torch.serve.fleet", "--replicas", str(FLEET_REPLICAS), "--npz", path,
           *FLEET_FLAGS, "--serve_port", str(port), "--base_port", str(base), "--metrics_dir", mdir]
    log_path = os.path.join(work, "fleet.log")
    log = open(log_path, "w")
    t_start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT, start_new_session=True)

    def log_tail() -> str:
        log.flush()
        with open(log_path) as f:
            return f.read()[-4000:]

    def router_events() -> list:
        return jsonl_events(os.path.join(mdir, "serve.jsonl"))

    try:
        deadline = time.monotonic() + 300
        while True:
            if proc.poll() is not None:
                fail(f"[6f] the fleet exited {proc.returncode} before both replicas were ready:\n{log_tail()}")
            try:
                health = json.loads(http_raw(url + "/healthz"))
                if list(health["replicas"].values()) == ["ready"] * FLEET_REPLICAS:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                fail(f"[6f] the replicas were not ready within 300 s:\n{log_tail()}")
            time.sleep(0.5)
        ev = router_events()
        spawned = {e["replica"]: e["time"] for e in ev if e["kind"] == "replica_spawn"}
        ready_s = {e["replica"]: e["time"] - spawned[e["replica"]] for e in ev if e["kind"] == "replica_admit"}
        metrics = json.loads(http_raw(url + "/metrics"))
        fleet = metrics["fleet"]
        free, total = torch.cuda.mem_get_info()
        say(f"[6f start] python -m vitax_torch.serve.fleet --replicas {FLEET_REPLICAS} --npz <int8 export> "
            f"{' '.join(FLEET_FLAGS)}: router on :{port}; seconds from spawn to ready "
            + ", ".join(f"{n} {s:.1f}" for n, s in sorted(ready_s.items()))
            + f" ({time.perf_counter() - t_start:.1f} s to both); weights {fleet.get('weights_dtypes')}, fused "
            f"dequant {fleet.get('fused_dequants')}, param_bytes {fleet.get('param_bytes', 0) / 1e9:.2f} GB over "
            f"the replicas; card memory in use {(total - free) / 1e9:.1f} of {total / 1e9:.1f} GB (this process "
            f"{torch.cuda.memory_allocated() / 1e9:.1f} GB: the f32 engine freed before the fleet) [{card}]")
        if fleet.get("weights_dtypes") != ["int8"] or fleet.get("fused_dequants") != ["True"]:
            fail(f"[6f] the replicas do not serve int8 weights through kernel C: {fleet}")

        # traffic: 32 /predict from 8 threads, one /predict_batch of 8
        answers, lat, errors = [None] * 40, [0.0] * 32, []

        def client(worker: int) -> None:
            for i in range(worker, 32, 8):
                t = time.perf_counter()
                try:
                    answers[i] = http_raw(url + "/predict", bodies[i])
                except Exception as e:  # noqa: BLE001 - reported below, the run fails
                    errors.append(f"request {i}: {e!r}")
                lat[i] = time.perf_counter() - t

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(w,)) for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wire = {"items": [base64.b64encode(b).decode() for b in bodies[32:40]],
                "content_types": ["image/x-portable-pixmap"] * 8}
        items = json.loads(http_raw(url + "/predict_batch", json.dumps(wire).encode(), "application/json"))["results"]
        wall = time.perf_counter() - t0
        if errors or any(it["status"] != 200 for it in items):
            fail(f"[6f] requests failed: {errors[:4]} {[it for it in items if it['status'] != 200][:2]}")
        answers[32:40] = [it["body"].encode() for it in items]
        judged = [judge_answer(json.loads(a), refs, i, k) for i, a in enumerate(answers)]
        for i, (exact, gap, ok) in enumerate(judged):
            check_answer(json.loads(answers[i]), k, cfg.num_classes)
            if not ok or not exact:
                fail(f"[6f] answer {i} {json.loads(answers[i])} is not 6q's in any bucket bit for bit (buckets "
                     f"{exact}) or not within {FLEET_PROB_BAR} (gap {gap:.3g}, top-k within: {ok})")
        m1 = json.loads(http_raw(url + "/metrics"))
        served = {n: r["server"]["requests_total"] for n, r in m1["replicas"].items()}

        # the cache: 8 repeated bodies answered with the first answers' bytes, no replica reached
        repeats = [http_raw(url + "/predict", bodies[i]) for i in range(8)]
        m2 = json.loads(http_raw(url + "/metrics"))
        served2 = {n: r["server"]["requests_total"] for n, r in m2["replicas"].items()}
        cb = m2["continuous_batching"]
        if repeats != answers[:8] or m2["cache_hits_total"] - m1["cache_hits_total"] != 8 or served2 != served:
            fail(f"[6f] repeats not answered by the cache: hits {m1['cache_hits_total']} -> "
                 f"{m2['cache_hits_total']}, replica requests {served} -> {served2}")
        if cb["items_total"] <= cb["batches_total"] or min(served.values()) == 0:
            fail(f"[6f] no composed group above 1, or a replica took no request: {cb}, {served}")
        lat_s = np.sort(np.asarray(lat))
        q8_lat, q8_wall = q8_traffic
        by_bucket = {}          # answers bit for bit one bucket's reference only: they ran in that bucket
        for exact, _, _ in judged:
            if len(exact) == 1:
                by_bucket[exact[0]] = by_bucket.get(exact[0], 0) + 1
        say(f"[6f traffic] 40 requests through the router (32 /predict from 8 threads, one /predict_batch of 8) in "
            f"{wall:.3f}s = {40 / wall:.2f} images/s; client p50 {np.percentile(lat_s, 50) * 1e3:.1f} ms p95 "
            f"{np.percentile(lat_s, 95) * 1e3:.1f} ms; 6q's int8 engine alone over HTTP {40 / q8_wall:.2f} images/s, "
            f"p50 {np.percentile(q8_lat, 50) * 1e3:.1f} ms p95 {np.percentile(q8_lat, 95) * 1e3:.1f} ms [{card}]")
        say(f"[6f answers] every answer bit for bit 6q's int8 engine on the same image in some bucket (answers "
            f"matching one bucket only: {dict(sorted(by_bucket.items()))}); largest prob gap to the nearest "
            f"bucket's reference {max(g for _, g, _ in judged):.3g} (bar {FLEET_PROB_BAR}); replicas answered "
            f"{served}; composed groups {cb['batches_total']} of {cb['items_total']} items (fill p50 "
            f"{cb['batch_fill_p50']}, p95 {cb['batch_fill_p95']}); 8 repeats: cache hits "
            f"{m2['cache_hits_total'] - m1['cache_hits_total']}, the answers' bytes, replica requests unchanged; "
            f"admission shed {m2['admission']['shed_total']} of {m2['admission']['admitted_total']} admitted")
        if m2["admission"]["shed_total"] or m2["shed_total"] or m2["errors_total"]:
            fail(f"[6f] sheds or errors at this load: {m2['admission']}, errors {m2['errors_total']}")

        start_beside()
        say(f"[6f beside] phase 7a's processes (arbiter, agent, fleet, the two training ranks) and phase 7t's "
            f"torchrun started beside the crash drill and the drain; their phases read them [{card}]")
        # replica 1 crashed through its own /chaos mid-burst, replica 0's next batch held
        victim = m2["replicas"]["replica_1"]["url"]
        installed = [json.loads(http_raw(m2["replicas"][n]["url"] + "/chaos", plan.encode(), "application/json"))
                     for n, plan in (("replica_0", FLEET_SLOW), ("replica_1", FLEET_CRASH))]
        if installed != [{"installed": f"batcher_flush:hang(at=1, seconds={FLEET_SLOW_S:g})"},
                         {"installed": "engine_predict:crash(at=1, exit_code=13)"}]:
            fail(f"[6f] /chaos answered {installed}")
        burst_answers, errors, n_burst = {}, [], 0
        for b in range(FLEET_BURSTS):
            idx = list(range(40 + 16 * b, 56 + 16 * b))
            n_burst += 16

            def burst(part, idx=idx):
                for i in idx[part::8]:
                    try:
                        burst_answers[i] = json.loads(http_raw(url + "/predict", bodies[i]))
                    except Exception as e:  # noqa: BLE001 - reported below, the run fails
                        errors.append(f"request {i}: {e!r}")
            ts = [threading.Thread(target=burst, args=(w,)) for w in range(8)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=600)
            time.sleep(1.5)             # a health sweep or two: the death is an event by then
            if any(e["kind"] == "replica_exit" and e["replica"] == "replica_1" for e in router_events()):
                break
        if errors:
            fail(f"[6f] clients saw errors across the crash: {errors[:4]}")
        for i, ans in burst_answers.items():
            exact, gap, ok = judge_answer(ans, refs, i, k)
            if not exact or not ok:
                fail(f"[6f] burst answer {i} is not 6q's (buckets {exact}, gap {gap:.3g})")
            if len(exact) == 1:
                by_bucket[exact[0]] = by_bucket.get(exact[0], 0) + 1
        deadline = time.monotonic() + 300
        while True:
            ev = router_events()
            exit_t = [e["time"] for e in ev if e["kind"] == "replica_exit" and e["replica"] == "replica_1"]
            admit_t = [e["time"] for e in ev if e["kind"] == "replica_admit" and e["replica"] == "replica_1"
                       and exit_t and e["time"] > exit_t[0]]
            if admit_t:
                break
            if not exit_t and time.monotonic() > deadline - 240:
                fail(f"[6f] replica 1 took no batch in {n_burst} requests: no replica_exit")
            if time.monotonic() > deadline:
                fail(f"[6f] replica 1 was not re-admitted within 300 s:\n{log_tail()}")
            time.sleep(0.5)
        exits = [e for e in ev if e["kind"] == "replica_exit"]
        restarts = [e for e in ev if e["kind"] == "replica_restart"]
        if exits[0]["exit_code"] != 13 or [e["replica"] for e in restarts] != ["replica_1"]:
            fail(f"[6f] exits {exits}, restarts {restarts}")
        m3 = json.loads(http_raw(url + "/metrics"))
        say(f"[6f chaos] a crash plan at engine_predict POSTed to replica_1's /chaos (and to replica_0's a "
            f"{FLEET_SLOW_S:g} s hang of its next batch, so the next group goes to replica_1); {n_burst} requests in "
            f"bursts of 16 from 8 threads: 0 client errors ({len(burst_answers)} answers, each 6q's in some bucket "
            f"bit for bit), router retries {m3['retries_total']}, breaker opens {m3['breaker_opens']}; replica_1 "
            f"exit 13, restarted, re-admitted {admit_t[0] - exit_t[0]:.1f} s after its exit [{card}]")
    except BaseException:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)
        log.close()
        raise

    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=180)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
        fail(f"[6f] the fleet did not exit within 180 s of SIGTERM:\n{log_tail()}")
    log.close()
    ev = router_events()
    drained = {e["replica"]: e["exit_code"] for e in ev if e["kind"] == "replica_exit" and e.get("drained")}
    if rc != 0 or drained != {f"replica_{i}": 0 for i in range(FLEET_REPLICAS)}:
        fail(f"[6f] SIGTERM: the fleet exited {rc}, its replicas' drains {drained}:\n{log_tail()}")

    # every serve.jsonl: the kinds the traffic, the crash and the drain imply; the replicas' accounting
    kinds = {e["kind"] for e in ev}
    want = {"replica_spawn", "replica_admit", "cache", "replica_exit", "replica_restart", "dispatch_retry"}
    if not want <= kinds:
        fail(f"[6f] the router's serve.jsonl lacks {sorted(want - kinds)}")
    answered, lines, ran = 0, [], {}
    for i in range(FLEET_REPLICAS):
        name = f"replica_{i}"
        rev = jsonl_events(os.path.join(mdir, name, "serve.jsonl"))
        rkinds = [e["kind"] for e in rev]
        need = {"serve_start", "serve_request", "serve_batch", "serve_drain"}
        if i == 1:
            need |= {"chaos_install", "serve_fault"}
            fault = [e for e in rev if e["kind"] == "serve_fault"]
            if fault[0]["site"] != "engine_predict" or fault[0]["action"] != "crash" or rkinds.count("serve_start") != 2:
                fail(f"[6f] replica_1's serve.jsonl: {fault}, serve_start x{rkinds.count('serve_start')}")
        if not need <= set(rkinds) or not all(e["clean"] for e in rev if e["kind"] == "serve_drain"):
            fail(f"[6f] {name}'s serve.jsonl lacks {sorted(need - set(rkinds))} or drained unclean")
        mine = replica_accounting(name, rev)
        answered += sum(mine.values())
        for b, n in mine.items():
            ran[b] = ran.get(b, 0) + n
        lines.append(f"{name} {sum(mine.values())} requests in {rkinds.count('serve_batch')} batches, by "
                     f"bucket {dict(sorted(mine.items()))}")
    if answered != 40 + len(burst_answers):
        fail(f"[6f] the replicas' serve_request records count {answered} requests; the router answered "
             f"{40 + len(burst_answers)} without its cache")
    if any(n > ran.get(b, 0) for b, n in by_bucket.items()):
        fail(f"[6f] answers that match one bucket's reference only {by_bucket} exceed the requests the replicas "
             f"ran in that bucket {ran}")
    say(f"[6f shutdown] SIGTERM: the fleet exit 0, replicas drained to exit {drained}; serve.jsonl parsed: the "
        f"router's {len(ev)} events ({', '.join(sorted(kinds))}); " + "; ".join(lines)
        + f"; requests by bucket over both {dict(sorted(ran.items()))}, answers matching one bucket only "
        f"{dict(sorted(by_bucket.items()))} (each batch one forward through A1 in {cfg.num_blocks} blocks and C at "
        f"{4 * cfg.num_blocks + 1} sites by the engine's construction: the replicas' launches are not counted in "
        f"this process) [{card}]")


# Phase 7a: the chip arbiter's drill on the one card (vitax's acceptance
# drill, tests/test_arbiter.py:870-1075). Three processes share the card:
# `python -m vitax_torch.arbiter --hosts h0,h1` with its training tenant
# (two ranks over gloo on the card at b16's width, bench.py:288-291, cut to
# depth 4 for the script's time: at depth 12 a gloo step took 2.5 s and 7a
# 130.8-188.4 s on an H100 80GB HBM3 at 700 W; ZeRO-3,
# peer-replicated, each rank ARB_TRAIN_MAIN: a gloo group made before the
# CLI's main, as TP_CLI_MAIN does, since NCCL refuses two ranks on one
# card), the fleet CLI with one int8 replica of the full 10B (6f's export)
# at --max_replicas 1, and one placement agent with one slot. A hang plan
# slows the replica through its /chaos, a burst sheds, the autoscaler at its
# ceiling escalates to the arbiter, which borrows h1: both ranks exit 0 on
# one joint preemption checkpoint, one rank restarts from the peer store,
# the agent's replica is adopted and answers; once the burst ends the
# arbiter returns h1 and training re-expands to two ranks. The autoscaler's
# cooldown outlasts the drill, so its one action is the first escalation:
# with 5 s it scaled the fleet in once the burst ended (an H100 run), the
# borrowed replica counting in its size, and retired the seed replica
# (vitax's autoscaler picks its victim the same way).
ARB_CELL = dict(image_size=224, patch_size=16, embed_dim=768, num_heads=12, num_blocks=4, batch_size=32,
                fake_data=True, warmup_steps=4, log_step_interval=5, eval_max_batches=1, num_epochs=1,
                steps_per_epoch=100000, test_epoch_interval=99, ckpt_epoch_interval=99, num_workers=2)
# --replicate_steps 100 (README's): a generation lives fewer steps, so the peer stores are refreshed by the
# preemption save alone. At 4 a rank's 0.5 GB shard took 7-9 s through the TCP stores (an H100 run), its
# sender rewrote the buddy's copy 80% of the time, and the drained pair left no complete copy of rank 1's
# shard on rank 0: the 2 -> 1 resume read the checkpoint directory.
ARB_TRAIN_FLAGS = ["--replicate_steps", "100", "--peer_heartbeat_s", "1", "--control_sync_steps", "2"]
ARB_BODIES = 16                 # 7a's images, answered by the borrowed replica against 6q's references
ARB_SLO_MS = 2000.0             # admission's deadline: the hung replica's queue sheds past it
ARB_SLOW = json.dumps({"site": "engine_predict", "at": 1, "times": 1000000, "action": "hang", "seconds": 0.5})
ARB_POLICY = ["--arbiter_dwell_s", "1", "--arbiter_cooldown_s", "5", "--arbiter_interval_s", "0.5"]
ARB_FLEET = ["--replicas", "1", "--max_replicas", "1", "--serve_max_batch", "8", "--serve_allow_chaos",
             "--serve_quant_dtype", "int8", "--slo_p99_ms", str(ARB_SLO_MS), "--autoscale_dwell_s", "1",
             "--autoscale_cooldown_s", "900", "--health_interval_s", "0.5"]
ARB_TRAIN_MAIN = """import json, os, sys
import torch.distributed as dist
from vitax_torch.ops import _build
from vitax_torch.train.__main__ import main
if "WORLD_SIZE" in os.environ:
    dist.init_process_group("gloo", init_method="env://")
rc = 1
try:
    rc = main(sys.argv[2:])
finally:
    with open(os.path.join(sys.argv[1], "launches_%d.json" % os.getpid()), "w") as f:
        json.dump({"rank": int(os.environ.get("RANK", "0")), "world": int(os.environ.get("WORLD_SIZE", "1")),
                   "rc": rc, "launches": _build.LAUNCHES}, f)
sys.exit(rc)
"""


class CardMemory:
    """The card's memory in use (total minus free from mem_get_info: every
    process's allocations and contexts) sampled every `every` s on a
    thread between start() and stop(); stop() returns the largest sample
    in GB."""

    def __init__(self, torch, every: float = 0.5):
        self.torch, self.every, self._peak = torch, every, 0.0
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True, name="card-memory")

    def _run(self) -> None:
        while True:
            free, total = self.torch.cuda.mem_get_info()
            with self._lock:
                self._peak = max(self._peak, (total - free) / 1e9)
            if self._stop.wait(self.every):
                return

    def start(self) -> "CardMemory":
        self._thread.start()
        return self

    def stop(self) -> float:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join()
        with self._lock:
            return self._peak


class ArbiterDrill:
    """Phase 7a's processes, their logs and the HTTP they answer."""

    def __init__(self, torch, export: dict):
        self.torch, self.export = torch, export
        self.work = os.path.join(export["work"], "7a")
        self.m = os.path.join(self.work, "m")
        self.launch_dir = os.path.join(self.work, "launches")
        for d in (self.m, self.launch_dir):
            os.makedirs(d, exist_ok=True)
        ports = free_ports_below_ephemeral(5)
        self.arb, self.fleet = f"http://127.0.0.1:{ports[0]}", f"http://127.0.0.1:{ports[1]}"
        self.ports = ports
        self.env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.procs, self.logs = {}, {}
        self.memory = CardMemory(torch)

    def commands(self) -> dict:
        from vitax_torch.ops import _build
        main_py = os.path.join(self.work, "arbiter_train_main.py")
        with open(main_py, "w") as f:
            f.write(ARB_TRAIN_MAIN)
        a, p, b, g, gb = self.ports
        serve = ["--npz", self.export["path"], "--serve_max_batch", "8", "--serve_quant_dtype", "int8"]
        train = [sys.executable, main_py, self.launch_dir, *cli_flags({**ARB_CELL, "seed": SEED}), "--device",
                 DRILL_DEVICE, *ARB_TRAIN_FLAGS, "--ckpt_dir", os.path.join(self.work, "ckpt"), "--metrics_dir",
                 self.m, "--arbiter_url", self.arb, "--compile_cache_dir", _build.BUILD_DIR]
        return {
            "agent": ["-m", "vitax_torch.serve.fleet.agent", "--agent_port", str(g), "--agent_base_port", str(gb),
                      "--agent_max_replicas", "1"],
            "fleet": ["-m", "vitax_torch.serve.fleet", "--npz", self.export["path"], *ARB_FLEET, "--serve_port",
                      str(p), "--base_port", str(b), "--arbiter_url", self.arb, "--metrics_dir",
                      os.path.join(self.m, "fleet")],
            "arbiter": ["-m", "vitax_torch.arbiter", "--hosts", "h0,h1", "--arbiter_port", str(a), "--fleet_url",
                        self.fleet, "--agent_urls", f"h1=http://127.0.0.1:{g}", "--serve_argv",
                        " ".join(serve + ["--metrics_dir", os.path.join(self.m, "borrowed")]), "--metrics_dir",
                        self.m, *ARB_POLICY, "--train_grace_s", "240", "--ledger_path",
                        os.path.join(self.work, "ledger.json"), "--train_log_dir", os.path.join(self.work, "train"),
                        "--", *train]}

    def start(self) -> None:
        self.t_spawn = time.monotonic()
        for name, argv in self.commands().items():
            self.logs[name] = os.path.join(self.work, f"{name}.log")
            self.procs[name] = subprocess.Popen([sys.executable, *argv], cwd=REPO, env=self.env,
                                                stdout=open(self.logs[name], "w"), stderr=subprocess.STDOUT,
                                                start_new_session=True)

    def tail(self, name: str, n: int = 3000) -> str:
        with open(self.logs[name]) as f:
            return f.read()[-n:]

    def get(self, url: str) -> dict:
        return json.loads(http_raw(url))

    def metrics(self) -> dict:
        return self.get(self.arb + "/metrics")

    def wait(self, cond, timeout_s: float, what: str) -> float:
        """Seconds until cond() holds; fails at the timeout or when a
        process exits early."""
        t0 = time.monotonic()
        while True:
            for name, proc in self.procs.items():
                if proc.poll() is not None:
                    fail(f"[7a] {name} exited {proc.returncode} while waiting for {what}:\n{self.tail(name)}")
            try:
                if cond():
                    return time.monotonic() - t0
            except OSError:
                pass
            if time.monotonic() - t0 > timeout_s:
                fail(f"[7a] no {what} within {timeout_s:.0f} s; the arbiter's log:\n{self.tail('arbiter')}\n"
                     f"the fleet's:\n{self.tail('fleet')}")
            time.sleep(0.5)

    def stop_all(self, timeouts: dict) -> dict:
        """SIGTERM each named process at once, then each one's exit code
        within its timeout ("killed" past it)."""
        import signal
        for name in timeouts:
            if self.procs[name].poll() is None:
                self.procs[name].send_signal(signal.SIGTERM)
        t0, rcs = time.monotonic(), {}
        for name, timeout_s in timeouts.items():
            proc = self.procs[name]
            try:
                rcs[name] = proc.wait(timeout=max(timeout_s - (time.monotonic() - t0), 1.0))
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait(timeout=60)
                rcs[name] = "killed"
        return rcs

    def kill_all(self) -> None:
        import signal
        self.memory.stop()
        for proc in self.procs.values():
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except OSError:
                    pass
                proc.wait(timeout=60)


class Beside:
    """Phase 7a's processes and phase 7t's torchrun, started together beside
    phase 6f's crash drill (run_fleet's start_beside), each read by its own
    phase; kill() stops whatever still runs when the script ends early."""

    def __init__(self, torch, export: dict):
        self.arbiter = ArbiterDrill(torch, export)
        self.torchrun = None

    def start(self) -> None:
        self.arbiter.start()
        self.torchrun = start_torchrun()

    def kill(self) -> None:
        import signal
        self.arbiter.kill_all()
        run = self.torchrun
        if run is not None and run["proc"].poll() is None:
            try:
                os.killpg(run["proc"].pid, signal.SIGKILL)
            except OSError:
                pass
            run["proc"].wait(timeout=60)


def free_ports_below_ephemeral(n: int) -> list:
    """n distinct bindable ports below Linux's ephemeral range (32768), so
    no process's port-0 bind (a TCPStore, the ranks' store) takes one of
    them before its process binds it."""
    import random
    import socket
    rng, out = random.Random(), []
    while len(out) < n:
        p = rng.randrange(20000, 32000)
        if p in out or p + 1 in out or p - 1 in out:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", p))
            except OSError:
                continue
        out.append(p)
    return out


def phase_arbiter(torch, card, beside: Beside) -> dict:
    """Phase 7a (see ARB_CELL's note), its processes started beside 6f's
    crash drill: once 7t's torchrun, started with them, has exited (its
    memory out of the card's), the borrow and the return, every
    process's exit, the borrowed replica bit for bit 6q's int8 engine, the
    2 -> 1 resume from the peer store with 0 checkpoint-directory reads, the
    re-expansion to 2 with finite losses, the card's peak memory, each
    process's launches, the arbiter's events through tools/metrics_report.py.
    Returns the ranks' and the replicas' launches summed."""
    from vitax_torch.ops import _build
    t_phase = time.perf_counter()
    say(f"[7a host] {free_host_memory(torch)}")
    dr, export = beside.arbiter, beside.arbiter.export
    cfg, bodies, refs, first = export["cfg"], export["bodies"], export["refs"], export["first"]
    k = cfg.serve_topk
    try:
        t_head = time.monotonic() - dr.t_spawn
        t_torchrun = dr.wait(lambda: beside.torchrun["proc"].poll() is not None, 600, "exit of 7t's torchrun")
        dr.memory.start()
        t_ready = dr.wait(lambda: dr.get(dr.fleet + "/healthz")["replicas"] == {"replica_0": "ready"}, 300,
                          "ready seed replica")
        fleet_ev = jsonl_events(os.path.join(dr.m, "fleet", "serve.jsonl"))
        ready_at = (next(e["time"] for e in fleet_ev if e["kind"] == "replica_admit")
                    - next(e["time"] for e in fleet_ev if e["kind"] == "replica_spawn"))
        t_train = dr.wait(lambda: (dr.metrics()["train_telemetry"] or {}).get("process_count") == 2, 300,
                          "heartbeat of the two training ranks")
        say(f"[7a start] arbiter (hosts h0, h1; training on 2 ranks over gloo at b16's width, depth "
            f"{ARB_CELL['num_blocks']}, ZeRO-3, --replicate_steps 100), the fleet (one int8 replica of the full "
            f"10B, --max_replicas 1, --slo_p99_ms {ARB_SLO_MS:g}) and one placement agent started at once, "
            f"{t_head:.1f} s before this phase (beside 6f's crash drill); 7t's torchrun exited "
            f"{t_torchrun:.1f} s into it; the replica ready {ready_at:.1f} s after its spawn "
            f"({t_torchrun + t_ready:.1f} s into this phase), the ranks' first heartbeat {t_train:.1f} s later "
            f"[{card}]")
        seed = dr.get(dr.fleet + "/metrics")["replicas"]["replica_0"]["url"]
        installed = json.loads(http_raw(seed + "/chaos", ARB_SLOW.encode(), "application/json"))
        stop, codes, lock = threading.Event(), {}, threading.Lock()

        def burst(w: int) -> None:
            i = w
            while not stop.is_set():
                try:
                    http_raw(dr.fleet + "/predict", bodies[first + i % ARB_BODIES])
                    code = 200
                except urllib.error.HTTPError as e:
                    code = e.code
                    time.sleep(0.05)
                except OSError as e:
                    code = f"{type(e).__name__}"
                    time.sleep(0.05)
                with lock:
                    codes[code] = codes.get(code, 0) + 1
                i += 8
        threads = [threading.Thread(target=burst, args=(w,), daemon=True) for w in range(8)]
        t_burst = time.time()
        for t in threads:
            t.start()
        try:
            t_borrow = dr.wait(lambda: dr.metrics()["borrows_total"] >= 1, 300, "borrow")

            def routed() -> bool:
                rep = dr.get(dr.fleet + "/metrics")["replicas"].get("borrowed_0", {})
                return rep.get("state") == "ready" and rep.get("requests_total", 0) > 0
            t_adopt = dr.wait(routed, 300, "answer routed to the borrowed replica")
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=120)
        http_raw(seed + "/chaos", b"", "application/json")          # disarmed: the pressure clears
        fm = dr.get(dr.fleet + "/metrics")
        borrowed = fm["replicas"]["borrowed_0"]
        if set(codes) - {200, 429} or 429 not in codes or fm["autoscale"]["escalations_total"] < 1:
            fail(f"[7a] the burst's answers {codes}, escalations {fm['autoscale']}")
        answers = []
        for i in range(first, first + ARB_BODIES):
            ans = json.loads(http_raw(borrowed["url"] + "/predict", bodies[i]))
            exact, gap, ok = judge_answer(ans, refs, i, k)
            check_answer(ans, k, cfg.num_classes)
            if not exact or not ok:
                fail(f"[7a] the borrowed replica's answer {i} is not 6q's int8 engine's in any bucket bit for bit "
                     f"(buckets {exact}, gap {gap:.3g})")
            answers.append(exact)
        bor_launches = dr.get(borrowed["url"] + "/metrics")["kernel_launches"]
        say(f"[7a borrow] {installed['installed']} on the seed replica, a burst from 8 threads: answers {codes}; "
            f"the arbiter borrowed h1 {t_borrow:.1f} s into the burst, the router sent the adopted replica its "
            f"first request {t_borrow + t_adopt:.1f} s into it; {ARB_BODIES} requests to the borrowed replica, "
            f"each bit for bit 6q's int8 engine in its bucket ({sorted({b for e in answers for b in e})}) [{card}]")
        t_return = dr.wait(lambda: dr.metrics()["returns_total"] >= 1, 300, "return")
        t_grow = dr.wait(lambda: (dr.metrics()["train_telemetry"] or {}).get("process_count") == 2
                         and dr.metrics()["train_alive"] == 2, 300, "re-expansion to 2 ranks")
        step0 = dr.metrics()["train_telemetry"]["step"]
        dr.wait(lambda: dr.metrics()["train_telemetry"]["step"] >= step0 + 2, 300, "steps of the re-expanded pair")
        final = dr.metrics()
        seed_launches = dr.get(dr.fleet + "/metrics")["replicas"]["replica_0"]["server"]["kernel_launches"]
        slots = dr.get(f"http://127.0.0.1:{dr.ports[3]}/healthz")["slots"]
        rcs = dr.stop_all({"arbiter": 300, "fleet": 180, "agent": 120})
    except BaseException:
        dr.kill_all()
        raise
    peak_used = dr.memory.stop()
    say(f"[7a return] the return {t_return:.1f} s after the burst ended, training at 2 ranks {t_grow:.1f} s after "
        f"that; the ledger {final['ledger']['hosts']}, borrowed {final['borrowed']}, agent slots {slots}; exits "
        f"{rcs} [{card}]")
    arb_log = dr.tail("arbiter", 20000)
    if rcs != {"arbiter": 0, "fleet": 0, "agent": 0} or "training drained, exit codes [0, 0]" not in arb_log:
        fail(f"[7a] exits {rcs}; the arbiter's log:\n{arb_log[-3000:]}")
    if final["ledger"]["hosts"]["h1"]["owner"] != "train" or final["borrowed"] or slots["used"] != 0:
        fail(f"[7a] after the return: ledger {final['ledger']}, borrowed {final['borrowed']}, agent {slots}")

    # the ranks: every generation's processes exited 0 (2, then 1, then 2 ranks)
    ranks = []
    for name in sorted(os.listdir(dr.launch_dir)):
        with open(os.path.join(dr.launch_dir, name)) as f:
            ranks.append(json.load(f))
    if sorted(r["world"] for r in ranks) != [1, 2, 2, 2, 2] or any(r["rc"] != 0 for r in ranks):
        fail(f"[7a] the training processes' (world, exit): {[(r['world'], r['rc']) for r in ranks]}")
    events = jsonl_events(os.path.join(dr.m, "metrics.jsonl"))
    arb = [e for e in events if e.get("kind") == "arbiter"]
    names = [e["event"] for e in arb]
    restores = [e for e in events if e.get("kind") == "restore"]
    elastic = [(e["from_processes"], e["to_processes"]) for e in events if e.get("event") == "elastic_resume"]
    steps = [e for e in events if "kind" not in e]
    if names.count("borrow") != 1 or names.count("return") != 1 or {"borrow_failed", "return_failed"} & set(names):
        fail(f"[7a] arbiter events {names}")
    if elastic != [(2, 1), (1, 2)] or restores[0]["path"] != "peer" or restores[0]["dcp_reads"] != 0:
        fail(f"[7a] elastic resumes {elastic}, restores {restores}")
    t_ret_start = next(e["time"] for e in arb if e["event"] == "return_start")
    regrown = next(e["time"] for e in events if e.get("event") == "elastic_resume" and e["to_processes"] == 2)
    after = [e for e in steps if e["time"] > regrown]
    if not after or not all(np.isfinite(e["loss"]) for e in steps):
        fail(f"[7a] steps after the re-expansion {len(after)}, losses {[e['loss'] for e in steps]}")
    bor_ev = jsonl_events(os.path.join(dr.m, "borrowed", "serve.jsonl"))
    first_answer = min(e["time"] for e in bor_ev if e["kind"] == "serve_request")
    fleet_esc = [e["time"] for e in jsonl_events(os.path.join(dr.m, "fleet", "serve.jsonl"))
                 if e["kind"] == "autoscale" and e.get("outcome") == "escalated"]
    if not fleet_esc:
        fail("[7a] the fleet's serve.jsonl holds no escalation")
    borrow_ev = next(e for e in arb if e["event"] == "borrow")
    drains = [e for e in bor_ev if e["kind"] == "serve_drain"]
    fleet_ev = jsonl_events(os.path.join(dr.m, "fleet", "serve.jsonl"))
    seed_exit = [e for e in fleet_ev if e["kind"] == "replica_exit" and e.get("drained")]
    if not drains or not all(d["clean"] for d in drains) or [e["exit_code"] for e in seed_exit] != [0]:
        fail(f"[7a] the borrowed replica's drain {drains}, the seed replica's {seed_exit}")
    report = metrics_report(os.path.join(dr.m, "metrics.jsonl"))
    # each process's launches: the ranks' A1, A2, B; the replicas' A1 and C
    launches = {key: sum(r["launches"][key] for r in ranks) + seed_launches[key] + bor_launches[key]
                for key in _build.LAUNCHES}
    rank_sum = {key: sum(r["launches"][key] for r in ranks) for key in ("flash_attn_fwd", "flash_attn_bwd",
                                                                       "fused_adamw")}
    per_rank = [{key: r["launches"][key] for key in ("flash_attn_fwd", "flash_attn_bwd", "fused_adamw")}
                for r in ranks]
    rep = {name: {key: ls[key] for key in ("flash_attn_fwd", "dequant_matmul")}
           for name, ls in (("replica_0", seed_launches), ("borrowed_0", bor_launches))}
    if (min(min(r.values()) for r in per_rank) == 0 or min(min(r.values()) for r in rep.values()) == 0
            or launches["flash_attn_fwd_general"] or launches["flash_attn_bwd_general"]
            or launches["dequant_matmul_general"] or launches["flash_attn_fwd"] != launches["flash_attn_fwd_wgmma"]):
        fail(f"[7a] a process launched no kernel of its path, or a general kernel: ranks {per_rank}, replicas "
             f"{rep}, totals {launches}")
    say(f"[7a times] seconds from the autoscaler's first escalation to the adopted replica's first answer "
        f"{first_answer - min(fleet_esc):.1f} (the burst's start {first_answer - t_burst:.1f}; the borrow's reason "
        f"{borrow_ev['reason']}, its own {borrow_ev['duration_s']:.1f} s: the drain, the ledger, the provision "
        f"and the adopt), "
        f"from the return's start to the re-expanded pair's first step "
        f"{min(e['time'] for e in after) - t_ret_start:.1f};"
        f" the 2 -> 1 resume from {restores[0]['path']} in {restores[0]['seconds']:.2f} s, {restores[0]['dcp_reads']} "
        f"checkpoint-directory reads, 1 -> 2 from {restores[-1]['path']}; losses after the re-expansion "
        + " ".join(f"{e['loss']:.4f}" for e in after[:4]) + f"; card memory in use at most {peak_used:.1f} GB "
        f"[{card}]")
    say(f"[7a launches] the ranks (world, A1, A2, B): "
        + ", ".join(f"({r['world']}, {p['flash_attn_fwd']}, {p['flash_attn_bwd']}, {p['fused_adamw']})"
                    for r, p in zip(ranks, per_rank))
        + f"; the replicas (A1, C): {rep}; totals {rank_sum}")
    say(f"[7a events] tools/metrics_report.py on the shared stream: arbiter {report.get('arbiter_events')}, "
        f"topology {report.get('train_topology_timeline')}; the arbiter's events, s from the burst's start: "
        + ", ".join(f"{e['event']} {e['time'] - t_burst:.1f}" for e in arb))
    say(f"[7a] took {time.perf_counter() - t_phase:.1f}s")
    return launches


def train_run_launches(cfg) -> dict:
    """Every launch count of a rate-0 train() run of cfg at N <= 2048: per
    optimizer step a forward and a recompute per block, a backward per
    block, one optimizer launch; the eval adds a forward per block per
    batch. All on the wgmma kernels."""
    from vitax_torch.ops import _build
    n_fwd = cfg.max_steps * 2 * cfg.num_blocks + cfg.eval_max_batches * cfg.num_blocks
    return {"flash_attn_fwd": n_fwd, "flash_attn_bwd": cfg.max_steps * cfg.num_blocks, "fused_adamw": cfg.max_steps,
            "dequant_matmul": 0, "flash_attn_fwd_drop": 0, "flash_attn_bwd_drop": 0,
            **dict.fromkeys(_build.STREAM_KERNELS, 0), "flash_attn_fwd_wgmma": n_fwd, "flash_attn_fwd_general": 0,
            "flash_attn_bwd_wgmma": cfg.max_steps * cfg.num_blocks, "flash_attn_bwd_general": 0,
            **dict.fromkeys(_build.DEQUANT_KERNELS, 0)}


class deterministic_cudnn:
    """cudnn.deterministic on inside the block: the patch conv's wgrad then
    runs without atomics, so two runs of one step are bitwise equal."""

    def __init__(self, torch):
        self.backends = torch.backends.cudnn

    def __enter__(self):
        self.prev, self.backends.deterministic = self.backends.deterministic, True

    def __exit__(self, *exc):
        self.backends.deterministic = self.prev


def step_launches(cfg) -> dict:
    """The launches of one steady train step at N <= 2048, rate 0."""
    from vitax_torch.ops import _build
    n = cfg.num_blocks
    return {"flash_attn_fwd": 2 * n, "flash_attn_bwd": n, "fused_adamw": 1, "dequant_matmul": 0,
            "flash_attn_fwd_drop": 0, "flash_attn_bwd_drop": 0, **dict.fromkeys(_build.STREAM_KERNELS, 0),
            "flash_attn_fwd_wgmma": 2 * n, "flash_attn_fwd_general": 0, "flash_attn_bwd_wgmma": n,
            "flash_attn_bwd_general": 0, **dict.fromkeys(_build.DEQUANT_KERNELS, 0)}


# Phase 7's run takes 1 + PROFILE_STEPS more steps after its timed steps 3-12:
# the profiler's warm-up step, then the loop's profiler window (--profile_dir,
# --profile_start_step 13), whose trace replaces the profiled steady step
# earlier versions ran after train().
# Then REMAT_STEPS steps of phase 7's cell with one checkpoint a group of
# REMAT_WINDOW blocks beside per-block remat, from the same seed and batch.
PROFILE_STEPS = 2
REMAT_WINDOW, REMAT_STEPS = 2, 3
WINDOW_KERNELS = (("A1", r"flash_attn_fwd_wgmma_kernel<\d+, false>"), ("A1 other", r"flash_attn_fwd_\w+_kernel"),
                  ("A2 dK/dV", r"bwd_dkdv_wgmma_kernel<\d+, false>"), ("A2 dQ", r"bwd_dq_wgmma_kernel<\d+, false>"),
                  ("A2 other", r"bwd_(dkdv|dq)_\w+_kernel"), ("B", r"fused_adamw_kernel"))


def profile_window(cfg, prof_dir: str, card: str) -> None:
    """The trace phase 7's profiler window wrote (telemetry/profiler.py):
    exactly its steps; per step 2 forwards a block (none_saveable: the
    forward and the recompute), a backward a block (its dK/dV and dQ
    kernels), one B, all wgmma, nothing else of the port's; then the
    window's span, device busy and idle, time by kernel group and the top
    kernels, as profile_device prints a call's."""
    import re
    from vitax_torch.telemetry.profiler import read_trace, window_busy
    steps, kernels = read_trace(os.path.join(prof_dir, "rank0.pt.trace.json"))
    first, n, s = cfg.profile_start_step + 1, cfg.num_blocks, cfg.profile_num_steps
    counts = {}
    for name, pat in WINDOW_KERNELS:        # first match wins, as KERNEL_GROUPS
        counts[name] = 0
    for k in kernels:
        hit = next((name for name, pat in WINDOW_KERNELS if re.search(pat, k["name"])), None)
        if hit is not None:
            counts[hit] += 1
    want = {"A1": 2 * n * s, "A1 other": 0, "A2 dK/dV": n * s, "A2 dQ": n * s, "A2 other": 0, "B": s}
    if steps != list(range(first, first + s)) or counts != want:
        t0 = min(k["ts"] for k in kernels) if kernels else 0.0
        a1 = [round((k["ts"] - t0) / 1e3, 2) for k in kernels if re.search(WINDOW_KERNELS[0][1], k["name"])]
        fail(f"[7 profile] the window holds steps {steps} and kernels {counts}; expected steps "
             f"{list(range(first, first + s))} and {want}; {len(kernels)} kernels, A1's at ms {a1}; the first "
             f"kernels {[k['name'][:40] for k in sorted(kernels, key=lambda k: k['ts'])[:6]]}")
    busy, span = window_busy(kernels)
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    by_name = {}
    for k in kernels:
        ms = k["dur"] / 1e3
        groups[next((g for g, pat in KERNEL_GROUPS if re.search(pat, k["name"])), "other")] += ms
        tot, cnt = by_name.get(k["name"], (0.0, 0))
        by_name[k["name"]] = (tot + ms, cnt + 1)
    say(f"[7 profile] the loop's profiler window, steps {first}-{first + s - 1} (--profile_dir, start "
        f"{cfg.profile_start_step}, {s} steps; one trace, rank0.pt.trace.json): span {span:.2f} ms, device busy "
        f"{busy:.2f} ms (idle {max(0.0, 1 - busy / span) * 100:.1f}%), {busy / s:.2f} ms a step; "
        + ", ".join(f"{g} {v:.2f} ms ({v / busy * 100:.1f}%)" for g, v in groups.items() if v > 0) + f" [{card}]")
    for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        say(f"[7 profile]   {ms:8.3f} ms  x{cnt:<4d} {name[:110]}")
    say(f"[7 train] launches in the window per step: A1 {counts['A1'] // s}, A2 {counts['A2 dK/dV'] // s} (dK/dV "
        f"and dQ kernels each), B {counts['B'] // s}; no other kernel of the port's")


def remat_window_check(torch, card: str) -> None:  # vtx: ignore[VTX103] float(loss) fetches every timed step
    """--remat_window REMAT_WINDOW against per-block remat at phase 7's cell:
    REMAT_STEPS steps of each from seed 0's init on one batch (numpy seed),
    cudnn deterministic: the losses within MODEL_LOSS_REL_TOL of each other,
    the same attention launches, the peak memory of each."""
    from vitax_torch.config import Config
    from vitax_torch.models.vit import build_model
    from vitax_torch.ops import _build
    from vitax_torch.ops.attention import make_attention_impl
    from vitax_torch.train.state import build_optimizer, make_train_state
    from vitax_torch.train.step import make_train_step
    rng = np.random.default_rng(SEED + 30)
    base = dict(TRAIN, max_steps=REMAT_STEPS)
    images = rng.standard_normal((base["batch_size"], 224, 224, 3)).astype(np.float32)
    labels = rng.integers(0, 1000, size=(base["batch_size"],))
    batch = {"image": torch.from_numpy(images).cuda(0), "label": torch.from_numpy(labels).cuda(0)}
    out = {}
    with deterministic_cudnn(torch):
        for w in (0, REMAT_WINDOW):
            cfg = Config(seed=SEED, **base, remat_window=w).validate()
            model = build_model(cfg, "cuda", attention_impl=make_attention_impl(cfg, "cuda")).train()
            optimizer, _ = build_optimizer(cfg, 100)
            state = make_train_state(model, optimizer)
            step = make_train_step(cfg, optimizer, "cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            t0 = time.perf_counter()
            losses = []
            for _ in range(REMAT_STEPS):
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
            out[w] = (losses, {k: _build.LAUNCHES[k] for k in ("flash_attn_fwd", "flash_attn_bwd", "fused_adamw")},
                      torch.cuda.max_memory_allocated() / 1e9, (time.perf_counter() - t0) / REMAT_STEPS)
            del model, optimizer, state, step, metrics
            gc.collect()
            torch.cuda.empty_cache()
    (l0, n0, m0, s0), (l2, n2, m2, s2) = out[0], out[REMAT_WINDOW]
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(l2, l0))
    say(f"[7 remat_window] phase 7's cell, {REMAT_STEPS} steps from one init and batch: --remat_window "
        f"{REMAT_WINDOW} losses " + " ".join(f"{x:.6f}" for x in l2) + ", per-block remat "
        + " ".join(f"{x:.6f}" for x in l0) + f" (largest relative difference {rel:.3g}, bar {MODEL_LOSS_REL_TOL}; "
        f"bitwise {l2 == l0}); launches {n2} and {n0}; max_memory_allocated {m2:.2f} and {m0:.2f} GB; "
        f"{s2:.4f} and {s0:.4f} s a step, the first included [{card}]")
    if rel > MODEL_LOSS_REL_TOL or n2 != n0 or not all(np.isfinite(l2)):
        fail(f"[7 remat_window] losses {l2} against {l0}, launches {n2} against {n0}")


def phase_train(torch, card):
    """The train main path: train() in process at the 10B width, depth 8,
    batch 32, fake data, its last PROFILE_STEPS steps in the loop's
    profiler window (the trace's kernels checked and broken down); the
    fused optimizer checked and timed on the trained state; then the
    --remat_window check. Returns (launches,
    (max |d| of B on the state's table, timing of B), the first loss,
    (sec/iter, MFU))."""
    from vitax_torch.config import Config
    from vitax_torch.models.vit import expected_param_count
    from vitax_torch.ops import _build
    from vitax_torch.telemetry.flops import model_flops_per_step, peak_tflops
    from vitax_torch.train.loop import train

    timed = TRAIN["max_steps"]
    prof_dir = tempfile.mkdtemp(prefix="vitax_torch_7prof_")
    cfg = Config(seed=SEED, **dict(TRAIN, max_steps=timed + 1 + PROFILE_STEPS), profile_dir=prof_dir,
                 profile_start_step=timed + 1, profile_num_steps=PROFILE_STEPS).validate()
    records = []
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    state = train(cfg, "cuda", records=records)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps = [r for r in records if "loss" in r]
    evals = [r for r in records if "top1" in r]
    losses = [r["loss"] for r in steps]
    if len(steps) != cfg.max_steps or len(evals) != 1:
        fail(f"train() logged {len(steps)} steps and {len(evals)} evals; expected {cfg.max_steps} and 1")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"training losses not finite and falling: {losses}")
    n_params = expected_param_count(cfg)
    if sum(p.numel() for p in state.model.parameters()) != n_params:
        fail("the trained model does not have the expected parameter count")
    want = train_run_launches(cfg)
    if launches != want:
        fail(f"train() launched {launches}; expected {want}")
    times = [r["step_seconds"] for r in steps[2:timed]]     # steps 3 to 12, before the profiler window
    sec_per_iter = float(np.median(times))
    peak = peak_tflops(torch.cuda.get_device_name(0))
    mfu = (model_flops_per_step(cfg) / sec_per_iter / (peak * 1e12)) if peak else None
    say(f"[7 train] 10B width, depth {cfg.num_blocks} ({n_params:,} params, {16 * n_params / 1e9:.1f} GB "
        f"of f32 params, grads and AdamW moments), batch {cfg.batch_size}, bf16 compute, grad_ckpt "
        f"{cfg.grad_ckpt}: {cfg.max_steps} steps (step {timed + 1} the profiler's warm-up, the last "
        f"{PROFILE_STEPS} its window) + eval in {wall:.1f}s")
    say(f"[7 train] losses " + " ".join(f"{x:.4f}" for x in losses) + f"; grad_norm first "
        f"{steps[0]['grad_norm']:.4f} last {steps[-1]['grad_norm']:.4f}; eval top1 {evals[0]['top1']:.4f}")
    say(f"[7 train] sec/iter median of steps 3-12 {sec_per_iter:.4f} s (min {min(times):.4f}, max "
        f"{max(times):.4f}); {cfg.batch_size / sec_per_iter:.2f} images/s; MFU "
        + (f"{mfu * 100:.2f}% of {peak:.0f} TFLOP/s bf16" if mfu is not None else "not measured (no peak for this card)")
        + f" ({model_flops_per_step(cfg) / 1e12:.2f} TFLOP a step); max_memory_allocated {peak_gb:.2f} GB; "
        f"launches {launches} [{card}]")

    profile_window(cfg, prof_dir, card)
    shutil.rmtree(prof_dir, ignore_errors=True)
    rules_train(torch, card, cfg, state)
    timing = time_fused_adamw(torch, state, card)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    remat_window_check(torch, card)
    ref = {"sec": sec_per_iter, "mfu": mfu, "peak_gb": peak_gb, "losses": losses,
           "norms": [r["grad_norm"] for r in steps]}
    return launches, timing, losses[0], (sec_per_iter, mfu), ref


def read_jsonl(path: str):
    """(step records, events by kind) of a telemetry JSONL."""
    with open(path) as f:
        records = [json.loads(line) for line in f]
    events = {}
    for r in records:
        if "kind" in r:
            events.setdefault(r["kind"], []).append(r)
    return [r for r in records if "kind" not in r], events


def metrics_report(path: str) -> dict:
    """tools/metrics_report.py --json over `path`, in a process of its own."""
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools", "metrics_report.py"), path, "--json"],
                       capture_output=True, text=True, timeout=120)
    if r.returncode != 0:
        fail(f"tools/metrics_report.py {path} exited {r.returncode}: {r.stderr[-2000:]}")
    return json.loads(r.stdout)


def phase_train_telemetry(torch, card, b_ms: float, torchrun: dict) -> dict:
    """Phase 7t (see the module docstring): phase 7's run with telemetry off
    and on, then the check of the CLI under torchrun, which ran beside
    phase 6f (`torchrun`, start_torchrun). `b_ms` is phase 7's CUDA-event
    time of the fused optimizer. Returns the launches of the two train()
    runs, each read around its run."""
    from vitax_torch.config import Config
    from vitax_torch.ops import _build
    from vitax_torch.telemetry import REQUIRED_STEP_KEYS
    from vitax_torch.telemetry.flops import mfu, peak_tflops
    from vitax_torch.train.loop import train

    total = {}
    runs = {}
    with tempfile.TemporaryDirectory(prefix="vitax_torch_7t_") as root:
        for arm in ("off", "on"):
            cfg = Config(seed=SEED, **TRAIN, metrics_dir=os.path.join(root, "metrics") if arm == "on" else ""
                         ).validate()
            records = []
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            state = train(cfg, "cuda", records=records)
            torch.cuda.synchronize()
            launches = dict(_build.LAUNCHES)
            peak_bytes = torch.cuda.max_memory_allocated()
            del state
            gc.collect()
            torch.cuda.empty_cache()
            if launches != train_run_launches(cfg):
                fail(f"[7t] telemetry {arm}: train() launched {launches}; expected {train_run_launches(cfg)}")
            total = {k: total.get(k, 0) + v for k, v in launches.items()}
            steps = [r for r in records if "loss" in r]
            runs[arm] = {"sec": float(np.median([r["step_seconds"] for r in steps[2:]])), "peak": peak_bytes,
                         "losses": [r["loss"] for r in steps]}
        path = os.path.join(root, "metrics", "metrics.jsonl")
        steps, events = read_jsonl(path)
        peak = peak_tflops(torch.cuda.get_device_name(0))
        bad = [r["step"] for r in steps if not set(REQUIRED_STEP_KEYS) <= set(r)
               or not np.isclose(r["mfu"], mfu(cfg, r["sec_per_iter"], 1, peak), rtol=1e-12, atol=0)
               or not 0 < r.get("mem_peak_bytes", 0) <= runs["on"]["peak"]]
        if [r["step"] for r in steps] != list(range(1, cfg.max_steps + 1)) or bad:
            fail(f"[7t] the JSONL's step records are steps {[r['step'] for r in steps]}, {bad} of them without "
                 f"the required keys, with an MFU not flops.mfu's or a memory peak above the run's")
        start = events.get("run_start", [{}])[0]
        if (start.get("device_kind"), start.get("peak_tflops"), start.get("n_devices")) != (
                torch.cuda.get_device_name(0), 989.0, 1) or len(events.get("eval", [])) != 1:
            fail(f"[7t] run_start {start} and {len(events.get('eval', []))} eval events; expected the card's name, "
                 f"peak 989, one device and one eval")
        if runs["on"]["losses"] != [r["loss"] for r in steps]:
            fail("[7t] the JSONL's losses are not the run's")
        summary = metrics_report(path)
        if summary["thread_crashes"] or summary["records"] != cfg.max_steps:
            fail(f"[7t] metrics_report: {summary['records']} records, {summary['thread_crashes']} thread crashes")
        opt_s = float(np.median([r["opt_update_s"] for r in steps[2:]]))
        ratio = runs["on"]["sec"] / runs["off"]["sec"]
        say(f"[7t telemetry] phase 7's run (12 steps + eval): sec/iter median of steps 3-12 off "
            f"{runs['off']['sec']:.4f} s, on {runs['on']['sec']:.4f} s, on/off {ratio:.4f}; launches equal in both "
            f"(16 A1, 8 A2, 1 B a step, all wgmma); losses off {runs['off']['losses'][-1]:.4f} on "
            f"{runs['on']['losses'][-1]:.4f} at step 12 [{card}]")
        say(f"[7t telemetry] JSONL: 12 step records (steps 1-12, the required keys, MFU flops.mfu of each "
            f"sec/iter: median {np.median([r['mfu'] for r in steps[2:]]) * 100:.2f}%), mem_peak_bytes at most "
            f"{max(r['mem_peak_bytes'] for r in steps) / 1e9:.2f} GB (run peak {runs['on']['peak'] / 1e9:.2f} GB), "
            f"run_start {start['device_kind']!r} peak {start['peak_tflops']:.0f} n_devices {start['n_devices']}, "
            f"eval top1 {events['eval'][0]['top1']:.4f}; metrics_report --json: records {summary['records']}, "
            f"thread_crashes {summary['thread_crashes']}, sec_per_iter_p50 {summary['sec_per_iter_p50']}")
        say(f"[7t telemetry] opt_update_s median of steps 3-12 {opt_s * 1e3:.3f} ms (global norm + fused_adamw, "
            f"CUDA events around the log step's update) beside phase 7's fused_adamw alone {b_ms:.3f} ms [{card}]")
    finish_torchrun(torchrun, card)
    return total


def start_torchrun() -> dict:
    """Start the CLI under torchrun at the 10B width, depth 2, 3 steps and
    an eval, with --metrics_dir (phase 7t's check, finish_torchrun), in a
    directory of its own; a thread notes its wall time when it exits."""
    root = tempfile.mkdtemp(prefix="vitax_torch_7t_torchrun_")
    metrics_dir = os.path.join(root, "metrics")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "vitax_torch.train", "--fake_data", "--num_blocks", "2", "--batch_size", "32", "--max_steps", "3",
           "--warmup_steps", "4", "--log_step_interval", "1", "--eval_max_batches", "1", "--test_epoch_interval",
           "1", "--metrics_dir", metrics_dir, "--ckpt_dir", os.path.join(root, "ckpt")]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = {"root": root, "metrics": metrics_dir, "log": os.path.join(root, "torchrun.log"), "t0": time.perf_counter()}
    with open(run["log"], "w") as log:
        run["proc"] = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
                                       start_new_session=True)

    def note_exit() -> None:
        run["proc"].wait()
        run["wall"] = time.perf_counter() - run["t0"]
    threading.Thread(  # vtx: ignore[VTX205] ends with the torchrun, which finish_torchrun waits for or kills
        target=note_exit, daemon=True, name="7t-torchrun").start()
    return run


def finish_torchrun(run: dict, card: str) -> None:
    """Phase 7t's torchrun (started beside phase 6f, start_torchrun):
    through the named barriers, the one-rank NCCL group and
    orderly_shutdown to exit 0, its JSONL written."""
    try:
        rc = run["proc"].wait(timeout=600)
        with open(run["log"]) as f:
            out = f.read()
        if rc != 0 or "training begins" not in out:
            fail(f"[7t] torchrun exited {rc}:\n{out[-6000:]}")
        steps, events = read_jsonl(os.path.join(run["metrics"], "metrics.jsonl"))
        if [s["step"] for s in steps] != [1, 2, 3] or [e["n_devices"] for e in events.get("run_start", [])] != [1]:
            fail(f"[7t] torchrun's JSONL holds steps {[s['step'] for s in steps]} and run_start "
                 f"{events.get('run_start')}")
        while "wall" not in run:
            time.sleep(0.05)
        say(f"[7t torchrun] torchrun --nproc_per_node 1 -m vitax_torch.train (depth 2, batch 32, 3 steps + eval, "
            f"--metrics_dir), started beside 6f's crash drill and 7a's start: exit 0 in {run['wall']:.1f} s through "
            f"the barriers and orderly_shutdown; JSONL steps 1-3, losses " + " ".join(f"{s['loss']:.4f}" for s in steps)
            + f", mem: {steps[-1].get('mem_peak_bytes', 0) / 1e9:.2f} GB peak [{card}]")
    finally:
        shutil.rmtree(run["root"], ignore_errors=True)


def phase_train_dropout(torch, card, first_loss_rate0: float):
    """Phase 7's run with att_dropout and mlp_dropout 0.1 from the same
    init and data: exact launch totals (per step, each block's dropout
    forward and its recompute, its dropout backward; the eval's rate-0
    forwards), a first loss other than phase 7's, one step's loss and grad
    norm computed twice from the same state and seeds on a seeded batch,
    bitwise equal (and not at the next step's seeds), sec/iter, images/s,
    MFU, peak memory, and a profile of one steady step. Returns the
    launches."""
    import torch.nn.functional as F
    from vitax_torch.config import Config
    from vitax_torch.ops import _build
    from vitax_torch.ops.fused_optimizer import global_norm
    from vitax_torch.telemetry.flops import model_flops_per_step, peak_tflops
    from vitax_torch.train.loop import train
    from vitax_torch.train.state import build_optimizer
    from vitax_torch.train.step import dropout_seeds, make_train_step

    cfg = Config(seed=SEED, **TRAIN_DROPOUT).validate()
    records = []
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    state = train(cfg, "cuda", records=records)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = [r for r in records if "loss" in r]
    losses = [r["loss"] for r in steps]
    if len(steps) != cfg.max_steps or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train() under dropout logged {len(steps)} steps, losses {losses}; expected {cfg.max_steps} "
             f"finite and falling")
    if losses[0] == first_loss_rate0:
        fail(f"the first loss under dropout {losses[0]} equals the rate-0 run's: the masks did nothing")
    n = cfg.num_blocks
    want = {"flash_attn_fwd": cfg.eval_max_batches * n, "flash_attn_fwd_drop": cfg.max_steps * 2 * n,
            "flash_attn_bwd": 0, "flash_attn_bwd_drop": cfg.max_steps * n, "fused_adamw": cfg.max_steps,
            "dequant_matmul": 0, **dict.fromkeys(_build.STREAM_KERNELS, 0),
            "flash_attn_fwd_wgmma": cfg.eval_max_batches * n + cfg.max_steps * 2 * n, "flash_attn_fwd_general": 0,
            "flash_attn_bwd_wgmma": cfg.max_steps * n, "flash_attn_bwd_general": 0,
            **dict.fromkeys(_build.DEQUANT_KERNELS, 0)}
    if launches != want:
        fail(f"train() under dropout launched {launches}; expected {want}")
    times = [r["step_seconds"] for r in steps[2:]]
    sec_per_iter = float(np.median(times))
    peak = peak_tflops(torch.cuda.get_device_name(0))
    mfu = (model_flops_per_step(cfg) / sec_per_iter / (peak * 1e12)) if peak else None
    say(f"[7d train] 10B width, depth {n}, batch {cfg.batch_size}, att_dropout {cfg.att_dropout}, mlp_dropout "
        f"{cfg.mlp_dropout}: {cfg.max_steps} steps + eval in {wall:.1f}s; losses "
        + " ".join(f"{x:.4f}" for x in losses) + f" (rate-0 run's first {first_loss_rate0:.6f}, this run's "
        f"{losses[0]:.6f}); grad_norm first {steps[0]['grad_norm']:.4f} last {steps[-1]['grad_norm']:.4f}")
    say(f"[7d train] sec/iter median of steps 3-12 {sec_per_iter:.4f} s (min {min(times):.4f}, max "
        f"{max(times):.4f}); {cfg.batch_size / sec_per_iter:.2f} images/s; MFU "
        + (f"{mfu * 100:.2f}% of {peak:.0f} TFLOP/s bf16" if mfu is not None else "not measured (no peak for this card)")
        + f"; max_memory_allocated {peak_gb:.2f} GB; launches {launches} [{card}]")

    # one step's loss and grad norm, twice at the same seeds: bitwise equal
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    x = torch.randn((cfg.batch_size, cfg.image_size, cfg.image_size, 3), generator=gen, device="cuda")
    labels = torch.randint(0, cfg.num_classes, (cfg.batch_size,), generator=gen, device="cuda")
    model = state.model

    def loss_and_norm(seeds):
        model.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x, seeds).float(), labels)
        loss.backward()
        return loss.detach(), global_norm([p.grad for p in model.parameters()])

    with deterministic_cudnn(torch):
        runs = [loss_and_norm(dropout_seeds(cfg, s, 0)) for s in (cfg.max_steps, cfg.max_steps, cfg.max_steps + 1)]
    same = torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    moved = not torch.equal(runs[0][0], runs[2][0])
    say(f"[7d check] one step from the same state and seeds, twice: loss {runs[0][0].item():.9g} / "
        f"{runs[1][0].item():.9g}, grad norm {runs[0][1].item():.9g} / {runs[1][1].item():.9g}, bitwise equal "
        f"{same}; the next step's seeds: loss {runs[2][0].item():.9g} {'ok' if same and moved else 'FAIL'}")
    if not (same and moved):
        fail("a step repeated from the same state and seeds is not bitwise equal, or other seeds change nothing")
    del runs, x, labels

    optimizer, _ = build_optimizer(cfg, 100)
    train_step = make_train_step(cfg, optimizer, "cuda")
    batch = {"image": torch.zeros((cfg.batch_size, cfg.image_size, cfg.image_size, 3), device="cuda"),
             "label": torch.zeros(cfg.batch_size, dtype=torch.int64, device="cuda")}
    _build.reset_launches()
    profile_device(torch, lambda: train_step(state, batch), f"one train step under dropout (batch "
                   f"{cfg.batch_size}, depth {n})", card, "7d", top=14)
    per_step = {k: v // 2 for k, v in _build.LAUNCHES.items()}
    want_step = {"flash_attn_fwd": 0, "flash_attn_fwd_drop": 2 * n, "flash_attn_bwd": 0, "flash_attn_bwd_drop": n,
                 "fused_adamw": 1, "dequant_matmul": 0, **dict.fromkeys(_build.STREAM_KERNELS, 0),
                 "flash_attn_fwd_wgmma": 2 * n, "flash_attn_fwd_general": 0, "flash_attn_bwd_wgmma": n,
                 "flash_attn_bwd_general": 0, **dict.fromkeys(_build.DEQUANT_KERNELS, 0)}
    if per_step != want_step or any(v % 2 for v in _build.LAUNCHES.values()):
        fail(f"two steady train steps under dropout launched {dict(_build.LAUNCHES)}; expected {want_step} a step")
    say(f"[7d train] launches per steady step {per_step}")
    del train_step, batch, state, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_long(torch, card):
    """Phase 7L: the long-context train path, train() at the JAX ladder's
    shape (ViT-L width, 4 blocks, batch 2, fake data, 8 steps and a 1-batch
    eval) at N 4096 and 9216, N 4096 under att_dropout 0.1 and N 9216 under
    dots_attn_saveable: each run's launches checked against its steps (per
    step 2 attention forwards a block, a forward and its recompute, or 1
    under dots_attn_saveable, and 1 backward a block, all through the
    streaming keys; the whole-N keys at 0), sec/iter, images/s, MFU, peak
    memory, and a profile of one steady step. Returns the launches summed
    over the runs."""
    from vitax_torch.config import Config
    from vitax_torch.ops import _build
    from vitax_torch.telemetry.flops import model_flops_per_step, peak_tflops
    from vitax_torch.train.loop import train
    from vitax_torch.train.state import build_optimizer
    from vitax_torch.train.step import make_train_step

    total = {}
    peak = peak_tflops(torch.cuda.get_device_name(0))
    for label, over in LONG_RUNS:
        cfg = Config(seed=SEED, **TRAIN_LONG, **over).validate()
        records = []
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        state = train(cfg, "cuda", records=records)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = [r for r in records if "loss" in r]
        losses = [r["loss"] for r in steps]
        if len(steps) != cfg.max_steps or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"7L {label}: train() logged {len(steps)} steps, losses {losses}; expected {cfg.max_steps} finite "
                 f"and falling")
        n_blk = cfg.num_blocks
        fwd_per_block = 1 if cfg.remat_policy == "dots_attn_saveable" else 2
        drop = cfg.att_dropout > 0
        per_step = {k: 0 for k in _build.LAUNCHES}
        per_step["flash_attn_fwd_stream_drop" if drop else "flash_attn_fwd_stream"] = fwd_per_block * n_blk
        per_step["flash_attn_bwd_stream_drop" if drop else "flash_attn_bwd_stream"] = n_blk
        per_step["fused_adamw"] = 1
        per_step["flash_attn_fwd_wgmma"] = fwd_per_block * n_blk           # every forward on the wgmma kernel
        per_step["flash_attn_bwd_wgmma"] = n_blk                           # every backward on the wgmma kernels
        want = {k: v * cfg.max_steps for k, v in per_step.items()}
        for key in ("flash_attn_fwd_stream", "flash_attn_fwd_wgmma"):
            want[key] += cfg.eval_max_batches * n_blk                       # the eval: rate 0, no recompute
        if launches != want:
            fail(f"7L {label}: train() launched {launches}; expected {want}")
        times = [r["step_seconds"] for r in steps[2:]]
        sec_per_iter = float(np.median(times))
        mfu = (model_flops_per_step(cfg) / sec_per_iter / (peak * 1e12)) if peak else None
        say(f"[7L train] {label}: ViT-L width (D {cfg.embed_dim}, {cfg.num_heads} heads), depth {n_blk}, batch "
            f"{cfg.batch_size}, image {cfg.image_size}, N {cfg.num_patches}, attention "
            f"{state.model.blocks[0].attn.attention_impl.vitax_name}, remat {cfg.remat_policy}: {cfg.max_steps} "
            f"steps + eval in {wall:.1f}s; losses " + " ".join(f"{x:.4f}" for x in losses))
        say(f"[7L train] {label}: sec/iter median of steps 3-{cfg.max_steps} {sec_per_iter:.4f} s (min "
            f"{min(times):.4f}, max {max(times):.4f}); {cfg.batch_size / sec_per_iter:.2f} images/s; MFU "
            + (f"{mfu * 100:.2f}% of {peak:.0f} TFLOP/s bf16" if mfu is not None else "not measured (no peak)")
            + f" ({model_flops_per_step(cfg) / 1e12:.3f} TFLOP a step, the N^2 attention counted); "
            f"max_memory_allocated {peak_gb:.2f} GB; launches {launches} [{card}]")

        optimizer, _ = build_optimizer(cfg, 100)
        train_step = make_train_step(cfg, optimizer, "cuda")
        batch = {"image": torch.zeros((cfg.batch_size, cfg.image_size, cfg.image_size, 3), device="cuda"),
                 "label": torch.zeros(cfg.batch_size, dtype=torch.int64, device="cuda")}
        _build.reset_launches()
        profile_device(torch, lambda: train_step(state, batch), f"{label}: one train step", card, "7L", top=10)
        got = {k: v // 2 for k, v in _build.LAUNCHES.items()}          # a warm step, then the profiled one
        if got != per_step or any(v % 2 for v in _build.LAUNCHES.values()):
            fail(f"7L {label}: two steady train steps launched {dict(_build.LAUNCHES)}; expected {per_step} a step")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        del state, train_step, batch
        gc.collect()
        torch.cuda.empty_cache()
    return total

# --- phases 6 (JPEG bodies), 7i, 7s and the loader alone: real images ---------

def jpeg_body(rng, w: int, h: int, colour) -> bytes:
    """A JPEG (quality 90) of a colour field with stripes and noise, as PIL writes it."""
    import io
    from PIL import Image
    fx, fy = rng.uniform(2, 12, 2)
    x = np.sin(np.linspace(0, fx * np.pi, w, dtype=np.float32))[None, :, None]
    y = np.cos(np.linspace(0, fy * np.pi, h, dtype=np.float32))[:, None, None]
    arr = np.asarray(colour, np.float32) + 50 * x + 40 * y + rng.integers(-20, 21, (h, w, 3))
    buf = io.BytesIO()
    Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


def native_choice(phase: str):
    """(use_native, why): the native decoder where g++ finds libjpeg's
    header here (a failed build then fails the run), else the PIL path,
    asked for by name with the reason printed."""
    from vitax_torch import _native
    from vitax_torch.data import native
    reason = _native.missing_toolchain()
    if reason:
        say(f"[{phase} data] the native JPEG decoder cannot be built on this machine ({reason}); the PIL path is "
            f"asked for by name (use_native=False)")
        return False, f"PIL by request: {reason}"
    if not native.available():
        fail(f"the native JPEG decoder failed to build: {_native.unavailable_reason()}")
    return True, "native"


def serve_jpegs(url: str, ctx, cfg) -> dict:
    """Phase 6's JPEG bodies, one a thread, after the counted traffic: every
    answer checked, and every body counted under the decode path the
    server's data says it must take (native where it builds, else PIL)."""
    rng = np.random.default_rng(SEED + 6)
    sizes = [(int(w), int(h)) for w, h in rng.integers(180, 641, (SERVE_JPEGS, 2))]
    bodies = [jpeg_body(rng, w, h, rng.integers(30, 226, 3)) for w, h in sizes]
    before = ctx.decoded.snapshot()
    answers, lat, errors = [None] * len(bodies), np.zeros(len(bodies)), []

    def client(i: int) -> None:
        t = time.perf_counter()
        try:
            answers[i] = http(url + "/predict", bodies[i], "image/jpeg")
        except Exception as e:  # noqa: BLE001 - reported below, the run fails
            errors.append(f"JPEG request {i}: {e!r}")
        lat[i] = time.perf_counter() - t

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f"6 jpeg: requests failed: {errors[:4]}")
    for ans in answers:
        check_answer(ans, cfg.serve_topk, cfg.num_classes)
    after = ctx.decoded.snapshot()
    decoded = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    from vitax_torch.data import native
    use_native = native.available()
    want_path = "native" if use_native else "pil"
    if decoded.get(want_path, 0) != len(bodies) or sum(decoded.get(k, 0) for k in ("native", "pil", "ppm")) != len(
            bodies):
        fail(f"6 jpeg: {len(bodies)} JPEG bodies decoded {decoded}; every one must take the {want_path} path")
    from vitax_torch import _native
    why = "the native decoder" if use_native else f"PIL: no native decoder here, {_native.unavailable_reason()}"
    return {"sizes": ", ".join(f"{w}x{h}" for w, h in sizes), "decoded": decoded, "why": why, "lat": lat,
            "wall": wall}


def write_tree(root: str) -> dict:
    """The ImageFolder tree of phases 7i and 7s, written with PIL: train 8
    classes x 64 JPEGs of 180-640 px a side (quality 90, each class its own
    colour under stripes and noise) and 4 PNGs; val 8 x 8 JPEGs."""
    from PIL import Image
    rng = np.random.default_rng(SEED + 70)
    palette = rng.integers(30, 226, (DATA_CLASSES, 3))
    t0 = time.perf_counter()
    nbytes = 0
    for split, per_class in (("train", DATA_TRAIN_PER_CLASS), ("val", DATA_VAL_PER_CLASS)):
        for c in range(DATA_CLASSES):
            d = os.path.join(root, split, f"class_{c:02d}")
            os.makedirs(d, exist_ok=True)
            for i in range(per_class):
                w, h = (int(v) for v in rng.integers(180, 641, 2))
                body = jpeg_body(rng, w, h, palette[c])
                nbytes += len(body)
                with open(os.path.join(d, f"{i:03d}.jpg"), "wb") as f:
                    f.write(body)
    for k in range(DATA_PNGS):
        w, h = (int(v) for v in rng.integers(180, 641, 2))
        arr = np.clip(palette[k] + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(root, "train", f"class_{k:02d}", f"zz_{k}.png"))
    n_train = DATA_CLASSES * DATA_TRAIN_PER_CLASS + DATA_PNGS
    say(f"[7i data] tree: train {n_train} images ({DATA_CLASSES} classes x {DATA_TRAIN_PER_CLASS} JPEGs + "
        f"{DATA_PNGS} PNGs), val {DATA_CLASSES * DATA_VAL_PER_CLASS} JPEGs, {nbytes / 1e6:.1f} MB of JPEG, "
        f"written in {time.perf_counter() - t0:.1f}s")
    return {"train": n_train, "val": DATA_CLASSES * DATA_VAL_PER_CLASS}


class FirstBatch:
    """A loader that keeps a host copy of the first batch it delivers and
    passes everything else through."""

    def __init__(self, loader):
        self.loader = loader
        self.first = None

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def epoch(self, epoch: int, start_step: int = 0):
        for batch in self.loader.epoch(epoch, start_step):
            if self.first is None:
                self.first = {k: v.cpu() for k, v in batch.items()}
            yield batch


def check_decoded(phase: str, c: dict, use_native: bool, batch: int, at_least: int) -> dict:
    """A dataset's decode counts say every JPEG took the asked-for path, in whole batches."""
    total = c["native"] + c["pil"]
    ok = (c["pil_jpeg"] == 0 and c["native"] > 0) if use_native else c["native"] == 0
    if not ok or total % batch or total < at_least:
        fail(f"{phase}: the dataset decoded {c}; expected every JPEG through the "
             f"{'native' if use_native else 'PIL'} path, whole batches of {batch}, at least {at_least} items")
    return c


def train_from_data(torch, cfg, data, phase: str, card: str):
    """train() on the card from `data` (build_datasets' tuple), its launches
    checked against its steps as in phase 7; then three steady steps fed by
    the same loader, profiled. Returns (state, the first batch delivered,
    launches, {"sec", "mfu", "wait", "idle"})."""
    from vitax_torch.ops import _build
    from vitax_torch.telemetry.flops import model_flops_per_step, peak_tflops
    from vitax_torch.train.loop import train
    from vitax_torch.train.state import build_optimizer
    from vitax_torch.train.step import make_train_step
    train_ds, train_loader, val_ds, val_loader = data
    tap = FirstBatch(train_loader)
    records = []
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    state = train(cfg, "cuda", records=records, data=(train_ds, tap, val_ds, val_loader))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = [r for r in records if "loss" in r]
    evals = [r for r in records if "top1" in r]
    losses = [r["loss"] for r in steps]
    if len(steps) != cfg.max_steps or len(evals) != 1 or not all(np.isfinite(losses)):
        fail(f"{phase}: train() logged {len(steps)} steps, {len(evals)} evals, losses {losses}; expected "
             f"{cfg.max_steps} finite and 1")
    want = train_run_launches(cfg)
    if launches != want:
        fail(f"{phase}: train() launched {launches}; expected {want}")
    times = [r["step_seconds"] for r in steps[2:]]
    waits = [r["data_wait_s"] for r in steps[2:]]
    sec = float(np.median(times))
    peak = peak_tflops(torch.cuda.get_device_name(0))
    mfu = (model_flops_per_step(cfg) / sec / (peak * 1e12)) if peak else None
    say(f"[{phase} train] {train_ds!r}: 10B width, depth {cfg.num_blocks}, batch {cfg.batch_size}, "
        f"{cfg.max_steps} steps + eval in {wall:.1f}s; losses " + " ".join(f"{x:.4f}" for x in losses)
        + f"; eval top1 {evals[0]['top1']:.4f}")
    say(f"[{phase} train] sec/iter median of steps 3-{cfg.max_steps} {sec:.4f} s (min {min(times):.4f}, max "
        f"{max(times):.4f}); {cfg.batch_size / sec:.2f} images/s; MFU "
        + (f"{mfu * 100:.2f}% of {peak:.0f} TFLOP/s bf16" if mfu is not None else "not measured (no peak)")
        + f"; data_wait_s a step median {float(np.median(waits)):.4f} (max {max(waits):.4f}); max_memory_allocated "
        f"{peak_gb:.2f} GB; launches {launches} [{card}]")
    decoded = train_ds.decoded.snapshot()
    optimizer, _ = build_optimizer(cfg, 100)
    train_step = make_train_step(cfg, optimizer, "cuda")
    it = train_loader.epoch(2)
    next(it)                                   # the queue fills behind the first batch
    train_loader.consume_wait_s()
    wall_ms, busy_ms = profile_device(torch, lambda: [train_step(state, next(it)) for _ in range(3)],
                                      f"three steps fed by the loader (batch {cfg.batch_size}, depth "
                                      f"{cfg.num_blocks})", card, phase, top=6)
    it.close()
    wait = train_loader.consume_wait_s() / 6
    idle = max(0.0, 1 - busy_ms / wall_ms)
    say(f"[{phase} train] loader-fed window: device idle {idle * 100:.1f}% of {wall_ms:.2f} ms, data_wait_s a "
        f"step {wait:.4f} [{card}]")
    fed, resident = steps_in_turns(torch, train_step, state, train_loader)
    say(f"[{phase} train] in turns, {TURNS} rounds of {TURN_STEPS} steps, each step's loss fetched as train() "
        f"does: fed by the loader {np.median(fed):.4f} s a step ({', '.join(f'{x:.4f}' for x in fed)}), one "
        f"batch resident on the card {np.median(resident):.4f} ({', '.join(f'{x:.4f}' for x in resident)}): "
        f"{np.median(fed) / np.median(resident):.3f}x [{card}]")
    del train_step
    return state, tap.first, launches, {"sec": sec, "mfu": mfu, "wait": float(np.median(waits)), "idle": idle,
                                        "decoded": decoded}


def steps_in_turns(torch, train_step, state, loader):  # vtx: ignore[VTX103] float(loss) fetches every timed step
    """Steps fed by the loader against steps on one batch already on the
    card, in alternating rounds (so a drift of the card's speed hits both
    arms alike), each step's loss fetched as train() does at
    log_step_interval 1. Returns (fed, resident) seconds a step per round."""
    if loader.steps_per_epoch < 1 + TURNS * TURN_STEPS:
        fail(f"an epoch of {loader.steps_per_epoch} batches is too short for {TURNS} rounds of {TURN_STEPS} steps")
    it = loader.epoch(3)
    resident = next(it)
    times = {"fed": [], "resident": []}
    for r in range(TURNS):
        for arm in (("fed", "resident") if r % 2 == 0 else ("resident", "fed")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TURN_STEPS):
                _, metrics = train_step(state, next(it) if arm == "fed" else resident)
                float(metrics["loss"])
            times[arm].append((time.perf_counter() - t0) / TURN_STEPS)
    it.close()
    return times["fed"], times["resident"]


def phase_train_tree(torch, card, root: str, fake: tuple):
    """Phase 7i: phase 7's run (10B width, depth 8, batch 32, 12 steps, a
    2-batch eval) from the ImageFolder tree, device_normalize on. Checks
    its launches, finite losses, the decode counts, and the first batch
    the loader delivered against the dataset's load_batch of the sampler's
    first row, bitwise. Returns (launches, use_native)."""
    from vitax_torch.config import Config
    from vitax_torch.data.loader import build_datasets
    use_native, why = native_choice("7i")
    cfg = Config(seed=SEED, **TRAIN_TREE, data_dir=os.path.join(root, "tree")).validate()
    data = build_datasets(cfg, "cuda", use_native=use_native)
    train_ds, train_loader, val_ds, _ = data
    state, first, launches, m = train_from_data(torch, cfg, data, "7i", card)
    c = check_decoded("7i", m["decoded"], use_native, cfg.batch_size, cfg.max_steps * cfg.batch_size)
    v = check_decoded("7i val", val_ds.decoded.snapshot(), use_native, cfg.batch_size,
                      cfg.eval_max_batches * cfg.batch_size)
    row = train_loader.sampler.epoch_indices(1)[0]
    train_ds.set_epoch(1)
    want_img, want_lbl = train_ds.load_batch(row, cfg.num_workers)
    same = (first["image"].dtype == torch.uint8 and np.array_equal(first["image"].numpy(), want_img)
            and np.array_equal(first["label"].numpy(), want_lbl))
    say(f"[7i check] decode path {why}: train {c}, val {v}; the first batch delivered "
        f"({tuple(first['image'].shape)} {first['image'].dtype}) equals load_batch of the sampler's first row "
        f"bitwise: {same}")
    if not same:
        fail("7i: the first batch the loader delivered differs from the dataset's load_batch of the same row")
    sec7, mfu7 = fake
    say(f"[7i train] from the tree against phase 7's fake data: sec/iter {m['sec']:.4f} / {sec7:.4f} "
        f"({m['sec'] / sec7:.3f}x), images/s {cfg.batch_size / m['sec']:.2f} / {cfg.batch_size / sec7:.2f}, MFU "
        + (f"{m['mfu'] * 100:.2f}% / {mfu7 * 100:.2f}%" if m["mfu"] and mfu7 else "not measured")
        + f"; data_wait_s a step {m['wait']:.4f} [{card}]")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return launches, use_native


def phase_train_stream(torch, card, root: str, use_native: bool):
    """Phase 7s: the same tree packed with the port's make_shards; on the
    host, the stream dataset's batch for the sampler's first row equals the
    ImageFolder dataset's for the same global ids, bitwise; then train()
    with --data_format stream at the 10B width, depth 2, 8 steps, its
    launches, decode counts and first batch checked. Returns the launches."""
    from vitax_torch.config import Config
    from vitax_torch.data.imagefolder import ImageFolderDataset
    from vitax_torch.data.loader import build_datasets
    from vitax_torch.data.transforms import TrainTransform
    from vitax_torch.tools.make_shards import pack_split
    t0 = time.perf_counter()
    metas = {split: pack_split(os.path.join(root, "tree", split), os.path.join(root, "shards", split), quiet=True)
             for split in ("train", "val")}
    say(f"[7s data] packed with vitax_torch.tools.make_shards in {time.perf_counter() - t0:.2f}s: "
        + ", ".join(f"{k} {m['num_records']} records in {len(m['shards'])} shard(s)" for k, m in metas.items()))
    cfg = Config(seed=SEED, **TRAIN_STREAM, data_dir=os.path.join(root, "shards")).validate()
    data = build_datasets(cfg, "cuda", use_native=use_native)
    train_ds, train_loader, val_ds, _ = data
    folder = ImageFolderDataset(os.path.join(root, "tree", "train"), TrainTransform(cfg.image_size, cfg.seed),
                                use_native=use_native)
    sampler = train_loader.sampler
    entries = [(int(s), int(r), sampler.global_id(s, r)) for s, r in sampler.epoch_entries(1)[0]]
    train_ds.set_epoch(1)
    folder.set_epoch(1)
    s_img, s_lbl = train_ds.load_entries(entries, cfg.num_workers)
    f_img, f_lbl = folder.load_batch([g for _, _, g in entries], cfg.num_workers)
    same_host = np.array_equal(s_img, f_img) and np.array_equal(s_lbl, f_lbl)
    say(f"[7s check] the stream batch of the sampler's first row ({len(entries)} global ids from "
        f"{len({s for s, _, _ in entries})} shard(s)) equals the ImageFolder batch of the same ids bitwise: "
        f"{same_host}")
    if not same_host:
        fail("7s: the stream dataset and the ImageFolder dataset give different pixels for the same samples")
    before = train_ds.decoded.snapshot()                 # the check above; count what train() decodes
    state, first, launches, m = train_from_data(torch, cfg, data, "7s", card)
    c = check_decoded("7s", {k: v - before.get(k, 0) for k, v in m["decoded"].items()}, use_native,
                      cfg.batch_size, cfg.max_steps * cfg.batch_size)
    v = check_decoded("7s val", val_ds.decoded.snapshot(), use_native, cfg.batch_size,
                      cfg.eval_max_batches * cfg.batch_size)
    same = (np.array_equal(first["image"].numpy(), s_img) and np.array_equal(first["label"].numpy(), s_lbl))
    say(f"[7s check] decode counts train {c}, val {v}; the first batch delivered equals load_entries of the "
        f"sampler's first row bitwise: {same}")
    if not same:
        fail("7s: the first batch the stream loader delivered differs from load_entries of the same row")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def time_loaders(torch, root: str, card: str, use_native: bool) -> None:
    """The loaders alone: one epoch of the train split (16 batches of 32,
    uint8 at 224^2) copied to the card, at num_workers 4 and the host's CPU
    count, for ShardedLoader through PIL and (where it builds) the native
    decoder, and StreamLoader the same."""
    from vitax_torch.data.imagefolder import ImageFolderDataset
    from vitax_torch.data.loader import ShardedLoader, ShardedSampler
    from vitax_torch.data.stream import StreamDataset, StreamLoader, StreamSampler
    from vitax_torch.data.transforms import TrainTransform
    from vitax_torch import _native
    say(f"[7i loader] host: os.cpu_count() {os.cpu_count()}, the tree's files in the page cache")
    paths = [False, True] if use_native else [False]
    for native_on in paths:
        for kind in ("ShardedLoader", "StreamLoader"):
            for workers in (4, os.cpu_count()):
                t = TrainTransform(LOADER_IMAGE, SEED)
                if kind == "ShardedLoader":
                    ds = ImageFolderDataset(os.path.join(root, "tree", "train"), t, use_native=native_on)
                    loader = ShardedLoader(ds, ShardedSampler(len(ds), 32, True, SEED), "cuda", workers, 2)
                else:
                    ds = StreamDataset(os.path.join(root, "shards", "train"), t, use_native=native_on)
                    loader = StreamLoader(ds, StreamSampler(ds.meta, 32, True, SEED), "cuda", workers, 2)
                n = 0
                t0 = time.perf_counter()
                for batch in loader.epoch(1):
                    n += batch["image"].shape[0]
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                c = ds.decoded.snapshot()
                say(f"[7i loader] {kind}, {'native' if native_on else 'PIL'}, num_workers {workers}: "
                    f"{n / dt:.1f} images/s ({n} images, uint8 {LOADER_IMAGE}^2, in {dt:.3f}s; decoded {c}) "
                    f"[{card}]")
                if kind == "StreamLoader":
                    loader.close()
    if not use_native:
        say(f"[7i loader] native decoder: not measured ({_native.missing_toolchain()})")


def time_fused_adamw(torch, state, card):
    """The fused optimizer on the trained state's own params, mu and nu and
    the step's grad leaves (the main path's table: every leaf in one
    launch). The grads, near zero once the fake-data loss is 0, are
    refilled with seeded noise so the clip triggers. One launch is held
    element by element against clip_adamw_ on clones of params, mu and nu
    (30 GB beside the 40 GB state at depth 8); then the kernel is timed
    beside the plain version and torch.optim.AdamW(fused=True) on the same
    tensors. Returns (max |d|, timing)."""
    from vitax_torch.ops.fused_optimizer import clip_adamw_, fused_adamw_cuda, global_norm, step_scalars
    from vitax_torch.train.state import ADAMW_HPARAMS
    from vitax_torch.train.schedule import warmup_cosine_schedule
    _, params, mu, nu = state.leaves()
    grads = [p.grad for p in params]
    hp = (ADAMW_HPARAMS["b1"], ADAMW_HPARAMS["b2"], ADAMW_HPARAMS["eps"], 0.1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    numel = sum(p.numel() for p in params)
    with torch.no_grad():
        for g in grads:
            g.normal_(generator=gen).mul_(1e-3)
        scal = step_scalars(state.count, global_norm(grads), warmup_cosine_schedule(1e-3, 4, 100), 1.0,
                            hp[0], hp[1])
        gc.collect()
        torch.cuda.empty_cache()
        ref = [[x.clone() for x in xs] for xs in (params, mu, nu)]
        fused_adamw_cuda(params, grads, mu, nu, scal, hp)
        clip_adamw_(ref[0], grads, ref[1], ref[2], scal, hp)
        d, bad = adamw_diff(torch, (params, mu, nu), ref)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del ref
        torch.cuda.empty_cache()
    ok = bad == 0 and all(bool(torch.isfinite(p).all()) for p in params)
    say(f"[7 check] fused_adamw on the main path's table ({len(params)} leaves, {numel:,} params, one "
        f"launch), clip scale {scal[0].item():.4g}: max|d| {d:.3e}, {bad} elements outside rtol "
        f"{ADAMW_RTOL} / atol {ADAMW_ATOL}; max_memory_allocated {peak_gb:.2f} GB {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("fused_adamw disagrees with its plain version on the main path's leaf table")
    with torch.no_grad():
        kernel_ms = time_ms(torch, lambda: fused_adamw_cuda(params, grads, mu, nu, scal, hp), iters=5, warmup=1)
        plain_ms = time_ms(torch, lambda: clip_adamw_(params, grads, mu, nu, scal, hp), iters=2, warmup=1)
        lib = torch.optim.AdamW(params, lr=1e-3, betas=(hp[0], hp[1]), eps=hp[2], weight_decay=hp[3],
                                fused=True)
        library_ms = time_ms(torch, lib.step, iters=5, warmup=1)
        del lib
        torch.cuda.empty_cache()
        kernel_ms2 = time_ms(torch, lambda: fused_adamw_cuda(params, grads, mu, nu, scal, hp), iters=5, warmup=1)
    bound_ms, bound_by, nbytes = adamw_bound_ms(numel)
    say(f"[7 time] fused_adamw {len(params)} leaves, {numel:,} params: kernel {kernel_ms:.3f} / "
        f"{kernel_ms2:.3f} ms, plain {plain_ms:.3f} ms, torch.optim.AdamW(fused=True) {library_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms ({bound_by}: {nbytes / 1e9:.2f} GB) [{card}]")
    return d, {"ms": min(kernel_ms, kernel_ms2), "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by}


def drop_run_launches(cfg, steps: int) -> dict:
    """Every launch count of a train() run of cfg (N <= 2048) under
    att_dropout that takes `steps` optimizer steps and one eval of
    cfg.eval_max_batches: per step each block's dropout forward, its
    recompute and its dropout backward, one optimizer launch; the eval's
    rate-0 forwards. All on the wgmma kernels."""
    from vitax_torch.ops import _build
    n = cfg.num_blocks
    fwd, fwd_drop, bwd_drop = cfg.eval_max_batches * n, steps * 2 * n, steps * n
    return {"flash_attn_fwd": fwd, "flash_attn_fwd_drop": fwd_drop, "flash_attn_bwd": 0,
            "flash_attn_bwd_drop": bwd_drop, "fused_adamw": steps, "dequant_matmul": 0,
            **dict.fromkeys(_build.STREAM_KERNELS, 0), "flash_attn_fwd_wgmma": fwd + fwd_drop,
            "flash_attn_fwd_general": 0, "flash_attn_bwd_wgmma": bwd_drop, "flash_attn_bwd_general": 0,
            **dict.fromkeys(_build.DEQUANT_KERNELS, 0)}


def states_equal(torch, a, b) -> bool:
    """Bitwise: step, count, and every param, mu and nu tensor."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return (a.step == b.step and int(a.count) == int(b.count) and sa.keys() == sb.keys()
            and all(torch.equal(sa[k], sb[k]) and torch.equal(a.mu[k], b.mu[k]) and torch.equal(a.nu[k], b.nu[k])
                    for k in sa))


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def phase_checkpoint(  # vtx: ignore[VTX103] drop_run_launches is host arithmetic; each timed run synchronizes
        torch, card, root: str):
    """Phase 7c: save, resume and export (vitax_torch/checkpoint/). Run A
    trains two epochs and saves after each; run B resumes A's epoch 1 with
    --resume_epoch 1 and trains epoch 2; B must equal A bitwise (losses of
    epoch 2, params, mu, nu, step). --resume_epoch -1 must pick epoch 2 past
    a torn epoch_3/. Then the timed save and restore, and the int8 export
    of the resumed state served through kernel C against the trained model
    quantized in memory. Returns the launches of runs A and B and of the
    served batch."""
    from vitax_torch.checkpoint import io as ckpt_io
    from vitax_torch.checkpoint.consolidate import main as consolidate_main
    from vitax_torch.config import Config
    from vitax_torch.models.vit import expected_param_count
    from vitax_torch.ops import _build
    from vitax_torch.serve import InferenceEngine
    from vitax_torch.serve.quant import quantize_params_for_serve
    from vitax_torch.train.loop import train

    ckpt_dir = os.path.join(root, "ckpt")
    cfg = Config(seed=SEED, **TRAIN_CKPT, ckpt_dir=ckpt_dir).validate()
    n_params = expected_param_count(cfg)
    disk = shutil.disk_usage(root)
    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    say(f"[7c host] checkpoint dir {ckpt_dir}: {disk.free / 1e9:.1f} GB free of {disk.total / 1e9:.1f} GB; host RAM "
        f"{ram / 1e9:.1f} GB, {os.cpu_count()} CPUs")
    runs = {}
    for name, resume in (("A", 0), ("B", 1)):
        records = []
        _build.reset_launches()
        t0 = time.perf_counter()
        state = train(dataclasses.replace(cfg, resume_epoch=resume), "cuda", records=records)
        torch.cuda.synchronize()
        runs[name] = dict(state=state, records=records, launches=dict(_build.LAUNCHES),
                          wall=time.perf_counter() - t0)
    a, b = runs["A"], runs["B"]
    spe = cfg.steps_per_epoch
    for name, steps in (("A", 2 * spe), ("B", spe)):
        want = drop_run_launches(cfg, steps)
        if runs[name]["launches"] != want:
            fail(f"7c run {name}: train() launched {runs[name]['launches']}; expected {want}")
    loss_a2 = [r["loss"] for r in a["records"] if "loss" in r and r["epoch"] == 2]
    loss_b = [r["loss"] for r in b["records"] if "loss" in r]
    saves_a = [r for r in a["records"] if "ckpt_stall_s" in r]
    saves_b = [r for r in b["records"] if "ckpt_stall_s" in r]
    if [r["epoch"] for r in saves_a] != [1, 2] or [r["epoch"] for r in saves_b] != [2]:
        fail(f"7c: saves of run A at epochs {[r['epoch'] for r in saves_a]}, of run B at "
             f"{[r['epoch'] for r in saves_b]}; expected [1, 2] and [2]")
    same = states_equal(torch, a["state"], b["state"]) and loss_b == loss_a2 and len(loss_b) == spe
    say(f"[7c resume] 10B width, depth {cfg.num_blocks} ({n_params:,} params, {12 * n_params / 1e9:.2f} GB of f32 "
        f"params, mu and nu), batch {cfg.batch_size}, att_dropout {cfg.att_dropout}: run A 2 epochs of {spe} "
        f"steps in {a['wall']:.1f}s (saves after epochs 1 and 2), run B resumed epoch 1 and trained epoch 2 in "
        f"{b['wall']:.1f}s; epoch-2 losses A " + " ".join(f"{x:.6e}" for x in loss_a2) + " / B "
        + " ".join(f"{x:.6e}" for x in loss_b) + f"; step {a['state'].step} / {b['state'].step}; B equals A "
        f"bitwise (params, mu, nu, step, losses): {same}")
    if not same:
        fail("7c: the resumed run B differs from the uninterrupted run A")
    if not all(np.isfinite(loss_a2)):
        fail(f"7c: losses not finite: {loss_a2}")

    torn = os.path.join(ckpt_dir, "epoch_3")
    os.makedirs(torn)
    with open(os.path.join(torn, "__0_0.distcp"), "wb") as f:
        f.write(b"torn")
    _build.reset_launches()
    c = train(dataclasses.replace(cfg, resume_epoch=-1), "cuda")
    if ckpt_io.latest_epoch(ckpt_dir) != 2 or not states_equal(torch, c, a["state"]) or any(_build.LAUNCHES.values()):
        fail(f"7c: --resume_epoch -1 past the torn epoch_3/ did not restore epoch 2 as A left it "
             f"(latest {ckpt_io.latest_epoch(ckpt_dir)}, launches {dict(_build.LAUNCHES)})")
    say(f"[7c resume] --resume_epoch -1 skipped the torn epoch_3/ and restored epoch 2, bitwise A's final state")

    # the timed save (async, as the loop makes it) and restore
    timed = os.path.join(root, "timed")
    t0 = time.perf_counter()
    path = ckpt_io.save_state(timed, 1, b["state"])
    t1 = time.perf_counter()
    ckpt_io.wait_until_finished()
    t2 = time.perf_counter()
    disk = dir_bytes(path)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    ckpt_io.restore_state(timed, 1, c)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    if not states_equal(torch, c, b["state"]):
        fail("7c: the timed checkpoint did not restore bitwise")
    say(f"[7c save] save_state stall on the loop thread: run A's epoch-1 save {saves_a[0]['ckpt_stall_s']:.3f} s "
        f"(its first snapshot allocates the pinned host buffers), a later save {t1 - t0:.3f} s; the background "
        f"write {t2 - t1:.2f} s, {disk / 1e9:.2f} GB on disk, {disk / 1e9 / (t2 - t1):.2f} GB/s; a waited save "
        f"(run B's last) {saves_b[0]['ckpt_stall_s']:.2f} s [{card}]")
    say(f"[7c restore] restore_state of {disk / 1e9:.2f} GB onto the card in {t4 - t3:.2f} s, "
        f"{disk / 1e9 / (t4 - t3):.2f} GB/s [{card}]")
    shutil.rmtree(timed)
    ckpt_io.close()
    train_launches = {k: v + b["launches"][k] for k, v in a["launches"].items()}
    del c, a
    runs.pop("A")
    gc.collect()
    torch.cuda.empty_cache()

    out = os.path.join(root, "export_int8.npz")
    t0 = time.perf_counter()
    consolidate_main(["--ckpt_dir", ckpt_dir, "--epoch", "2", "--out", out, "--dtype", "int8"])
    t_export = time.perf_counter() - t0
    say(f"[7c export] consolidate --dtype int8 of epoch 2: {t_export:.2f} s, {os.path.getsize(out) / 1e9:.2f} GB "
        f"[{card}]")
    scfg = dataclasses.replace(cfg, serve_quant_dtype="int8").validate()
    served = InferenceEngine.from_npz(scfg, out, "cuda")
    mem = InferenceEngine.from_state(scfg, quantize_params_for_serve(dict(b["state"].model.state_dict()), "int8"),
                                     "cuda", "int8")
    sd_npz, sd_mem = served.model.state_dict(), mem.model.state_dict()
    codes_differ = sum(int((sd_npz[k] != sd_mem[k]).sum()) for k in sd_npz)
    served.warmup()
    mem.warmup()
    x = np.random.default_rng(SEED + 7).integers(0, 256, (8, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    _build.reset_launches()
    ids_s, p_s = served.predict(x)
    serve_launches = dict(_build.LAUNCHES)
    ids_m, p_m = mem.predict(x)
    per_batch = 4 * cfg.num_blocks + 1
    wgmma = serve_launches["dequant_matmul_wgmma"]
    if serve_launches["dequant_matmul"] != per_batch or wgmma < per_batch - 1 \
            or serve_launches["flash_attn_fwd"] != cfg.num_blocks:
        fail(f"7c: the export's bucket-8 batch launched {serve_launches}; expected dequant_matmul {per_batch} "
             f"(the block sites on wgmma) and flash_attn_fwd {cfg.num_blocks}")
    # one quantizer on both sides (the export's on the host, the in-memory
    # one on the card), so the codes, the scales and the served answers are
    # the same bit for bit, not only the top-1 the fake-data model makes
    # easy to share
    dp = float(np.abs(p_s - p_m).max())
    same = bool(np.array_equal(ids_s, ids_m)) and dp == 0.0 and codes_differ == 0
    say(f"[7c serve] the int8 export served one bucket-8 batch: dequant_matmul {serve_launches['dequant_matmul']} "
        f"launches (wgmma {wgmma}), top-1 {ids_s[:, 0].tolist()}, the trained model quantized in memory "
        f"{ids_m[:, 0].tolist()}; top-{cfg.serve_topk} ids equal {bool(np.array_equal(ids_s, ids_m))}, max |dp| "
        f"{dp:.3g}; weights or scales that differ between the two: {codes_differ} [{card}]")
    if not same or not (np.isfinite(p_s).all() and p_s.shape == (8, cfg.serve_topk)):
        fail("7c: the int8 export serves other answers, codes or scales than the in-memory quantized model, or "
             "its probs are not finite")
    del served, mem, runs, b
    gc.collect()
    torch.cuda.empty_cache()
    return {k: train_launches[k] + serve_launches[k] for k in serve_launches}


# Phase 7e: the failure-reaction drills at phase 7c's cell (TRAIN_CKPT: the
# 10B width at depth 2, att_dropout 0.1, two epochs of three steps, a save
# after each). Each drill is the train CLI under `python -m
# vitax_torch.supervise` (DRILL_MAIN: the CLI's main, which writes the
# child's kernel launches before an injected fault acts and at its exit);
# phase 7c's run A, on the same flags in process, is the uninterrupted run
# each drill must end bitwise. The drills run in waves of a few processes.
DRILL_MAIN = """import json, os, sys
import torch.distributed as dist
from vitax_torch import faults
from vitax_torch.ops import _build
from vitax_torch.train.__main__ import main
def dump():
    with open(os.path.join(os.environ["VITAX_SMOKE_LAUNCHES"], "launches_%d.json" % os.getpid()), "w") as f:
        json.dump(_build.LAUNCHES, f)
act = faults._act
def act_after_dump(spec, index):
    dump()
    act(spec, index)
faults._act = act_after_dump
if "WORLD_SIZE" in os.environ:
    dist.init_process_group("gloo", init_method="env://")
try:
    rc = main(sys.argv[1:])
finally:
    dump()
sys.exit(rc)
"""
# Drills (a)-(e) run at 7c's cell cut to depth 1 (3.83 GB of state): a card machine holds 96 GiB of host
# memory, /dev/shm included, and takes 45 GiB of disk writes a run; at depth 2 a drill child pins 7.66 GB
# (15.3 under the pipeline) and writes 7.66 GB a save, and such runs were killed for memory and for disk
# writes. In this script (f) runs 7c's knobs at bench.py's b16 width (bench.py:288-291, phase 7m's model):
# at DRILL_CELL its pairs (ZeRO-3 over gloo, about 30 GiB of host memory a pair) took 7e to 410.7 s on the
# H100 and the whole script to 1225.6 s, past its 1200 s. `python3 chip_smoke.py --lost-rank` runs (f)
# alone at DRILL_CELL. Since phase 7a, (f) runs b16 cut to depth 4, as 7a's training tenant: at depth 12
# its pairs took 92-100 s of a gloo step of 4-10 s, bounding both waves (7e 237.3 s, the script 1105.6 s
# on an H100 80GB HBM3 at 700 W).
DRILL_CELL = dict(TRAIN_CKPT, num_blocks=1)
LOST_RANK_CELL = dict(TRAIN_CKPT, image_size=224, patch_size=16, embed_dim=768, num_heads=12, num_blocks=4)
HANG_TIMEOUT_S, HANG_S = 12.0, 15.0      # a hang 3 s past the watchdog's window (the drills' saves stay inside it)
PEER_GRACE_S = 10.0                      # (f): --peer_heartbeat_s 1, the default grace of 10 beats
DRILL_DEVICE = "cuda:0"                  # every drill's process on the one card


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_flags(cfg: dict) -> list:
    """A Config dict as train CLI flags (store_true flags by name)."""
    out = []
    for k, v in cfg.items():
        if v is True:
            out.append(f"--{k}")
        elif v is not False:
            out += [f"--{k}", str(v)]
    return out


def drill_launches(cfg, steps: int, evals: int) -> dict:
    """Kernel launches of `steps` steps and `evals` one-batch evals of
    phase 7c's cell: the dropout forward, its recompute and the dropout
    backward a block a step, one fused_adamw a step; rate-0 eval forwards."""
    want = drop_run_launches(cfg, steps)
    fwd = evals * cfg.eval_max_batches * cfg.num_blocks
    want["flash_attn_fwd"] = fwd
    want["flash_attn_fwd_wgmma"] = fwd + want["flash_attn_fwd_drop"]
    return want


def run_procs(cmds, timeout: float) -> dict:
    """Start every (name, argv, env, log path) at once and poll them all:
    {name: (exit code, stdout and stderr, seconds from the start to its
    exit)}; kills what is left at the timeout."""
    procs, ends, t0 = {}, {}, time.monotonic()
    try:
        for name, argv, env, log in cmds:
            procs[name] = subprocess.Popen(argv, cwd=REPO, env=env, stdout=open(log, "w"),
                                           stderr=subprocess.STDOUT, start_new_session=True), log
        while len(ends) < len(procs) and time.monotonic() - t0 < timeout:
            for name, (p, _) in procs.items():
                if name not in ends and p.poll() is not None:
                    ends[name] = time.monotonic() - t0
            time.sleep(0.05)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    if len(ends) < len(procs):
        fail(f"7e: {sorted(set(procs) - set(ends))} still running after {timeout:.0f}s")
    out = {}
    for name, (p, log) in procs.items():
        with open(log) as f:
            out[name] = (p.returncode, f.read(), ends[name])
    return out


def flat_state(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(flat_state(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def same_state(torch, got: dict, want: dict) -> bool:
    return got.keys() == want.keys() and all(
        (got[k] == want[k]) if isinstance(want[k], int) else torch.equal(got[k], want[k]) for k in want)


def summed_launches(d: str) -> dict:
    from vitax_torch.ops import _build
    total = {k: 0 for k in _build.LAUNCHES}
    for name in os.listdir(d):
        if name.startswith("launches_"):
            with open(os.path.join(d, name)) as f:
                for k, v in json.load(f).items():
                    total[k] += v
    return total


def stage_stalls(torch, cfg, card: str) -> None:
    """The loop-thread stall of a save at phase 7c's cell, steady state, in
    turns: save_state's host snapshot (a synchronous copy into its reused
    pinned buffers) against the pipeline's stage (copies queued on a side
    stream into a reused buffer set), and the side stream's copy itself."""
    from vitax_torch.checkpoint import io as ckpt_io
    from vitax_torch.checkpoint.snapshot import SnapshotPipeline
    from vitax_torch.models.vit import build_model
    from vitax_torch.ops.attention import make_attention_impl
    from vitax_torch.train.state import make_train_state
    model = build_model(cfg, "cuda", attention_impl=make_attention_impl(cfg, "cuda"))
    state = make_train_state(model)
    pipe = SnapshotPipeline(device="cuda")
    writer = ckpt_io._Writer()
    times = {"snapshot": [], "stage": [], "copy": []}
    try:
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            writer.snapshot(ckpt_io.train_state_dict(state))
            times["snapshot"].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            snap = pipe.stage(state, epoch=1)
            times["stage"].append(time.perf_counter() - t0)
            snap.wait_ready()
            times["copy"].append(time.perf_counter() - t0)
            snap.release()
    finally:
        pipe.close()
        writer.close()
    gb = 12 * sum(p.numel() for p in model.parameters()) / 1e9
    say(f"[7e stall] a save's stall on the loop thread, {gb:.2f} GB of state, beside 7e's wave 2, in turns (first "
        f"call cold: the pinned buffers are allocated; then warm): save_state's snapshot "
        + " ".join(f"{t:.4f}" for t in times["snapshot"])
        + " s; the pipeline's stage " + " ".join(f"{t:.4f}" for t in times["stage"]) + " s (its side-stream copy "
        + " ".join(f"{t:.4f}" for t in times["copy"]) + f" s, overlapping the next step until its update) [{card}]")
    del model, state
    gc.collect()
    torch.cuda.empty_cache()


class Drills:
    """Phase 7e's drill runs: each drill's dir (under /dev/shm where there
    is one: the card machine's disk takes 45 GiB of writes a run), its
    command (DRILL_MAIN under the supervisor, or a rank as torchrun starts
    it), the checks of its output, its final state against the
    uninterrupted run's (kept on the card), its events and its kernel
    launches."""

    def __init__(self, torch, card: str, root: str, lost_cell=None):
        from vitax_torch.config import Config
        from vitax_torch.ops import _build
        self.torch, self.card, self.root = torch, card, root
        self.cfg = Config(seed=SEED, **DRILL_CELL).validate()
        self.lost_cell = lost_cell or LOST_RANK_CELL          # (f)'s
        self.lost_cfg = Config(seed=SEED, **self.lost_cell).validate()
        self.work = tempfile.mkdtemp(prefix="vitax_torch_7e_", dir="/dev/shm" if os.path.isdir("/dev/shm") else root)
        self.main_py = os.path.join(root, "drill_main.py")
        with open(self.main_py, "w") as f:
            f.write(DRILL_MAIN)
        self.env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.launches = {k: 0 for k in _build.LAUNCHES}
        self.want = None                 # the uninterrupted run's final state, flat, on the card

    def where(self, name: str) -> str:
        return os.path.join(self.work, name.split()[0])

    def drill(self, name, extra=(), sync=False, supervised=True, env_extra=None, cell=None):
        """(name, argv, env, log path) of one drill process for run_procs, on
        `cell`'s flags (seed 0)."""
        d = self.where(name)
        os.makedirs(os.path.join(d, "launches"), exist_ok=True)
        env = dict(self.env, VITAX_SMOKE_LAUNCHES=os.path.join(d, "launches"), **(env_extra or {}))
        if sync:
            env["VITAX_CKPT_SYNC"] = "1"
        flags = cli_flags({**(cell or DRILL_CELL), "seed": SEED})
        argv = [sys.executable, self.main_py, *flags, "--device", DRILL_DEVICE, *extra,
                "--ckpt_dir", os.path.join(d, "ckpt"), "--metrics_dir", os.path.join(d, "m")]
        if supervised:
            argv = [sys.executable, "-m", "vitax_torch.supervise", "--backoff_s", "0", "--", *argv]
        tag = name.replace(" ", "_")
        return name, argv, env, os.path.join(d, f"{tag}.{sum(n.startswith(tag + '.') for n in os.listdir(d))}.log")

    @staticmethod
    def check(name, res, out_want=(), rc_want=0) -> None:
        rc, out, _ = res
        missing = [s for s in out_want if s not in out]
        if rc != rc_want or missing:
            fail(f"[7e {name}] exit {rc} (want {rc_want}), missing {missing}:\n{out[-4000:]}")

    def state(self, name: str, epoch: int = 2) -> dict:
        from vitax_torch.checkpoint import io as ckpt_io
        return flat_state(ckpt_io.read_state(os.path.join(self.where(name), "ckpt"), epoch))

    def final(self, name: str, against=None) -> bool:
        want = self.want if against is None else against
        got = {k: v if isinstance(v, int) else v.to(want[k].device) for k, v in self.state(name).items()}
        if not same_state(self.torch, got, want):
            fail(f"[7e {name}] the final state differs from the uninterrupted run's")
        return True

    def jsonl(self, name: str):
        return read_jsonl(os.path.join(self.where(name), "m", "metrics.jsonl"))

    def count(self, name: str, steps: int, evals: int, exact: bool = True) -> dict:
        """Add the drill's launches (every child's file) to the phase's, held
        against `steps` steps and `evals` evals of its cell when `exact`."""
        got = summed_launches(os.path.join(self.where(name), "launches"))
        expect = drill_launches(self.lost_cfg if name.startswith("f") else self.cfg, steps, evals)
        keys = ("flash_attn_fwd", "flash_attn_fwd_drop", "flash_attn_bwd", "flash_attn_bwd_drop", "fused_adamw",
                "flash_attn_fwd_general", "flash_attn_bwd_general")
        if exact and any(got[k] != expect[k] for k in keys):
            fail(f"[7e {name}] launched {({k: got[k] for k in keys})}; expected {({k: expect[k] for k in keys})}")
        for k in self.launches:
            self.launches[k] += got[k]
        return {k: got[k] for k in ("flash_attn_fwd", "flash_attn_fwd_drop", "flash_attn_bwd_drop", "fused_adamw")}

    def done(self, name: str) -> None:
        shutil.rmtree(self.where(name), ignore_errors=True)


CRASH_AT_5 = '{"site": "step", "at": 5, "action": "crash", "exit_code": 13}'


def host_in_use_gib() -> float:
    with open("/proc/meminfo") as f:
        m = {ln.split(":")[0]: int(ln.split()[1]) for ln in f}
    return (m["MemTotal"] - m["MemAvailable"]) / 2**20


def free_host_memory(torch) -> str:
    """Return the process's cached pinned host blocks (earlier phases'
    checkpoint staging) to the OS before the drills' processes pin their
    own; the host's memory in use before and after."""
    before = host_in_use_gib()
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("_accelerator_emptyHostCache", "_host_emptyCache", "_cuda_emptyHostCache"):
        if hasattr(torch._C, name) and torch.cuda.is_available():
            getattr(torch._C, name)()
            break
    return (f"host memory in use {before:.1f} GiB, {host_in_use_gib():.1f} GiB after releasing this process's "
            f"pinned cache")


def run_wave(cmds, timeout: float = 900) -> tuple:
    """run_procs with the host's memory in use sampled: (results, seconds,
    peak GiB)."""
    peak, stop = [host_in_use_gib()], threading.Event()

    def sample():
        while not stop.wait(1.0):
            peak[0] = max(peak[0], host_in_use_gib())

    t = threading.Thread(target=sample, daemon=True)
    t0 = time.perf_counter()
    t.start()
    try:
        res = run_procs(cmds, timeout)
    finally:
        stop.set()
        t.join()
    return res, time.perf_counter() - t0, peak[0]


def wave_beside(cmds, work) -> tuple:
    """run_wave(cmds) on a thread while `work()` runs on this one (train()
    keeps the main thread for its signal handlers): (run_wave's result,
    work's result, work's seconds)."""
    wave = {}

    def run() -> None:
        try:
            wave["out"] = run_wave(cmds)
        except BaseException as e:  # noqa: BLE001 - raised again on the main thread
            wave["error"] = e
    runner = threading.Thread(target=run, name="7e-wave")
    runner.start()
    try:
        t0 = time.perf_counter()
        got = work()
        seconds = time.perf_counter() - t0
    finally:
        runner.join()
    if "error" in wave:
        raise wave["error"]
    return wave["out"], got, seconds


def pair(dr: Drills, name: str, extra=()) -> list:
    """Drill (f)'s two ranks at dr.lost_cell, as torchrun starts them."""
    port = free_port()
    return [dr.drill(f"{name} r{r}", ["--replicate_steps", "2", "--peer_heartbeat_s", "1", "--peer_grace_s",
                                      str(PEER_GRACE_S), "--resume_epoch", "-1", *extra], sync=True, supervised=False,
                     env_extra=dict(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                                    MASTER_PORT=str(port)), cell=dr.lost_cell)
            for r in (0, 1)]


def uninterrupted(torch, dr: Drills) -> list:
    """The drills' uninterrupted run, train() in this process at
    DRILL_CELL: its final state on the card becomes dr.want; returns its
    saves' records (each save's stall without the pipeline)."""
    from vitax_torch.checkpoint import io as ckpt_io
    from vitax_torch.train.loop import train
    records = []
    state = train(dataclasses.replace(dr.cfg, ckpt_dir=os.path.join(dr.work, "base")), DRILL_DEVICE,
                  records=records)
    dr.want = flat_state({k: v.detach().clone() if isinstance(v, torch.Tensor) else v
                          for k, v in ckpt_io.train_state_dict(state).items()})
    dr.want = {k: int(v) if k == "step" else v for k, v in dr.want.items()}
    ckpt_io.close()
    del state
    dr.done("base")
    return [r for r in records if "ckpt_stall_s" in r]


def pair_lines(dr: Drills, name: str, res: dict) -> str:
    """Each rank's seconds and its step and save lines (the CLI's log) of
    one (f) pair run, for the drill's line."""
    out = []
    for r in (0, 1):
        rc, log, end = res[f"{name} r{r}"]
        lines = [ln.split(", mem:")[0] for ln in log.splitlines()
                 if ln.startswith(("epoch ", "checkpoint save of", "restored from PEER"))]
        out.append(f"rank {r} exit {rc} after {end:.1f} s" + (": " + "; ".join(lines) if r == 0 and lines else ""))
    return " | ".join(out)


def check_first(dr: Drills, res: dict, base_saves: list) -> dict:
    """(a), (b)'s first child, (c) and (d): their checks and lines; returns
    what later lines cite."""
    from vitax_torch.checkpoint import io as ckpt_io
    from vitax_torch.telemetry.watchdog import EXIT_HANG
    card = dr.card
    dr.check("a crash", res["a crash"], ["injecting step:crash", "restart 1: child exit 13", "child completed cleanly"])
    steps_a, ev = dr.jsonl("a crash")
    restart, restore = ev["restart"][0], ev["restore"][0]
    first = min(s["time"] for s in steps_a if s["time"] > restart["time"])
    if not (restart["exit_code"] == 13 and restore["path"] == "dcp" and restore["dcp_reads"] == 1
            and dr.final("a crash")):
        fail(f"[7e a crash] restart {restart}, restore {restore}")
    say(f"[7e a crash] crash (exit 13) at step 5, one restart, restored epoch 1 from DCP in {restore['seconds']:.2f} s "
        f"({restore['dcp_reads']} read), epoch 2 bitwise the uninterrupted run; the child's death to the restarted "
        f"child's first step {first - restart['time']:.2f} s; launches {dr.count('a crash', 8, 1)} [{card}]")
    dr.check("d zero-stall", res["d zero-stall"], ["(zero-stall pipeline;", "child completed cleanly"])
    held = [ln for ln in res["d zero-stall"][1].splitlines() if ln.startswith("checkpoint save of epoch")]
    dr.final("d zero-stall")
    steps_d, _ = dr.jsonl("d zero-stall")
    say(f"[7e d zero-stall] --zero_stall_ckpt: " + "; ".join(held) + "; ckpt_stall_s of its step records "
        + " ".join(f"{s['ckpt_stall_s']:.4f}" for s in steps_d) + "; without it (the uninterrupted run) the saves "
        "held the loop " + " ".join(f"{r['ckpt_stall_s']:.4f}" for r in base_saves) + " s. A save that finds the "
        "other buffer set still in its DCP write pins a second one (cold, like save_state's first snapshot, and "
        "slower beside the wave's other processes); the pipeline's epoch-2 checkpoint restores bitwise the "
        f"uninterrupted run; launches {dr.count('d zero-stall', 6, 1)} [{card}]")
    dr.check("b sigterm", res["b sigterm"], ["SIGTERM received: saving preemption checkpoint at epoch 1 (step 2)",
                                             "child completed cleanly"])
    sidecar = ckpt_io.load_resume_meta(os.path.join(dr.where("b"), "ckpt"), 1)
    if sidecar != {"step_in_epoch": 2, "process_count": 1}:
        fail(f"[7e b sigterm] sidecar {sidecar}")
    dr.check("c hang", res["c hang"], ["dumping all-thread stacks", "saving emergency checkpoint at epoch 2 (step 2)",
                                       "restart 1: child exit 42", "re-entering epoch 2 at step 3"])
    _, ev = dr.jsonl("c hang")
    esc, restart = ev["hang_escalation"][0], ev["restart"][0]
    cuda_stats = ev["hang"][0].get("cuda_memory_stats")
    if (DRILL_DEVICE.startswith("cuda") and not cuda_stats) or restart["exit_code"] != EXIT_HANG:
        fail(f"[7e c hang] hang event {sorted(ev['hang'][0])}, restart {restart}")
    exit_after = restart["time"] - esc["time"]
    if exit_after > 2 * HANG_TIMEOUT_S:
        fail(f"[7e c hang] exit 42 came {exit_after:.2f} s after the escalation, past the hard deadline")
    dr.final("c hang")
    allocated = (cuda_stats or {}).get("allocated_bytes.all.current", 0) / 1e9
    say(f"[7e c hang] a {HANG_S:g} s hang at step 5 past --hang_timeout_s {HANG_TIMEOUT_S:g}: the stack and "
        f"torch.cuda.memory_stats dump (allocated {allocated:.2f} GB), the emergency save at epoch 2 step 2 and exit "
        f"42 {exit_after:.2f} s after the escalation (hard deadline {2 * HANG_TIMEOUT_S:g} s), one restart, bitwise; "
        f"launches {dr.count('c hang', 6, 1)} [{card}]")
    for name in ("a crash", "c hang", "d zero-stall"):
        dr.done(name)
    return {"dcp_restore_s": restore["seconds"],
            "preempt_save": [ln for ln in res["b sigterm"][1].splitlines()
                             if ln.startswith("checkpoint save of epoch 1")]}


def check_base_pair(dr: Drills, res: dict) -> dict:
    """(f)'s uninterrupted pair: its final state (on the card) and launches."""
    for r in (0, 1):
        dr.check(f"fbase r{r}", res[f"fbase r{r}"])
    out = {"fbase_launches": dr.count("fbase", 12, 2),
           "fbase": {k: v if isinstance(v, int) else v.to(DRILL_DEVICE) for k, v in dr.state("fbase").items()}}
    say(f"[7e f lost rank] the uninterrupted pair: {pair_lines(dr, 'fbase', res)}; launches "
        f"{out['fbase_launches']} [{dr.card}]")
    dr.done("fbase")
    return out


def check_lost_pair(dr: Drills, res: dict) -> dict:
    """(f)'s pair that loses rank 1 at step 4: rank 0's exit 42 within the
    grace plus its deadline; then rank 1's store deleted."""
    from vitax_torch.telemetry.watchdog import EXIT_HANG
    (rc0, out0, end0), (rc1, _, end1) = res["flost r0"], res["flost r1"]
    if rc0 != EXIT_HANG or rc1 != -9 or "peer 1 lost" not in out0:
        fail(f"[7e f lost] rank 0 exit {rc0}, rank 1 exit {rc1}:\n{out0[-4000:]}")
    latency = end0 - end1
    if latency > 2 * PEER_GRACE_S:
        fail(f"[7e f lost] rank 0 exited {latency:.2f} s after rank 1's death, past peer_grace_s plus its deadline")
    stores = os.path.join(dr.where("flost"), "ckpt", "peerstore")
    held = sorted(os.listdir(os.path.join(stores, "p0")))
    shutil.rmtree(os.path.join(stores, "p1"))          # rank 1's host is gone with its disk
    say(f"[7e f lost rank] the lost pair: {pair_lines(dr, 'flost', res)}; rank 0 exited {EXIT_HANG} {latency:.2f} s "
        f"after rank 1's death (bound {2 * PEER_GRACE_S:g} s) [{dr.card}]")
    return {"lost_latency": latency, "held": held}


def check_second(dr: Drills, res: dict, w1: dict) -> None:
    """(b)'s resume and (e)."""
    card = dr.card
    dr.check("b sigterm", res["b sigterm"], ["step-granular resume: re-entering epoch 1 at step 3"])
    dr.final("b sigterm")
    say(f"[7e b sigterm] SIGTERM at step 2: a committed mid-epoch save ({'; '.join(w1['preempt_save'])}), exit 0 "
        f"through the supervisor; the resumed run re-entered at step 3 and ended bitwise the uninterrupted run; "
        f"launches {dr.count('b sigterm', 6, 1)} [{card}]")
    dr.check("e peer", res["e peer"], ["restart 1: child exit 13", "restored from PEER shards"])
    _, ev = dr.jsonl("e peer")
    restore = ev["restore"][0]
    if not (restore["path"] == "peer" and restore["dcp_reads"] == 0 and dr.final("e peer")):
        fail(f"[7e e peer] restore {restore}")
    repl = ev.get("peer_replication", [])
    windows = " ".join(f"{r['seconds']:.2f}" for r in repl)
    say(f"[7e e peer] --replicate_steps 2, a crash at step 5: the restart restored epoch 1 from the peer store in "
        f"{restore['seconds']:.2f} s with {restore['dcp_reads']} checkpoint-directory reads (drill a's DCP restore "
        f"{w1['dcp_restore_s']:.2f} s); {len(repl)} replication windows of "
        f"{repl[0]['bytes'] / 1e9 if repl else 0:.2f} GB ({windows} s each on the worker); bitwise; launches "
        f"{dr.count('e peer', 8, 1)} [{card}]")
    for name in ("b sigterm", "e peer"):
        dr.done(name)


def check_relaunch(dr: Drills, res: dict, base: dict, lost: dict) -> None:
    """(f)'s relaunched pair: restored from rank 0's store with no read of
    the checkpoint directory, bitwise the uninterrupted pair."""
    from vitax_torch.telemetry.watchdog import EXIT_HANG
    for r in (0, 1):
        dr.check(f"flost r{r} relaunched", res[f"flost r{r}"])
    _, ev = dr.jsonl("flost")
    restore = ev["restore"][-1]
    if not (restore["path"] == "peer" and restore["dcp_reads"] == 0):
        peer_lines = [ln for r in (0, 1) for ln in res[f"flost r{r}"][1].splitlines() if "peer" in ln.lower()]
        fail(f"[7e f lost] the relaunched pair restored {restore}; rank 0's store held {lost['held']}:\n"
             + "\n".join(peer_lines[-40:]))
    dr.final("flost", against=base["fbase"])
    dr.count("flost", 0, 0, exact=False)
    repl = ev.get("peer_replication", [])
    c = dr.lost_cfg
    say(f"[7e f lost rank] 7c's knobs at D {c.embed_dim}, {c.num_heads} heads, {c.num_blocks} block(s), batch "
        f"{c.batch_size}, ZeRO-3, two ranks over gloo on the card (--replicate_steps 2 --peer_heartbeat_s 1, grace "
        f"{PEER_GRACE_S:g} s): rank 1 killed at step 4, rank 0 exited {EXIT_HANG} {lost['lost_latency']:.2f} s "
        f"later; rank 0's store held {lost['held']}; with rank 1's store deleted the relaunched pair restored epoch "
        f"1 from rank 0's copies in {restore['seconds']:.2f} s (rank 0 serving rank 1's shard from its own store), "
        f"{restore['dcp_reads']} checkpoint-directory reads, and ended bitwise the uninterrupted pair; rank 0's "
        f"replication windows of {repl[0]['bytes'] / 1e9 if repl else 0:.2f} GB took "
        + " ".join(f"{r['seconds']:.2f}" for r in repl) + f" s on its worker; the relaunch: "
        f"{pair_lines(dr, 'flost', res)} [{dr.card}]")
    dr.done("flost")


FLOST_PLAN = '{"site": "step", "at": 4, "action": "peer_loss", "process": 1}'


def phase_faults(torch, card: str, root: str) -> dict:
    """Phase 7e: the six drills of vitax_torch's failure reaction: (a) a
    crash and its restart, (b) SIGTERM's mid-epoch save and the resume, (c)
    a hang, the watchdog's dump, the emergency save and exit 42, (d)
    --zero_stall_ckpt, (e) a crash restored from the peer store, each the
    train CLI under `python -m vitax_torch.supervise` at DRILL_CELL against
    one uninterrupted train() of it; (f) a lost rank of two over gloo on
    the card at LOST_RANK_CELL against an uninterrupted pair; then, at
    7c's cell, the loop-thread stall of a save with and without the
    pipeline in turns. Returns the drills' kernel launches."""
    t0 = time.perf_counter()
    say(f"[7e host] {free_host_memory(torch)}")
    dr = Drills(torch, card, root)
    first = [
        dr.drill("a crash", ["--fault_plan", CRASH_AT_5], sync=True),
        dr.drill("b sigterm", ["--fault_plan", '{"site": "step", "at": 2, "action": "sigterm"}']),
        dr.drill("c hang", ["--fault_plan", json.dumps({"site": "step", "at": 5, "action": "hang", "seconds": HANG_S}),
                            "--hang_timeout_s", str(HANG_TIMEOUT_S), "--hang_action", "checkpoint_exit"]),
        dr.drill("d zero-stall", ["--zero_stall_ckpt"]), *pair(dr, "fbase"),
        *pair(dr, "flost", ["--fault_plan", FLOST_PLAN])]
    # wave 1 runs beside the uninterrupted run (train() keeps the main
    # thread: it installs signal handlers), which its checks need after it
    (res, took, peak), base_saves, t_base = wave_beside(first, lambda: uninterrupted(torch, dr))
    say(f"[7e host] drill dirs under {dr.work}; the uninterrupted run took {t_base:.1f}s beside wave 1; "
        f"{free_host_memory(torch)}")
    w1 = check_first(dr, res, base_saves)
    base, lost = check_base_pair(dr, res), check_lost_pair(dr, res)
    say(f"[7e] wave 1 (a, b's first child, c, d, (f)'s uninterrupted and lost pairs, beside the uninterrupted run) "
        f"took {took:.1f}s, host memory in use at most {peak:.1f} GiB")
    # wave 2 runs beside the save-stall measurement at 7c's cell
    from vitax_torch.config import Config
    (res, took, peak), _, t_stall = wave_beside([
        dr.drill("b sigterm"), dr.drill("e peer", ["--fault_plan", CRASH_AT_5, "--replicate_steps", "2"], sync=True),
        *pair(dr, "flost")], lambda: stage_stalls(torch, Config(seed=SEED, **TRAIN_CKPT).validate(), card))
    check_second(dr, res, w1)
    check_relaunch(dr, res, base, lost)
    say(f"[7e] wave 2 (b's resume, e, (f)'s relaunched pair, beside the stall measurement's {t_stall:.1f}s) took "
        f"{took:.1f}s, host memory in use at most {peak:.1f} GiB")
    dr.want = None
    shutil.rmtree(dr.work, ignore_errors=True)
    gc.collect()
    say(f"[7e] took {time.perf_counter() - t0:.1f}s")
    return dr.launches


def lost_rank_only(torch, card: str, root: str) -> None:
    """`python3 chip_smoke.py --lost-rank`: drill (f) alone at DRILL_CELL
    (the 10B width at depth 1, ZeRO-3 over two gloo ranks on the card):
    the uninterrupted and the lost pair in one wave, then the relaunched
    pair restored from rank 0's store, bitwise the uninterrupted pair."""
    t0 = time.perf_counter()
    dr = Drills(torch, card, root, lost_cell=DRILL_CELL)
    res, took, peak = run_wave([*pair(dr, "fbase"), *pair(dr, "flost", ["--fault_plan", FLOST_PLAN])])
    base, lost = check_base_pair(dr, res), check_lost_pair(dr, res)
    say(f"[7e] the uninterrupted and lost pairs took {took:.1f}s, host memory in use at most {peak:.1f} GiB")
    res, took, peak = run_wave(pair(dr, "flost"))
    check_relaunch(dr, res, base, lost)
    say(f"[7e] the relaunched pair took {took:.1f}s, host memory in use at most {peak:.1f} GiB")
    shutil.rmtree(dr.work, ignore_errors=True)
    launches = {k: v for k, v in dr.launches.items() if v}
    say(f"[7e] (f) at DRILL_CELL took {time.perf_counter() - t0:.1f}s; kernel launches of its pairs {launches}")


# Phase 7x: the transfer tasks at phase 7's configuration cut to depth 2 from a seeded
# bf16 export of the same model (another seed), and serving a checkpoint
# directory at depth 2.
TRANSFER_EXPORT_SEED = SEED + 1
TRANSFER = dict(TRAIN, num_blocks=2)     # phase 7's cell cut to depth 2: the export and each run a quarter
TRANSFER_RUNS = (("finetune", dict(task="finetune", reinit_head=True, backbone_lr_mult=0.1)),
                 ("probe", dict(task="probe")), ("distill", dict(task="distill")))
SERVE_CKPT = dict(num_blocks=2, batch_size=32, fake_data=True, warmup_steps=4, log_step_interval=1,
                  eval_max_batches=1, num_epochs=1, steps_per_epoch=3, task="probe")


def write_transfer_export(torch, cfg, path: str) -> dict:
    """The seeded model of `cfg` exported as consolidate --dtype bfloat16
    writes it (the JAX layout, scanned blocks, bf16 leaves): returns the
    export's params in the port's names, bf16 on the host."""
    from vitax_torch.checkpoint.consolidate import save_npz
    from vitax_torch.checkpoint.convert import params_from_jax, params_to_jax
    from vitax_torch.models.vit import build_model
    model = build_model(cfg, "cuda")
    tree = params_to_jax({k: v.to(torch.bfloat16) for k, v in model.state_dict().items()})
    del model
    torch.cuda.empty_cache()
    save_npz(path, tree)
    return params_from_jax(tree)


def transfer_launches(cfg, teacher: bool) -> dict:
    """train_run_launches, plus the distill teacher's forward a block a step."""
    want = train_run_launches(cfg)
    if teacher:
        for key in ("flash_attn_fwd", "flash_attn_fwd_wgmma"):
            want[key] += cfg.max_steps * cfg.num_blocks
    return want


def serve_checkpoint_cli(ckpt_dir: str, card: str) -> None:
    """python -m vitax_torch.serve --ckpt_dir D --epoch -1 at depth 2 on the
    card: one /predict, then exit 0 on SIGTERM."""
    import signal
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "vitax_torch.serve", "--ckpt_dir", ckpt_dir, "--epoch", "-1", "--num_blocks",
           str(SERVE_CKPT["num_blocks"]), "--serve_port", "0", "--serve_max_batch", "8"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        port, deadline = None, time.monotonic() + 300
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "listening on :" in line:
                port = int(line.split("listening on :")[1].split()[0])
        if port is None:
            fail("[7x serve] the serve CLI never bound:\n" + "".join(lines)[-3000:])
        url = f"http://127.0.0.1:{port}"
        while not http(url + "/healthz")["ready"]:
            if time.monotonic() > deadline:
                fail("[7x serve] the serve CLI never warmed up")
            time.sleep(0.2)
        ans = http(url + "/predict", ppm_bytes(np.random.default_rng(SEED + 8)))
        check_answer(ans, 5, 1000)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        lines += proc.stdout.readlines()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
    if rc != 0 or not any("params from checkpoint" in ln for ln in lines):
        fail(f"[7x serve] the serve CLI exited {rc}:\n" + "".join(lines)[-3000:])
    say(f"[7x serve] python -m vitax_torch.serve --ckpt_dir ... --epoch -1: "
        + next(ln.strip() for ln in lines if "params from checkpoint" in ln)
        + f"; one /predict answered (top-1 {ans['classes'][0]}), exit 0 on SIGTERM, {time.perf_counter() - t0:.1f} s "
        f"[{card}]")


def phase_transfer(  # vtx: ignore[VTX103] model_flops_per_step is host arithmetic between two timed loads
        torch, card, root: str, ref7: dict) -> dict:
    """Phase 7x: finetune (--reinit_head, --backbone_lr_mult 0.1), probe and
    distill (the export as the teacher) at phase 7's configuration cut to
    depth 2 (TRANSFER) from a seeded bf16 export of that model, each a train() run with its
    launches checked against its steps (the teacher adds a forward a block
    a step), sec/iter, MFU (the student's FLOPs) and peak memory beside
    phase 7's; the warm start bitwise the export at step 0, the probe's
    backbone bitwise the export after its run and its moments the head's,
    the distill events finite with kl >= 0. Then a depth-2 probe run saves
    its epoch, from_checkpoint answers a bucket-8 batch as from_state on
    the trained params, bitwise, and the serve CLI serves the directory.
    Returns the launches of the runs and of the served batches."""
    from vitax_torch.config import Config
    from vitax_torch.models.vit import build_model
    from vitax_torch.ops import _build
    from vitax_torch.programs import get_scenario
    from vitax_torch.programs.workloads import warm_start_from_npz
    from vitax_torch.serve import InferenceEngine
    from vitax_torch.telemetry.flops import model_flops_per_step, peak_tflops
    from vitax_torch.train.loop import train
    from vitax_torch.train.state import make_train_state

    gc.collect()
    torch.cuda.empty_cache()
    npz = os.path.join(root, "transfer_bf16.npz")
    base = Config(seed=TRANSFER_EXPORT_SEED, **TRANSFER).validate()
    t0 = time.perf_counter()
    exported = write_transfer_export(torch, base, npz)
    say(f"[7x export] seeded depth-{base.num_blocks} model (seed {base.seed}) exported in bf16: "
        f"{os.path.getsize(npz) / 1e9:.2f} GB in {time.perf_counter() - t0:.1f} s")

    # the warm start at step 0, as train() makes it: the backbone is the export, the head the fresh init
    cfg = Config(seed=SEED, init_npz=npz, **TRANSFER, **TRANSFER_RUNS[0][1]).validate()
    model = build_model(cfg, "cuda").train()
    fresh_head = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("head.")}
    optimizer, _ = get_scenario(cfg.task).make_optimizer(cfg, cfg.max_steps)
    t0 = time.perf_counter()
    state, info = warm_start_from_npz(cfg, make_train_state(model, optimizer))
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    same = sum(int(torch.equal(p, (fresh_head[n] if n.startswith("head.") else exported[n].to(p.device).float())))
               for n, p in state.model.state_dict().items())
    n_leaves = len(state.model.state_dict())
    say(f"[7x warm start] {info['loaded']} export leaves loaded in {t_warm:.2f} s, head re-initialized "
        f"({info['reinit']}); {same} of {n_leaves} leaves bitwise the export (backbone) or the fresh init (head)")
    if same != n_leaves:
        fail("[7x] the warm start did not load the export bitwise")
    del model, state, optimizer, fresh_head
    gc.collect()
    torch.cuda.empty_cache()

    peak = peak_tflops(torch.cuda.get_device_name(0))
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    for name, flags in TRANSFER_RUNS:
        source = dict(teacher_npz=npz) if name == "distill" else dict(init_npz=npz)
        metrics_dir = os.path.join(root, f"metrics_{name}")
        cfg = Config(seed=SEED, **TRANSFER, **flags, **source, metrics_dir=metrics_dir).validate()
        records = []
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        state = train(cfg, "cuda", records=records)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(_build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps = [r for r in records if "loss" in r]
        losses = [r["loss"] for r in steps]
        want = transfer_launches(cfg, teacher=name == "distill")
        if got != want:
            fail(f"[7x {name}] train() launched {got}; expected {want}")
        if len(steps) != cfg.max_steps or not all(np.isfinite(losses)):
            fail(f"[7x {name}] {len(steps)} steps logged, losses {losses}")
        sec = float(np.median([r["step_seconds"] for r in steps[2:]]))
        mfu = model_flops_per_step(cfg) / sec / (peak * 1e12) if peak else None
        extra = ""
        if name == "probe":
            frozen = sum(int(torch.equal(p, exported[n].to(p.device).float()))
                         for n, p in state.model.named_parameters() if not n.startswith("head."))
            n_backbone = sum(1 for n, _ in state.model.named_parameters() if not n.startswith("head."))
            head_moved = not torch.equal(state.model.head.weight, exported["head.weight"].to("cuda").float())
            extra = (f"; backbone leaves bitwise the export after the run: {frozen} of {n_backbone}, head moved "
                     f"{head_moved}, moments for {sorted(state.mu)}")
            if frozen != n_backbone or not head_moved or sorted(state.mu) != ["head.bias", "head.weight"]:
                fail(f"[7x probe] the backbone moved or the moments are not the head's{extra}")
        if name == "distill":
            _, events = read_jsonl(os.path.join(metrics_dir, "metrics.jsonl"))
            dist = events.get("distill", [])
            kls = [e["kl"] for e in dist]
            extra = (f"; {len(dist)} distill events, kl {kls[0]:.4f} -> {kls[-1]:.4f}, ce {dist[-1]['ce']:.4f}, "
                     f"teacher_top1 {dist[-1]['teacher_top1']:.3f}, student_top1 {dist[-1]['student_top1']:.3f}"
                     if dist else "; no distill event")
            if len(dist) != cfg.max_steps or not all(np.isfinite(k) and k >= 0 for k in kls) or \
                    not all(np.isfinite(e["ce"]) for e in dist):
                fail(f"[7x distill] the distill events are missing, not finite or kl < 0{extra}")
        say(f"[7x {name}] {cfg.max_steps} steps + eval in {wall:.1f} s; losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
            f"sec/iter median of steps 3-12 {sec:.4f} s at depth {cfg.num_blocks} (phase 7 at depth "
            f"{TRAIN['num_blocks']}: {ref7['sec']:.4f}), {cfg.batch_size / sec:.2f} "
            f"images/s, MFU " + (f"{mfu * 100:.2f}%" if mfu is not None else "not measured")
            + f" (student FLOPs); max_memory_allocated {peak_gb:.2f} GB (phase 7 at depth {TRAIN['num_blocks']}: "
            f"{ref7['peak_gb']:.2f}); "
            f"launches A1 {got['flash_attn_fwd']} A2 {got['flash_attn_bwd']} B {got['fused_adamw']}{extra} [{card}]")
        launches = {k: launches[k] + got[k] for k in launches}
        del state
        gc.collect()
        torch.cuda.empty_cache()
    del exported

    # serving a checkpoint directory: a depth-2 probe run saves its epoch
    ckpt_dir = os.path.join(root, "ckpt_serve")
    cfg = Config(seed=SEED, **SERVE_CKPT, ckpt_dir=ckpt_dir).validate()
    _build.reset_launches()
    state = train(cfg, "cuda")
    launches = {k: launches[k] + v for k, v in _build.LAUNCHES.items()}
    t0 = time.perf_counter()
    from_ckpt = InferenceEngine.from_checkpoint(cfg, device="cuda")
    t_load = time.perf_counter() - t0
    in_memory = InferenceEngine.from_state(cfg, dict(state.model.state_dict()), "cuda")
    from_ckpt.warmup()
    in_memory.warmup()
    x = np.random.default_rng(SEED + 9).integers(0, 256, (8, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    _build.reset_launches()
    ids_c, p_c = from_ckpt.predict(x)
    served = dict(_build.LAUNCHES)
    ids_m, p_m = in_memory.predict(x)
    same = bool(np.array_equal(ids_c, ids_m) and np.array_equal(p_c, p_m))
    say(f"[7x serve] from_checkpoint of the depth-2 probe's epoch 1 in {t_load:.2f} s: bucket-8 top-1 "
        f"{ids_c[:, 0].tolist()}, top-{cfg.serve_topk} ids and probs bitwise from_state on the trained params "
        f"{same}; flash_attn_fwd {served['flash_attn_fwd']} launches [{card}]")
    if not same or served["flash_attn_fwd"] != cfg.num_blocks or not np.isfinite(p_c).all():
        fail("[7x serve] from_checkpoint answers other than the trained params, or not through A1")
    launches = {k: launches[k] + served[k] for k in launches}
    del state, from_ckpt, in_memory
    gc.collect()
    torch.cuda.empty_cache()
    serve_checkpoint_cli(ckpt_dir, card)
    os.remove(npz)
    return launches


# Phase 7f: FSDP2 at world size 1. The parity arms run 3 steps of phase 7's
# configuration from its init, on noise_data; the sharded save runs the 10B
# width at depth 2.
FSDP_ARMS = (("ZeRO-3", {}), ("ZeRO-2", dict(reshard_after_forward=False)), ("DP", dict(run_without_fsdp=True)))
FSDP_PARITY_STEPS = 3
TRAIN_FSDP_CKPT = dict(num_blocks=2, batch_size=32, fake_data=True, warmup_steps=4, log_step_interval=1,
                       eval_max_batches=1, steps_per_epoch=2, max_steps=2, num_epochs=1, ckpt_epoch_interval=1)
# A step under FSDP2: the port's kernels; the collectives and FSDP2's
# copy-out (NCCL kernels; at one rank NCCL's all-gather and reduce-scatter,
# and the copy-out of the gathered params, are device-to-device memcpys);
# FSDP2's copy-in before a reduce-scatter (_chunk_cat, casting the bf16
# grads into the f32 buffer); the GEMMs; and the dtype casts: the model's
# (of activations and, unwrapped, of every weight at each use) and FSDP2's
# f32-to-bf16 cast of each shard before its gather, which share kernels.
FSDP_GROUPS = (("flash_attn_fwd", r"flash_attn_fwd"), ("flash_attn_bwd", r"bwd_dkdv|bwd_dq|delta_kernel"),
               ("fused_adamw", r"fused_adamw"), ("collectives and copy-out", r"nccl|Memcpy DtoD"),
               ("FSDP copy-in", r"chunk_cat|split_with_sizes"),
               ("gemm", r"gemm|xmma|nvjet|cutlass|sm90_"), ("casts", r"bfloat16_copy_kernel|direct_copy_kernel"))


def noise_data(cfg) -> tuple:
    """build_datasets' tuple for `cfg` with each train image and label
    drawn from (SEED, index): normal noise, a label of cfg.num_classes.
    Fake data's zero images with label 0 drive the loss and the grad norm
    to 0 after one update; on these every step's loss and norm carry
    information. The val split stays fake."""
    from vitax_torch.data.fake import FakeImageNetDataset
    from vitax_torch.data.loader import ShardedLoader, build_datasets

    class NoiseImageNet(FakeImageNetDataset):
        def __getitem__(self, idx: int):
            rng = np.random.default_rng((SEED, idx))
            s = self.image_size
            return rng.standard_normal((s, s, 3), dtype=np.float32), int(rng.integers(cfg.num_classes))

        def __repr__(self) -> str:
            return f"NoiseImageNet(image_size={self.image_size}, length={self.length})"

    fake, loader, val_ds, val_loader = build_datasets(cfg, "cuda")
    train_ds = NoiseImageNet(cfg.image_size, len(fake))
    return (train_ds, ShardedLoader(train_ds, loader.sampler, "cuda", cfg.num_workers, cfg.prefetch_batches),
            val_ds, val_loader)


def leaf_group(name: str) -> str:
    parts = name.split(".")
    return parts[-2] if len(parts) > 1 else parts[0]


def launch_delta(before: dict) -> dict:
    """The launches counted since the snapshot `before` of _build.LAUNCHES."""
    from vitax_torch.ops import _build
    return {k: _build.LAUNCHES[k] - before.get(k, 0) for k in _build.LAUNCHES}


def moe_train_run(torch, cfg, label: str, card: str):
    """train() of cfg at b16 scale on the card: its launches checked against
    its steps (A1 and A2 per block and step on wgmma, B once a step);
    returns (state, records, launches, sec/iter, peak GB)."""
    from vitax_torch.ops import _build
    from vitax_torch.telemetry.flops import model_flops_per_step, peak_tflops
    from vitax_torch.train.loop import train
    records = []
    torch.cuda.reset_peak_memory_stats()
    before = dict(_build.LAUNCHES)
    state = train(cfg, "cuda", records=records)
    torch.cuda.synchronize()
    launches = launch_delta(before)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = [r for r in records if "loss" in r]
    losses = [r["loss"] for r in steps]
    if len(steps) != cfg.max_steps or not all(np.isfinite(losses)):
        fail(f"7m {label}: {len(steps)} logged steps of {cfg.max_steps}, losses {losses}")
    want = train_run_launches(cfg)
    if launches != want:
        fail(f"7m {label}: train() launched {launches}; expected {want}")
    times = [r["step_seconds"] for r in steps[2:]]
    sec = float(np.median(times)) if times else float(steps[-1]["step_seconds"])
    peak = peak_tflops(torch.cuda.get_device_name(0))
    flops = model_flops_per_step(cfg)
    mfu = f"{flops / sec / (peak * 1e12) * 100:.2f}%" if peak else "not measured (no peak for this card)"
    say(f"[7m train] {label}: {cfg.max_steps} steps, losses " + " ".join(f"{x:.4f}" for x in losses)
        + f"; sec/iter {sec:.4f} (median of steps 3-{cfg.max_steps}; min {min(times or [sec]):.4f}, max "
        f"{max(times or [sec]):.4f}), {cfg.batch_size / sec:.2f} images/s, MFU {mfu} ({flops / 1e12:.3f} TFLOP a "
        f"step), max_memory_allocated {peak_gb:.2f} GB; launches A1 {launches['flash_attn_fwd_wgmma']} A2 "
        f"{launches['flash_attn_bwd_wgmma']} B {launches['fused_adamw']} [{card}]")
    return state, records, launches, sec, peak_gb


def router_choices(torch, model, x) -> list:
    """Each MoE block's first-choice expert per token, (B, N) a block, for
    one inference forward of `model` on x."""
    out, hooks = [], []
    for block in model.blocks:
        hooks.append(block.moe.router.register_forward_hook(
            lambda m, args, y: out.append(y.argmax(dim=-1))))
    try:
        with torch.inference_mode():
            logits = model(x).float()
    finally:
        for h in hooks:
            h.remove()
    return logits, out


def moe_model_check(torch, card) -> None:
    """b16_moe (seeded init, bf16) with the attention kernels against the
    same weights on the plain attention path, both against the float32
    plain model: the kernels' error may be at most MOE_MODEL_RATIO times
    the plain bf16 path's. Prints the tokens whose first-choice expert
    differs from the float32 model's in each."""
    from vitax_torch.config import Config
    from vitax_torch.models.vit import build_model
    from vitax_torch.ops.attention import make_attention_impl
    from vitax_torch.train.step import prepare_images
    cfg = Config(seed=SEED, **B16_MOE).validate()
    model = build_model(cfg, "cuda", attention_impl=make_attention_impl(cfg, "cuda"))
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(rng.integers(0, 256, (8, 224, 224, 3), dtype=np.uint8)).cuda(0)
    x = prepare_images(images)
    got, routes = router_choices(torch, model, x)
    results = {}
    for label, kw in (("plain bf16", dict(use_flash_attention=False)),
                      ("plain f32", dict(use_flash_attention=False, dtype="float32"))):
        other_cfg = Config(seed=SEED, **B16_MOE, **kw).validate()
        other = build_model(other_cfg, "cuda", attention_impl=make_attention_impl(other_cfg, "cuda"), init=False)
        other.load_state_dict(model.state_dict(), assign=True)
        results[label] = router_choices(torch, other, x)
        del other
    want, want_routes = results["plain f32"]
    plain, plain_routes = results["plain bf16"]

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def flips(r):
        return sum(int((a != b).sum()) for a, b in zip(r, want_routes))
    e_k, e_p, e_kp = rel(got, want), rel(plain, want), rel(got, plain)
    tokens = len(routes) * routes[0].numel()
    ok = bool(torch.isfinite(got).all()) and e_k <= MOE_MODEL_RATIO * e_p
    say(f"[7m model] b16_moe, batch 8, max|dlogits|/max|logits| against the float32 plain model: bf16 with the "
        f"kernels {e_k:.3e}, bf16 plain attention {e_p:.3e} (kernels <= {MOE_MODEL_RATIO} x plain) "
        f"{'ok' if ok else 'FAIL'}; kernels against plain bf16 {e_kp:.3e}; first choices off the float32 "
        f"model's: kernels {flips(routes)}, plain {flips(plain_routes)} of {tokens} [{card}]")
    if not ok:
        fail("7m: the MoE model with the kernels is further from the float32 model than the plain bf16 path")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def moe_serve(torch, card, root: str, sd: dict) -> dict:
    """A b16_moe state dict (CPU tensors) exported in float32 and int8 and
    served: each export's engine answers a bucket-8 batch bitwise as
    from_state on the same float weights, the int8 one dequantized at load
    with no kernel C launch. Returns the engines' launches."""
    from vitax_torch.checkpoint.consolidate import load_npz, save_npz
    from vitax_torch.checkpoint.convert import params_from_jax, params_to_jax
    from vitax_torch.config import Config
    from vitax_torch.ops import _build
    from vitax_torch.serve.engine import InferenceEngine
    total = dict.fromkeys(_build.LAUNCHES, 0)
    rng = np.random.default_rng(SEED + 1)
    scfg = Config(seed=SEED, **B16_MOE, serve_max_batch=8).validate()
    batch8 = rng.integers(0, 256, (8, 224, 224, 3), dtype=np.uint8)
    for dtype in ("float32", "int8"):
        path = os.path.join(root, f"b16_moe_{dtype}.npz")
        t0 = time.perf_counter()
        save_npz(path, params_to_jax(sd), dtype=dtype)
        export_s = time.perf_counter() - t0
        qcfg = dataclasses.replace(scfg, serve_quant_dtype="int8") if dtype == "int8" else scfg
        engine = InferenceEngine.from_npz(qcfg, path, "cuda")
        ref = InferenceEngine.from_state(scfg, sd if dtype == "float32" else params_from_jax(load_npz(path)), "cuda")
        engine.warmup()
        ref.warmup()
        before = dict(_build.LAUNCHES)
        ids, probs = engine.predict(batch8)
        launches = launch_delta(before)
        for k, v in launches.items():
            total[k] += v
        ids_r, probs_r = ref.predict(batch8)
        same = np.array_equal(ids, ids_r) and np.array_equal(probs, probs_r)
        c_launches = launches["dequant_matmul"]
        ok = same and c_launches == 0 and launches["flash_attn_fwd_wgmma"] == scfg.num_blocks
        say(f"[7m serve] b16_moe {dtype} export ({os.path.getsize(path) / 1e9:.2f} GB, written in {export_s:.1f}s): "
            f"bucket-8 top-{scfg.serve_topk} {'bitwise' if same else 'NOT equal to'} from_state's; top-1 "
            f"{ids[:, 0].tolist()}; kernel C launches {c_launches}; A1 {launches['flash_attn_fwd_wgmma']} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"7m: the served b16_moe {dtype} export does not answer as from_state, or ran kernel C")
        del engine, ref
        os.remove(path)
        gc.collect()
        torch.cuda.empty_cache()
    return total


def phase_train_moe(  # vtx: ignore[VTX103] the phase's wall clock; each run inside fetches its losses
        torch, card, root: str) -> dict:
    """Phase 7m: b16 and b16_moe timed side by side, the gather and top-2
    arms, the MoE model against the plain attention path, and a b16_moe
    export served in float32 and int8. Returns the launches of its train
    runs and served batches."""
    from vitax_torch.config import Config
    from vitax_torch.models.vit import count_params, expected_param_count
    from vitax_torch.ops import _build
    from vitax_torch.train.state import build_optimizer
    from vitax_torch.train.step import make_train_step
    t_phase = time.perf_counter()
    total = dict.fromkeys(_build.LAUNCHES, 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    # the timed pair
    timed = {}
    for name, kw in (("b16", B16), ("b16_moe", B16_MOE)):
        cfg = Config(seed=SEED, **kw).validate()
        state, records, launches, sec, peak_gb = moe_train_run(torch, cfg, f"{name} "
                                                               f"({expected_param_count(cfg):,} params)", card)
        if count_params(state.model) != expected_param_count(cfg):
            fail(f"7m {name}: the trained model does not have the expected parameter count")
        add(launches)
        optimizer, _ = build_optimizer(cfg, 100)
        train_step = make_train_step(cfg, optimizer, "cuda")
        batch = {"image": torch.zeros((cfg.batch_size, cfg.image_size, cfg.image_size, 3), device="cuda"),
                 "label": torch.zeros(cfg.batch_size, dtype=torch.int64, device="cuda")}
        profile_device(torch, lambda: train_step(state, batch), f"one {name} train step (batch {cfg.batch_size})",
                       card, "7m", top=10)
        del train_step, batch
        timed[name] = (sec, peak_gb, records)
        if name == "b16_moe":               # the trained params, for the served export
            sd = {k: v.detach().to("cpu") for k, v in state.model.state_dict().items()}
        del state
        gc.collect()
        torch.cuda.empty_cache()
    (sec_d, mem_d, _), (sec_m, mem_m, rec_m) = timed["b16"], timed["b16_moe"]
    say(f"[7m train] b16_moe / b16: sec/iter {sec_m / sec_d:.3f}x ({sec_m:.4f} / {sec_d:.4f} s), images/s "
        f"{B16['batch_size'] / sec_m:.2f} / {B16['batch_size'] / sec_d:.2f}, memory {mem_m:.2f} / {mem_d:.2f} GB "
        f"[{card}]")

    # the check arms: gather's first loss is einsum's
    first = rec_m[0]["loss"]
    for label, kw in MOE_ARMS:
        cfg = Config(seed=SEED, **{**B16_MOE, **kw, "max_steps": MOE_ARM_STEPS}).validate()
        arm_state, records, launches, _, _ = moe_train_run(torch, cfg, f"b16_moe {label}", card)
        add(launches)
        del arm_state
        loss0 = records[0]["loss"]
        if label == "gather":
            rel = abs(loss0 - first) / abs(first)
            ok = rel <= MOE_LOSS_RTOL
            say(f"[7m train] gather's first loss {loss0:.6f} against einsum's {first:.6f}: rel {rel:.2e} "
                f"(<= {MOE_LOSS_RTOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail("7m: the gather dispatch's first loss is not the einsum dispatch's")
    gc.collect()
    torch.cuda.empty_cache()

    moe_model_check(torch, card)

    add(moe_serve(torch, card, root, sd))
    say(f"[7m] phase 7m took {time.perf_counter() - t_phase:.1f}s [{card}]")
    return total


def phase_train_fsdp(torch, card, root: str, ref7: dict):
    """Phase 7f: FSDP2 at world size 1 through the port's kernels and NCCL
    (see the module docstring). Returns the launches of its train() runs,
    each read around its run."""
    import torch.distributed as dist
    from vitax_torch.checkpoint import io as ckpt_io
    from vitax_torch.config import Config
    from vitax_torch.models.vit import build_model
    from vitax_torch.ops import _build
    from vitax_torch.ops.attention import make_attention_impl
    from vitax_torch.parallel.mesh import build_mesh
    from vitax_torch.parallel.sharding import apply_fsdp
    from vitax_torch.telemetry.flops import model_flops_per_step, peak_tflops
    from vitax_torch.train.loop import train
    from vitax_torch.train.state import build_optimizer, local, make_train_state
    from vitax_torch.train.step import make_train_step

    cfg = Config(seed=SEED, **TRAIN).validate()
    parity = dataclasses.replace(cfg, max_steps=FSDP_PARITY_STEPS)
    n = cfg.num_blocks
    batch = {"image": torch.zeros((cfg.batch_size, cfg.image_size, cfg.image_size, 3), device="cuda"),
             "label": torch.zeros(cfg.batch_size, dtype=torch.int64, device="cuda")}
    optimizer, _ = build_optimizer(cfg, 100)
    total = dict.fromkeys(_build.LAUNCHES, 0)

    def run(c, label: str, data=None):
        """train(c) with its launches read around it and checked."""
        records = []
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        state = train(c, "cuda", records=records, data=data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        want = train_run_launches(c)
        if launches != want:
            fail(f"7f {label}: train() launched {launches}; expected {want}")
        steps = [r for r in records if "loss" in r]
        if len(steps) != c.max_steps or not all(np.isfinite([r["loss"] for r in steps])):
            fail(f"7f {label}: {len(steps)} steps logged, losses {[r['loss'] for r in steps]}")
        return state, steps, wall, records

    def split(fn, label):
        return profile_device(torch, fn, label, card, "7f", top=24, kernel_groups=FSDP_GROUPS)

    # the unwrapped reference, made before the group exists
    with deterministic_cudnn(torch):
        state, ref_steps, _, _ = run(parity, "unwrapped reference", noise_data(parity))
    ref_params = {name: local(p).detach().cpu() for name, p in state.model.named_parameters()}
    if len({r["loss"] for r in ref_steps}) < len(ref_steps) or not all(r["grad_norm"] > 0 for r in ref_steps):
        fail(f"7f: the parity reference's steps carry no information: "
             f"{[(r['loss'], r['grad_norm']) for r in ref_steps]}")
    split(lambda: make_train_step(cfg, optimizer, "cuda")(state, batch), f"one unwrapped step (batch "
          f"{cfg.batch_size}, depth {n})")
    del state
    gc.collect()
    torch.cuda.empty_cache()

    dist.init_process_group("nccl", init_method=f"file://{os.path.join(root, 'fsdp_store')}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        # ZeRO-3 at phase 7's configuration: timing, launches, the profile
        state, steps, wall, _ = run(cfg, "ZeRO-3")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        times = [r["step_seconds"] for r in steps[2:]]
        sec = float(np.median(times))
        peak = peak_tflops(torch.cuda.get_device_name(0))
        mfu = (model_flops_per_step(cfg) / sec / (peak * 1e12)) if peak else None
        losses = [r["loss"] for r in steps]
        d_loss = max(abs(a - b) for a, b in zip(losses, ref7["losses"]))
        say(f"[7f train] ZeRO-3 (FSDP2, one NCCL rank, bf16 gathers, f32 reduces), 10B width, depth {n}, batch "
            f"{cfg.batch_size}: {cfg.max_steps} steps + eval in {wall:.1f}s; losses "
            + " ".join(f"{x:.4f}" for x in losses) + f"; max |d| to phase 7's losses {d_loss:.3g} "
            f"(phase 7 runs the conv's wgrad nondeterministically)")
        say(f"[7f train] sec/iter median of steps 3-12 {sec:.4f} s (min {min(times):.4f}, max {max(times):.4f}) / "
            f"phase 7 {ref7['sec']:.4f} s ({sec / ref7['sec']:.3f}x); images/s {cfg.batch_size / sec:.2f} / "
            f"{cfg.batch_size / ref7['sec']:.2f}; MFU "
            + (f"{mfu * 100:.2f}% / {ref7['mfu'] * 100:.2f}%" if mfu and ref7["mfu"] else "not measured")
            + f"; max_memory_allocated {peak_gb:.2f} / {ref7['peak_gb']:.2f} GB [{card}]")
        mesh = build_mesh(cfg, torch.device("cuda", 0))
        step = make_train_step(cfg, optimizer, "cuda", mesh)
        _build.reset_launches()
        split(lambda: step(state, batch), f"one ZeRO-3 step (batch {cfg.batch_size}, depth {n})")
        per_step = {k: v // 2 for k, v in _build.LAUNCHES.items()}
        if per_step != step_launches(cfg) or any(v % 2 for v in _build.LAUNCHES.values()):
            fail(f"7f: two steady ZeRO-3 steps launched {dict(_build.LAUNCHES)}; expected "
                 f"{step_launches(cfg)} a step")
        say(f"[7f train] launches per steady ZeRO-3 step {per_step}")
        del state, step
        gc.collect()
        torch.cuda.empty_cache()

        # ZeRO-3, ZeRO-2 and DP from the same init against the unwrapped reference
        for name, arm in FSDP_ARMS:
            acfg = dataclasses.replace(parity, **arm).validate()
            with deterministic_cudnn(torch):
                state, steps, _, _ = run(acfg, name, noise_data(acfg))
            got = [(r["loss"], r["grad_norm"]) for r in steps]
            want = [(r["loss"], r["grad_norm"]) for r in ref_steps]
            worst = {}
            for leaf, p in state.model.named_parameters():
                d = float((local(p).detach() - ref_params[leaf].to("cuda")).abs().max())
                worst[leaf_group(leaf)] = max(worst.get(leaf_group(leaf), 0.0), d)
            same = got == want and not any(worst.values())
            say(f"[7f parity] {name}: losses and grad norms " + ", ".join(f"{a:.9g}/{b:.9g}" for a, b in got)
                + f"; the reference's " + ", ".join(f"{a:.9g}/{b:.9g}" for a, b in want) + "; max |d| of the "
                f"params by leaf group {worst}; bitwise equal: {same}")
            if not same:
                fail(f"7f: {name} at world size 1 differs from the unwrapped run")
            del state
            gc.collect()
            torch.cuda.empty_cache()
        del ref_params

        # a depth-2 sharded save, restored into a new sharded state
        ccfg = Config(seed=SEED, **TRAIN_FSDP_CKPT, ckpt_dir=os.path.join(root, "fsdp_ckpt")).validate()
        state, _, _, records = run(ccfg, "sharded save")
        stall = [r["ckpt_stall_s"] for r in records if "ckpt_stall_s" in r]
        cmesh = build_mesh(ccfg, torch.device("cuda", 0))
        model = apply_fsdp(build_model(ccfg, "meta", attention_impl=make_attention_impl(ccfg, "cuda")), ccfg, cmesh)
        model.to_empty(device="cuda")
        target = make_train_state(model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt_io.restore_state(ccfg.ckpt_dir, 1, target)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        names = [k for k, _ in state.model.named_parameters()]
        same = (target.step == state.step and int(target.count) == int(state.count) and all(
            torch.equal(local(a), local(b)) for k in names
            for a, b in ((dict(state.model.named_parameters())[k], dict(target.model.named_parameters())[k]),
                         (state.mu[k], target.mu[k]), (state.nu[k], target.nu[k]))))
        gb = dir_bytes(ckpt_io.epoch_ckpt_path(ccfg.ckpt_dir, 1)) / 1e9
        say(f"[7f ckpt] depth {ccfg.num_blocks}, ZeRO-3: train() saved epoch 1 ({gb:.2f} GB on disk; the waited "
            f"save held the loop {stall[0]:.2f} s); restore_state into a new sharded state in "
            f"{t_restore:.2f} s, {gb / t_restore:.2f} GB/s; params, mu, nu, count and step bitwise equal: {same} "
            f"[{card}]")
        if not same:
            fail("7f: the sharded checkpoint did not restore bitwise")
        del state, target, model
    finally:
        ckpt_io.close()
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return total


# --- phase 7r: the ring's block products at global offsets (sequence parallelism) ----------

# (label, whole-sequence (B, N, H, Dh), S): the ViT-L/14 shape of the repo's
# own sp configuration (tools/aot_topology.py:207-210: D 1024, 16 heads,
# N 256, batch 32, sp 2; local length 128, the whole-N entry), phase 7L's
# ViT-L width at N 4096 over S 2 (local 2048, the whole-N entry at its
# largest) and at N 9216 over S 4 (local 2304, the streaming entries), and
# the 10B width (N 256, 32 heads of 160, batch 32) over S 2, and b16_moe's
# (phase 7n's: batch 8, N 196, 12 heads of 64) over S 2 and 4 (local 98 and
# 49, partial tiles at global offsets; Ulysses at 6 and 3 heads a rank).
RING_CASES = (("l14_ring_sp", (32, 256, 16, 64), 2), ("ViT-L N 4096", (2, 4096, 16, 64), 2),
              ("ViT-L N 9216", (2, 9216, 16, 64), 4), ("10B width", (32, 256, 32, 160), 2),
              ("b16_moe sp 2", (8, 196, 12, 64), 2), ("b16_moe sp 4", (8, 196, 12, 64), 4))
# The ring (S^2 block products in bf16, merged in f32, their grads summed by
# autograd in bf16 across the blocks and the rotations) against the
# whole-sequence kernel call: max |d| / max |ref| of o and of each of dq, dk,
# dv within phase 3L's bf16 bars (LONG_TOL), at rate 0 and 0.1.
RING_TOL = LONG_TOL["bfloat16"][:2]
# A fresh process whose backward's first CUDA work on autograd's device
# thread is the attention backward (its first node), as phase 7r's first
# case would be alone: the tensor-map encoder finds no context current on
# that thread for card 0 (hopper_common.cuh context_current). argv: the
# shape, then the seed.
FIRST_BACKWARD = """import json, sys
import torch
import chip_smoke as cs
from vitax_torch.ops.attention import flash_attention
q0, k0, v0, do, _ = cs.attention_operands(torch, tuple(json.loads(sys.argv[1])), "bfloat16", int(sys.argv[2]))
leaf = torch.stack((q0, k0, v0), dim=2).requires_grad_(True)
flash_attention(*leaf.unbind(2)).backward(do)
torch.cuda.synchronize()
print("finite" if bool(torch.isfinite(leaf.grad.float()).all()) else "not finite")
"""


def fwd_and_bwd_ms(torch, fn, qkv, do, iters):
    """(forward ms, forward + backward ms) of fn(q, k, v) -> o on views of
    a copy of `qkv` by CUDA events, the backward against `do`."""
    leaf = qkv.clone().requires_grad_(True)

    def fwd():
        with torch.no_grad():
            fn(*leaf.unbind(2))

    def fwd_bwd():
        torch.autograd.grad(fn(*leaf.unbind(2)), leaf, do)
    return time_ms(torch, fwd, iters, warmup=2), time_ms(torch, fwd_bwd, iters, warmup=2)


def phase_ring(torch, card):
    """Phase 7r: the ring body of vitax_torch/parallel/ring_attention.py
    (the sp path's local products and merges) over S virtual shards on the
    one card, its rotation the loop-back over the S chunks (`loop_back_ring`,
    the same body, block products and offsets an sp group runs), at
    RING_CASES, rate 0 and 0.1, bf16: o and dq, dk, dv against the
    whole-sequence kernel call on the full tensors (RING_TOL; under dropout
    the whole-sequence dropout kernel at the same seed, every (q, k) pair
    decided once at global coordinates); the launches of each ring run (S^2
    block products forward and backward, under the whole-N or streaming keys
    by the local length N/S, every one on the wgmma kernels) and S - 1
    rotations a shard; Ulysses' head slices (S calls of the whole-sequence
    core on H/S heads, concatenated) against the whole call at rate 0; the
    ring's forward and forward + backward ms beside the whole call's. The
    launches count the ring runs only. Returns them."""
    from vitax_torch.ops import _build
    from vitax_torch.ops.attention import flash4_dropout, flash_attention, launch_key
    from vitax_torch.ops.flash_blocked import blocked_dropout_attention, blocked_flash_attention
    from vitax_torch.parallel import ring_attention as ra
    torch.backends.cuda.matmul.allow_tf32 = False
    total = {k: 0 for k in _build.LAUNCHES}
    bad = []
    first_shape = RING_CASES[-1][1]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    first = subprocess.Popen([sys.executable, "-c", FIRST_BACKWARD, json.dumps(first_shape), str(SEED + 30)],
                             cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for label, shape, count in RING_CASES:
        b, n, h, dh = shape
        n_loc = n // count
        q0, k0, v0, do, _ = attention_operands(torch, shape, "bfloat16", SEED + 30)
        qkv0 = torch.stack((q0, k0, v0), dim=2)
        long = n > ra.MAX_SEQ_IN_VMEM
        for rate in (0.0, DROP_RATE):
            if rate:
                block = ra.kernel_block_drop(n_loc)

                def whole(q, k, v):
                    return (blocked_dropout_attention(q, k, v, DROP_SEED, rate) if long
                            else flash4_dropout(q, k, v, DROP_SEED, dh ** -0.5, rate))

                def ring(q, k, v):
                    return ra.loop_back_ring(q, k, v, count, block, seed=DROP_SEED, rate=rate)[0]
            else:
                block = ra.kernel_block(n_loc)

                def whole(q, k, v):
                    return blocked_flash_attention(q, k, v) if long else flash_attention(q, k, v)

                def ring(q, k, v):
                    return ra.loop_back_ring(q, k, v, count, block)[0]
            outs = {}
            for name, fn in (("whole", whole), ("ring", ring)):
                leaf = qkv0.clone().requires_grad_(True)
                _build.reset_launches()
                ra.reset_rotations()
                o = fn(*leaf.unbind(2))
                o.backward(do)
                torch.cuda.synchronize()
                outs[name] = (o.detach(), leaf.grad.unbind(2), dict(_build.LAUNCHES), dict(ra.ROTATIONS))
            o_w, g_w, _, _ = outs["whole"]
            o_r, g_r, launches, rotations = outs["ring"]
            total = {k: total[k] + launches[k] for k in total}
            drop = rate > 0
            want = {k: 0 for k in _build.LAUNCHES}
            fkey, bkey = launch_key(n_loc, drop or None, False), launch_key(n_loc, drop or None, True)
            want[fkey] = want[bkey] = want["flash_attn_fwd_wgmma"] = want["flash_attn_bwd_wgmma"] = count * count
            e_o = rel_err(torch, o_r, o_w)
            e_g = [rel_err(torch, a, w) for a, w in zip(g_r, g_w)]
            finite = bool(torch.isfinite(o_r.float()).all()) and all(bool(torch.isfinite(g.float()).all()) for g in g_r)
            ok = (finite and e_o <= RING_TOL[0] and all(e <= RING_TOL[1] for e in e_g) and launches == want
                  and rotations == {"forward": count * (count - 1), "backward": 0})
            say(f"[7r check] {label} {shape} over S {count} (local {n_loc}, {fkey}) rate {rate}: o max|d|/max|ref| "
                f"{e_o:.2e} (<= {RING_TOL[0]}), " + ", ".join(f"{nm} {e:.2e}" for nm, e in zip(("dq", "dk", "dv"), e_g))
                + f" (<= {RING_TOL[1]}); launches {fkey} {launches[fkey]}, {bkey} {launches[bkey]} (S^2 = "
                f"{count * count}, wgmma {launches['flash_attn_fwd_wgmma']}/{launches['flash_attn_bwd_wgmma']}); "
                f"rotations {rotations['forward']} ({count - 1} a shard) {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"{label} rate {rate}: launches {launches}, rotations {rotations}")
            del outs, o_w, g_w, o_r, g_r
            # times: the ring over its S shards against the one whole call
            iters = 5 if long else 10
            times = {}
            for name, fn in (("ring", ring), ("whole", whole), ("whole", whole), ("ring", ring)):
                times.setdefault(name, []).append(fwd_and_bwd_ms(torch, fn, qkv0, do, iters))
            best = {k: (min(t[0] for t in v), min(t[1] for t in v)) for k, v in times.items()}
            say(f"[7r time] {label} rate {rate}: ring forward {best['ring'][0]:.4f} ms, whole {best['whole'][0]:.4f} "
                f"ms ({best['ring'][0] / best['whole'][0]:.2f}x); forward + backward ring {best['ring'][1]:.4f} ms, "
                f"whole {best['whole'][1]:.4f} ms ({best['ring'][1] / best['whole'][1]:.2f}x); turns "
                + ", ".join(f"{k} " + " / ".join(f"{a:.4f}+{c:.4f}" for a, c in v) for k, v in times.items())
                + f" [{card}]")
        # Ulysses on the card: S head slices through the whole-sequence core, concatenated
        hl = h // count
        core = blocked_flash_attention if long else flash_attention
        leaf = qkv0.clone().requires_grad_(True)
        o_u = torch.cat([core(*(x[:, :, j * hl:(j + 1) * hl] for x in leaf.unbind(2))) for j in range(count)], dim=2)
        o_u.backward(do)
        leaf_w = qkv0.clone().requires_grad_(True)
        o_w = core(*leaf_w.unbind(2))
        o_w.backward(do)
        torch.cuda.synchronize()
        e_u = [(a.float() - w.float()).abs().max().item()
               for a, w in zip((o_u, *leaf.grad.unbind(2)), (o_w, *leaf_w.grad.unbind(2)))]
        say(f"[7r check] {label}: Ulysses, {count} head slices of {hl} through {core.vitax_name} against the whole "
            f"call: max|d| o {e_u[0]:.2e}, dq {e_u[1]:.2e}, dk {e_u[2]:.2e}, dv {e_u[3]:.2e}")
        if not all(e <= RING_TOL[1] * w.float().abs().max().item()
                   for e, w in zip(e_u, (o_w, *leaf_w.grad.unbind(2)))):
            bad.append(f"{label} Ulysses head slices")
        del leaf, leaf_w, o_u, o_w, q0, k0, v0, do, qkv0
        torch.cuda.empty_cache()
    try:
        out, _ = first.communicate(timeout=300)
    finally:
        first.kill()
    last = out.strip().splitlines()[-1] if out.strip() else "no output"
    say(f"[7r check] a fresh process's first backward, the whole call at {first_shape} the first node on autograd's "
        f"device thread: exit {first.returncode}, grads {last}")
    if first.returncode != 0 or last != "finite":
        bad.append(f"a fresh process's first backward:\n{out[-3000:]}")
    if bad:
        fail(f"7r: the ring's block products disagree with the whole-sequence call: {bad}")
    return total


# --- phase 7p: tensor parallelism's Block over tp groups on the one card ----------------

# The 10B width (Config's defaults: D 5120, 32 heads of 160, MLP 20480) at
# phase 7's train shape, batch 32 and N 256, over tp groups of S ranks (16
# and 8 local heads); bf16 compute over f32 params, as train() runs it.
# NCCL refuses two ranks on one device, so the ranks are processes on the
# one card joined over gloo, which carries every collective of the tp
# Block on CUDA tensors (through the host): models/vit.py's Block with a
# TensorShard, parallel/tensor_parallel.py's relayout and conjugate pair
# as train() runs them.
TP_WIDTH = dict(embed_dim=5120, num_heads=32, mlp_ratio=4.0)
TP_INPUT = (32, 256)                     # batch, tokens
TP_SHARDS = (2, 4)
TP_RANKS = max(TP_SHARDS)                # one torchrun; a group of 2 is ranks 0 and 1
# Bars: the sharded Block changes only where the bf16 products are summed
# (each rank's row-parallel partial is rounded to bf16 and the S partials
# summed by the all-reduce, the bias added after), so its output and every
# grad sit within bf16 rounding of the whole Block's: each leaf's grad (a
# Megatron leaf's against the whole grad's piece) and the input's grad
# within phase 5's grad bar (MODEL_GRAD_REL_TOL); the output, a bf16
# residual stream whose two adds may each round a partial sum's last-bit
# difference to one ulp of its largest value (2^-7 of it), within the
# ring's bf16 bar for o (RING_TOL, 1.6e-2 > 2 ulps). Phase 5's logits bar
# (6e-3, for f32 logits) is too tight here: the output read 9.6e-3 at
# every S and rate on an H100 80GB HBM3 at 700 W, one to two ulps of its
# largest value.
TP_TOL = (RING_TOL[0], MODEL_GRAD_REL_TOL)

# The train CLI at tp 2 on the one card: two ranks on cuda:0 (torchrun of
# TP_CLI_MAIN, which joins a gloo group before the CLI's main), phase 7t's
# configuration (the 10B width at depth 2) at batch 8 for 3 steps, against
# one process at tp 1, in float32 and in bf16. float32: each step's loss
# and grad norm within phase 5's loss bar (MODEL_LOSS_REL_TOL) of the tp-1
# run's; its roundings are 2^16 times finer than bf16's, so the bar catches
# a wrong head or feature and not the rounding (the CPU tests hold the same
# arithmetic to vitax's within 5e-7). bf16 (the default dtype, the wgmma
# kernels): tp rounds each row-parallel partial to bf16 before the sum and
# adds the bias after it, so its numbers move off tp 1's by bf16 ulps
# (3.3e-4 of the step-1 loss on an H100 80GB HBM3 at 700 W, past the f32
# bar). Its bar is set from bf16 readings: each of the 3 losses and 3 grad
# norms of tp 2 in bf16 lies within TP_BF16_FACTOR times tp-1-bf16's
# relative distance from the float32 tp-1 run's same number (that distance
# floored at MODEL_LOSS_REL_TOL): the two bf16 runs round alike, so each
# lies about as far from float32 as the other. Each number is held to its
# own distance: the step-3 loss, near 0 once the fake images (zeros, label
# 0) are learnt, sits 16% off float32 in both bf16 runs, the step-1 loss
# 4-8e-4 (same card). A long warmup (100) keeps the float32 steps from
# driving the loss to 0 (at phase 7t's warmup of 4 it reached 0 within two
# steps, which broke the relative check).
TP_CLI = ["--fake_data", "--num_blocks", "2", "--batch_size", "8", "--max_steps", "3", "--warmup_steps", "100",
          "--log_step_interval", "1", "--num_workers", "2"]
TP_BF16_FACTOR = 3.0
# torchrun's ranks on one card: a gloo group made before the CLI's main (which
# then joins it, distributed.maybe_initialize), each rank's kernel launches
# and its allocator's peak reserved bytes written beside the JSONL; under
# SMOKE_SEEDED_FAKE, the fake data's rows are seeded_fake_item's. argv: the launches dir, then the CLI's flags.
TP_CLI_MAIN = """import json, os, sys
import torch
import torch.distributed as dist
from vitax_torch.ops import _build
from vitax_torch.parallel import pipeline
from vitax_torch.train.__main__ import main
if os.environ.get("SMOKE_SEEDED_FAKE"):
    from chip_smoke import seeded_fake_item
    from vitax_torch.data.fake import FakeImageNetDataset
    FakeImageNetDataset.__getitem__ = seeded_fake_item
if "WORLD_SIZE" in os.environ:
    dist.init_process_group("gloo", init_method="env://")
rc = main(sys.argv[2:])
rank = os.environ.get("RANK", "0")
with open(os.path.join(sys.argv[1], "launches%s.json" % rank), "w") as f:
    json.dump(_build.LAUNCHES, f)
with open(os.path.join(sys.argv[1], "memory%s.json" % rank), "w") as f:
    json.dump({"max_memory_reserved": torch.cuda.max_memory_reserved() if torch.cuda.is_initialized() else 0}, f)
with open(os.path.join(sys.argv[1], "hops%s.json" % rank), "w") as f:
    json.dump(pipeline.HOPS, f)
sys.exit(rc)
"""


def tp_cores(torch, dh: int, count: int, rate: float):
    """(the whole Block's core, a shard's core): the whole-N kernel entry,
    and under dropout the dropout kernel, the whole Block's running each
    head group at that group's tp-folded seed (train/step.py folds the tp
    index into the attention seed; the kernel sees local head indices)."""
    from vitax_torch.ops.attention import flash4_dropout, flash_attention, fold_shard_seed
    scale = dh ** -0.5

    def shard_core(q, k, v):
        return flash_attention(q, k, v)

    def whole_core(q, k, v):
        return flash_attention(q, k, v)
    shard_core.vitax_dropout = lambda q, k, v, s: flash4_dropout(q, k, v, s, scale, rate)

    def whole_drop(q, k, v, s):
        hl = q.shape[2] // count
        return torch.cat([flash4_dropout(*(x[:, :, t * hl:(t + 1) * hl] for x in (q, k, v)),
                                         fold_shard_seed(t, s), scale, rate) for t in range(count)], dim=2)
    whole_core.vitax_dropout = whole_drop
    return whole_core, shard_core


def wall_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Host-clock ms a call of fn, the card synchronized around the loop
    (gloo's collectives block the host, so CUDA events alone would miss
    nothing but would not say so)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def tp_block_rank(out_dir: str) -> int:
    """One rank of phase 7p's torchrun (TP_RANKS processes on the one card,
    joined over gloo): for S in TP_SHARDS and att_dropout 0 and 0.1, ranks
    below S build the whole Block and its piece for tp rank `rank` of S
    (models/vit.py Block with a TensorShard over the group of ranks 0..S-1;
    its Megatron leaves the rank's contiguous pieces of the whole Block's,
    as parallel/sharding.py shard_tp cuts them), run both on the same bf16
    input and grad, and write to out_dir/rank<r>.json the output's and
    every grad's distance from the whole Block's, the kernel launches and
    tp collectives of the sharded run alone, and the ms of the sharded
    forward and forward + backward (all S ranks at once), of the whole
    Block's (rank 0 alone) and of one all-reduce of the block's output."""
    import torch
    import torch.distributed as dist
    from torch import nn

    from vitax_torch.models.vit import Block
    from vitax_torch.ops import _build
    from vitax_torch.ops.attention import fold_shard_seed
    from vitax_torch.parallel import tensor_parallel as tpm
    from vitax_torch.parallel.mesh import TensorShard
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    rank, world = dist.get_rank(), dist.get_world_size()
    groups = {s: dist.group.WORLD if s == world else dist.new_group(list(range(s))) for s in TP_SHARDS}
    torch.backends.cuda.matmul.allow_tf32 = False
    d, h, ratio = TP_WIDTH["embed_dim"], TP_WIDTH["num_heads"], TP_WIDTH["mlp_ratio"]
    b, n = TP_INPUT
    rng = np.random.default_rng(SEED + 40)
    x0 = torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32)).to("cuda", torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32)).to("cuda", torch.bfloat16)
    results = []
    for count in TP_SHARDS:
        for rate in (0.0, DROP_RATE):
            mine = rank < count
            res = {"count": count, "rate": rate}
            if mine:
                whole_core, shard_core = tp_cores(torch, d // h, count, rate)
                torch.manual_seed(SEED + 41)
                whole = Block(d, h, ratio, torch.bfloat16, whole_core, device="cuda", att_dropout=rate)
                with torch.no_grad():           # the products' weights and biases drawn; the norms 1 and 0
                    for name, p in whole.named_parameters():
                        if not name.startswith("norm"):
                            p.normal_(0.0, 0.02)
                part = Block(d, h, ratio, torch.bfloat16, shard_core, device="meta", att_dropout=rate,
                             tensor_shard=TensorShard(rank, count, groups[count]))
                whole_params = dict(whole.named_parameters())
                for name, _ in list(part.named_parameters()):
                    module, leaf = part.get_submodule(name.rpartition(".")[0]), name.rpartition(".")[2]
                    piece = tpm.tp_local(name, whole_params[name].detach(), count, rank)
                    setattr(module, leaf, nn.Parameter(piece.clone()))
                seed = DROP_SEED if rate else None
                shard_seed = fold_shard_seed(rank, DROP_SEED) if rate else None
                x = x0.clone().requires_grad_(True)
                y = whole(x, seed)
                names = list(whole_params)
                ref = dict(zip(["x", *names], torch.autograd.grad(y, [x, *whole.parameters()], dy)))
                y_ref = y.detach()
                del y
                x2 = x0.clone().requires_grad_(True)
                torch.cuda.synchronize()
                _build.reset_launches()
                tpm.reset_calls()
                y2 = part(x2, shard_seed)
                got = dict(zip(["x", *names], torch.autograd.grad(y2, [x2, *part.parameters()], dy)))
                torch.cuda.synchronize()
                res["launches"], res["calls"] = dict(_build.LAUNCHES), dict(tpm.CALLS)
                res["finite"] = bool(torch.isfinite(y2.float()).all()) and all(
                    bool(torch.isfinite(g.float()).all()) for g in got.values())
                res["out"] = rel_err(torch, y2.detach(), y_ref)
                res["x"] = rel_err(torch, got["x"], ref["x"])
                res["leaves"] = {nm: rel_err(torch, got[nm], tpm.tp_local(nm, ref[nm], count, rank))
                                 for nm in names}
                del y2, got, ref, y_ref
            dist.barrier()
            # the whole Block on rank 0 alone, then the S ranks' sharded Block at once
            if rank == 0:
                leaf = x0.clone().requires_grad_(True)
                with torch.no_grad():
                    res["whole_fwd_ms"] = wall_ms(torch, lambda: whole(x0, seed), 5)
                res["whole_ms"] = wall_ms(torch, lambda: whole(leaf, seed).backward(dy), 5)
            dist.barrier()
            if mine:
                group = groups[count]
                leaf = x0.clone().requires_grad_(True)
                with torch.no_grad():
                    res["fwd_ms"] = wall_ms(torch, lambda: part(x0, shard_seed), 3)
                res["ms"] = wall_ms(torch, lambda: part(leaf, shard_seed).backward(dy), 3)
                res["all_reduce_ms"] = wall_ms(torch, lambda: dist.all_reduce(x0.clone(), group=group), 3)
                del whole, part, leaf
            dist.barrier()
            gc.collect()
            torch.cuda.empty_cache()
            results.append(res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def tp_block_cmd(root: str, env: dict):
    """Phase 7p's tp Block torchrun (TP_RANKS ranks of tp_block_rank on the
    card over gloo), as a (name, argv, env) of run_cli."""
    out_dir = os.path.join(root, "tp_block")
    os.makedirs(out_dir)
    return ("tp block", [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                         str(TP_RANKS), os.path.join(REPO, "chip_smoke.py"), "--tp-block-rank", out_dir], env)


def phase_tp(card, root: str, result):
    """Phase 7p's tp Block: models/vit.py's Block with a TensorShard over real
    tp groups (the sharded qkv, parallel/tensor_parallel.py's relayout to
    whole heads, the attention core on the H/S local heads, the row-parallel
    proj and fc2 partials all-reduced before the replicated biases) at the
    10B width and phase 7's shape, S 2 and 4, att_dropout 0 and 0.1, from
    the torchrun of tp_block_cmd (`result`: run_cli's). On every rank the
    output and the grads of the input and of every leaf against the whole
    Block on the same bf16 input (TP_TOL); one forward and one backward
    launch a rank a sharded run, on the wgmma kernels (under the dropout
    keys at 0.1), and one relayout; the ms of the sharded and the whole
    Block. Returns the launches of the sharded runs, summed over the
    ranks."""
    from vitax_torch.ops import _build
    out_dir = os.path.join(root, "tp_block")
    r, wall = result
    if r.returncode != 0:
        fail(f"[7p] the tp Block's torchrun exited {r.returncode}:\n{proc_tail(r)}")
    ranks = []
    for rank in range(TP_RANKS):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    d, h, b, n = TP_WIDTH["embed_dim"], TP_WIDTH["num_heads"], *TP_INPUT
    total = {k: 0 for k in _build.LAUNCHES}
    bad = []
    for i, first in enumerate(ranks[0]):
        count, rate = first["count"], first["rate"]
        mine = [rr[i] for rr in ranks[:count]]
        drop = rate > 0
        fkey, bkey = ("flash_attn_fwd_drop", "flash_attn_bwd_drop") if drop else ("flash_attn_fwd", "flash_attn_bwd")
        want_l = {k: 0 for k in _build.LAUNCHES}
        want_l[fkey] = want_l[bkey] = want_l["flash_attn_fwd_wgmma"] = want_l["flash_attn_bwd_wgmma"] = 1
        launches = {k: sum(m["launches"][k] for m in mine) for k in total}
        total = {k: total[k] + launches[k] for k in total}
        e_out, e_x = max(m["out"] for m in mine), max(m["x"] for m in mine)
        worst_rank = max(mine, key=lambda m: max(m["leaves"].values()))
        worst = max(worst_rank["leaves"], key=worst_rank["leaves"].get)
        e_leaf = worst_rank["leaves"][worst]
        ok = (all(m["finite"] and m["launches"] == want_l and m["calls"]["relayout"] == 1
                  and m["calls"]["all_reduce"] == 2 for m in mine)
              and e_out <= TP_TOL[0] and e_x <= TP_TOL[1] and e_leaf <= TP_TOL[1])
        say(f"[7p check] 10B width (B {b}, N {n}, D {d}, H {h}) over tp {count} ({h // count} heads, "
            f"{int(d * TP_WIDTH['mlp_ratio']) // count} MLP features a rank; {count} processes on one card over "
            f"gloo) rate {rate}: out max|d|/max|ref| {e_out:.2e} (<= {TP_TOL[0]}), dx {e_x:.2e}, worst leaf "
            f"{worst} {e_leaf:.2e} (<= {TP_TOL[1]}); launches {fkey} {launches[fkey]}, {bkey} {launches[bkey]} "
            f"(1 a rank, wgmma {launches['flash_attn_fwd_wgmma']}/{launches['flash_attn_bwd_wgmma']}); relayouts "
            f"{sum(m['calls']['relayout'] for m in mine)}, all-reduces {sum(m['calls']['all_reduce'] for m in mine)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(f"tp {count} rate {rate}: out {e_out:.2e}, dx {e_x:.2e}, {worst} {e_leaf:.2e}, launches "
                       f"{[{k: v for k, v in m['launches'].items() if v} for m in mine]}, calls "
                       f"{[m['calls'] for m in mine]}")
        say(f"[7p time] 10B width over tp {count} rate {rate}: sharded Block (the {count} ranks at once, gloo "
            f"through the host, beside the CLI runs of its wave) forward {first['fwd_ms']:.3f} ms, forward + backward {first['ms']:.3f} ms; whole "
            f"Block alone forward {first['whole_fwd_ms']:.3f} ms, forward + backward {first['whole_ms']:.3f} ms "
            f"({first['ms'] / first['whole_ms']:.2f}x); one gloo all-reduce of the ({b}, {n}, {d}) bf16 output "
            f"{first['all_reduce_ms']:.3f} ms (2 a forward, 2 a backward) [{card}]")
    if bad:
        fail(f"7p: the tp Block disagrees with the whole Block: {bad}")
    say(f"[7p] the tp Block's torchrun ({TP_RANKS} ranks on one card) exited 0 in {wall:.1f} s")
    return total


def proc_tail(r) -> str:
    """A failed run's last output and every line its rank 0 wrote to stderr
    (torchrun tags them; a peer's error that follows rank 0's death would
    push rank 0's own out of a plain tail)."""
    rank0 = [ln for ln in r.stderr.splitlines() if ln.startswith("[rank0]")]
    return f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}" + ("\nrank 0:\n" + "\n".join(rank0[-60:]) if rank0 else "")


def run_cli(cmds, timeout: float):
    """Start every (name, argv, env) at once and wait for all; kills the
    rest if one overruns. {name: (CompletedProcess-like, wall s)}."""
    procs, out = {}, {}
    t0 = time.perf_counter()
    try:
        for name, argv, env in cmds:
            procs[name] = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True, start_new_session=True)
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            out[name] = (subprocess.CompletedProcess(p.args, p.returncode, stdout, stderr),
                         time.perf_counter() - t0)
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    return out


def tp_cli_cmds(root: str, main_py: str, env: dict) -> list:
    """Phase 7p's four train CLI runs as run_cli commands: torchrun of
    TP_CLI_MAIN at `--tp_size 2` (both ranks on the one card over gloo) and
    one process at tp 1 on the same flags (TP_CLI), in float32 and bf16.
    The tp-1 runs are phase 7q's pp-1 runs too (PP_CLI is TP_CLI)."""
    cmds = []
    for tp in (1, 2):
        for dtype in ("float32", "bfloat16"):
            d = os.path.join(root, f"tp{tp}_{dtype}")
            os.makedirs(d)
            launcher = ([sys.executable] if tp == 1 else
                        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2"])
            extra = [] if tp == 1 else ["--device", "cuda:0", "--tp_size", "2"]
            cmds.append(((tp, dtype), [*launcher, main_py, d, *TP_CLI, "--dtype", dtype, *extra,
                                       "--metrics_dir", d], env))
    return cmds


def tp_cli(root: str, card: str, results: dict) -> dict:
    """Phase 7p's train CLI runs (tp_cli_cmds, `results` run_cli's): exit
    0, the tp log line, and each step's loss and grad norm (rank 0's JSONL)
    of tp 2 against tp 1 within its dtype's bar (TP_BF16_FACTOR in bf16).
    Every rank writes its launches: the bf16 tp-2 run launches every
    attention call on the wgmma kernels. Returns the bf16 tp-2 run's
    launches, summed over its ranks."""
    from vitax_torch.ops import _build
    runs = {}
    for (tp_, dtype), (r, wall) in ((k, v) for k, v in results.items() if isinstance(k, tuple)):
        name = f"tp {tp_} {dtype}"
        if r.returncode != 0 or "training begins" not in r.stdout:
            fail(f"[7p cli] {name} exited {r.returncode}:\n{proc_tail(r)}")
        if tp_ == 2 and "tensor parallel: tp 2, 16 heads" not in r.stdout:
            fail(f"[7p cli] the {name} run does not say it runs 16 heads a rank:\n{r.stdout[-3000:]}")
        d = os.path.join(root, f"tp{tp_}_{dtype}")
        steps, _ = read_jsonl(os.path.join(d, "metrics.jsonl"))
        launches = {k: 0 for k in _build.LAUNCHES}
        for rank in range(tp_):
            with open(os.path.join(d, f"launches{rank}.json")) as f:
                for k, v in json.load(f).items():
                    launches[k] += v
        runs[(tp_, dtype)] = ([s["loss"] for s in steps] + [s["grad_norm"] for s in steps], wall, launches)

    def rel_dist(a, b):
        return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))

    def fmt(v):
        return f"losses {' '.join(f'{x:.6f}' for x in v[:3])}, grad norms {' '.join(f'{x:.6f}' for x in v[3:])}"
    f32, f32_tp2 = runs[(1, "float32")][0], runs[(2, "float32")][0]
    b16, b16_tp2 = runs[(1, "bfloat16")][0], runs[(2, "bfloat16")][0]
    if not all(len(v) == 6 and all(np.isfinite(v)) for v in (f32, f32_tp2, b16, b16_tp2)):
        fail(f"7p: a CLI run did not log 3 finite steps: {runs}")
    e32 = rel_dist(f32_tp2, f32)
    ok32 = e32 <= MODEL_LOSS_REL_TOL
    # each number's distance from float32 tp 1 over its bar: tp-1-bf16's distance times the factor
    ratios = [rel_dist([t2], [w]) / (TP_BF16_FACTOR * max(rel_dist([t1], [w]), MODEL_LOSS_REL_TOL))
              for t2, t1, w in zip(b16_tp2, b16, f32)]
    e_b1, e_b2 = rel_dist(b16, f32), rel_dist(b16_tp2, f32)
    lb = runs[(2, "bfloat16")][2]
    wgmma = (lb["flash_attn_fwd"] > 0 and lb["flash_attn_fwd_wgmma"] == lb["flash_attn_fwd"]
             and lb["flash_attn_bwd"] > 0 and lb["flash_attn_bwd_wgmma"] == lb["flash_attn_bwd"])
    ok16 = max(ratios) <= 1.0 and wgmma
    walls = " / ".join(f"tp {k[0]} {k[1]} {v[1]:.1f}" for k, v in sorted(runs.items()))
    say(f"[7p cli] train CLI, 10B width at depth 2, batch 8, 3 steps, tp 2 = torchrun, 2 ranks on one card over "
        f"gloo. float32: tp 2 {fmt(f32_tp2)}; tp 1 {fmt(f32)}; rel diff max {e32:.2e} (<= {MODEL_LOSS_REL_TOL}) "
        f"{'ok' if ok32 else 'FAIL'}. bf16: tp 2 {fmt(b16_tp2)}; tp 1 {fmt(b16)}; rel distance from float32 "
        f"tp 1, max over the six: tp 2 {e_b2:.2e}, tp 1 {e_b1:.2e}; each of tp 2's over {TP_BF16_FACTOR} x "
        f"max(tp 1's, {MODEL_LOSS_REL_TOL}): {' '.join(f'{r:.2f}' for r in ratios)} (<= 1); tp 2 bf16 launches fwd {lb['flash_attn_fwd']} (wgmma {lb['flash_attn_fwd_wgmma']}), bwd "
        f"{lb['flash_attn_bwd']} (wgmma {lb['flash_attn_bwd_wgmma']}) {'ok' if ok16 else 'FAIL'}; exit 0, wall s "
        f"(the runs of its wave at once) {walls} [{card}]")
    if not ok32:
        fail(f"7p: the float32 train CLI at tp 2 does not train tp 1's losses and grad norms: {f32_tp2} against {f32}")
    if not ok16:
        fail(f"7p: the bf16 train CLI at tp 2 lies past its bar from float32 tp 1 ({ratios}) or left the wgmma "
             f"kernels: {lb}")
    return lb


# --- phase 7q: pipeline parallelism through the train CLI on the one card ------
# The train CLI at pp 2 (TP_CLI_MAIN under torchrun, both stages on cuda:0
# over gloo, whose stage hops go through host buffers: NCCL refuses two
# ranks on one device) against one process at pp 1: the 10B width at depth
# 2 (a block a stage; TP_CLI's runs, so 7p's tp-1 runs are the pp-1 ones),
# batch 8, 3 steps and long warmup. The
# float32 runs (GPipe M 2 and M 4, 1F1B M 4) train pp 1's losses and grad
# norms within phase 5's loss bar (the pipeline changes only the order of
# the microbatches' sums); bf16 GPipe is held as 7p holds tp in bf16 (each
# number within TP_BF16_FACTOR times pp-1-bf16's distance from float32 pp
# 1); bf16 GPipe under att_dropout 0.1 draws other masks than pp 1 (seeds
# per microbatch) and is held to finite numbers and its launches. The runs
# share the card with the rest of their wave (GROUP_WAVES), so their
# sec/iter time gloo through the host and the other runs, not the pipeline.
PP_CLI = TP_CLI
PP_STEPS = 3
PP_RUNS = {"pp 1 float32": (1, "float32", []),
           "pp 1 bf16": (1, "bfloat16", []),
           "gpipe M 2 float32": (2, "float32", ["--pp_size", "2"]),
           "gpipe M 4 float32": (2, "float32", ["--pp_size", "2", "--pp_microbatches", "4"]),
           "1f1b M 4 float32": (2, "float32", ["--pp_size", "2", "--pp_microbatches", "4", "--pp_schedule", "1f1b"]),
           "gpipe M 2 bf16": (2, "bfloat16", ["--pp_size", "2"]),
           "gpipe M 2 bf16 att_dropout": (2, "bfloat16", ["--pp_size", "2", "--att_dropout", str(DROP_RATE)])}
# the pp-1 runs are 7p's tp-1 runs (their dirs); the pp-2 runs follow in two
# waves of 6 and 4 ranks: a pp-2 rank at depth 2 holds about 7 GB of the card,
# and all ten at once ran out of its 80 (an H100 80GB HBM3)
PP_SHARED = {"pp 1 float32": "tp1_float32", "pp 1 bf16": "tp1_bfloat16"}
PP_WAVES = (("gpipe M 2 float32", "gpipe M 4 float32", "1f1b M 4 float32"),
            ("gpipe M 2 bf16", "gpipe M 2 bf16 att_dropout"))


def pp_predicted(flags, dtype: str, rank: int, ranks: int) -> tuple:
    """(launches, hops) a rank of a 7q run must count over its PP_STEPS
    steps under none_saveable: Lps M 2 attention forwards (each block's
    forward and its recompute) and Lps M backwards a step, on the wgmma
    kernels in bf16 (their dropout keys under att_dropout), one fused_adamw
    a step; a stage sends M activations a step forward, M cotangents
    back."""
    blocks = int(PP_CLI[PP_CLI.index("--num_blocks") + 1]) // ranks
    m = int(flags[flags.index("--pp_microbatches") + 1]) if "--pp_microbatches" in flags else ranks
    drop = "--att_dropout" in flags
    fkey, bkey = ("flash_attn_fwd_drop", "flash_attn_bwd_drop") if drop else ("flash_attn_fwd", "flash_attn_bwd")
    kernel = "wgmma" if dtype == "bfloat16" else "general"
    want = {fkey: 2 * blocks * m * PP_STEPS, bkey: blocks * m * PP_STEPS, "fused_adamw": PP_STEPS}
    want.update({f"flash_attn_fwd_{kernel}": want[fkey], f"flash_attn_bwd_{kernel}": want[bkey]})
    hops = {"forward": m * PP_STEPS * (rank < ranks - 1), "backward": m * PP_STEPS * (rank > 0)}
    return want, hops


def pp_dir(root: str, name: str) -> str:
    return os.path.join(root, PP_SHARED.get(name, "pp_" + name.replace(" ", "_")))


def pp_cmds(root: str, main_py: str, env: dict, names) -> list:
    """Phase 7q's pp-2 runs `names` (of PP_RUNS; the pp-1 ones are 7p's tp-1
    runs) as run_cli commands."""
    cmds = []
    for name in names:
        ranks, dtype, flags = PP_RUNS[name]
        d = pp_dir(root, name)
        os.makedirs(d)
        cmds.append((name, [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                            str(ranks), main_py, d, *PP_CLI, "--dtype", dtype, *flags, "--device", "cuda:0",
                            "--metrics_dir", d], env))
    return cmds


def phase_pp(root: str, card: str, results: dict) -> dict:
    """Phase 7q: the PP_RUNS through the train CLI (`results`: run_cli's of
    both waves; the pp-1 runs are 7p's tp-1 ones): exit 0, the pipeline's
    log line, each step's loss and grad norm from rank 0's JSONL (the last
    stage's loss, the global norm) within its bar, each rank's launches and
    hops as pp_predicted says, and each run's sec/iter. Returns the bf16
    pp-2 runs' launches, summed over their ranks."""
    from vitax_torch.ops import _build
    runs, bad = {}, []
    shared = {name: results[(1, dtype)] for name, (_, dtype, _) in PP_RUNS.items() if name in PP_SHARED}
    for name, (r, wall) in {**shared, **{k: v for k, v in results.items() if k in PP_RUNS}}.items():
        ranks, dtype, flags = PP_RUNS[name]
        if r.returncode != 0 or "training begins" not in r.stdout:
            fail(f"[7q] {name} exited {r.returncode}:\n{proc_tail(r)}")
        if ranks > 1 and f"pipeline: pp {ranks}" not in r.stdout:
            fail(f"[7q] the {name} run does not log its pipeline:\n{r.stdout[-3000:]}")
        d = pp_dir(root, name)
        steps, _ = read_jsonl(os.path.join(d, "metrics.jsonl"))
        launches = {k: 0 for k in _build.LAUNCHES}
        for rank in range(ranks):
            with open(os.path.join(d, f"launches{rank}.json")) as f:
                mine = json.load(f)
            with open(os.path.join(d, f"hops{rank}.json")) as f:
                hops = json.load(f)
            want, want_hops = pp_predicted(flags, dtype, rank, ranks)
            got = {k: v for k, v in mine.items() if v}
            if got != want or (ranks > 1 and hops != want_hops):
                bad.append(f"{name} rank {rank}: launches {got} (predicted {want}), hops {hops} (predicted "
                           f"{want_hops})")
            for k, v in mine.items():
                launches[k] += v
        # sec/iter as logged (smoothed over every step, the first included) and the last step's
        # seconds between its record and the one before (each log step waits for its step)
        runs[name] = ([s["loss"] for s in steps] + [s["grad_norm"] for s in steps], wall,
                      (steps[-1]["sec_per_iter"], steps[-1]["time"] - steps[-2]["time"]), launches)
    if bad:
        fail(f"7q: launches or hops off the schedule's: {bad}")

    def rel_dist(a, b):
        return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))

    def fmt(v):
        return f"losses {' '.join(f'{x:.6f}' for x in v[:3])}, grad norms {' '.join(f'{x:.6f}' for x in v[3:])}"
    if not all(len(v[0]) == 2 * PP_STEPS and all(np.isfinite(v[0])) for v in runs.values()):
        fail(f"7q: a CLI run did not log {PP_STEPS} finite steps: {runs}")
    f32, b16 = runs["pp 1 float32"][0], runs["pp 1 bf16"][0]
    for name in ("gpipe M 2 float32", "gpipe M 4 float32", "1f1b M 4 float32"):
        e = rel_dist(runs[name][0], f32)
        say(f"[7q cli] {name} (pp 2, both stages on one card over gloo): {fmt(runs[name][0])}; pp 1: {fmt(f32)}; "
            f"rel diff max {e:.2e} (<= {MODEL_LOSS_REL_TOL}) {'ok' if e <= MODEL_LOSS_REL_TOL else 'FAIL'} [{card}]")
        if e > MODEL_LOSS_REL_TOL:
            bad.append(f"{name}: {runs[name][0]} against pp 1's {f32}")
    b16_pp2 = runs["gpipe M 2 bf16"][0]
    ratios = [rel_dist([t2], [w]) / (TP_BF16_FACTOR * max(rel_dist([t1], [w]), MODEL_LOSS_REL_TOL))
              for t2, t1, w in zip(b16_pp2, b16, f32)]
    say(f"[7q cli] gpipe M 2 bf16: {fmt(b16_pp2)}; pp 1 bf16 {fmt(b16)}; rel distance from float32 pp 1, max over "
        f"the six: pp 2 {rel_dist(b16_pp2, f32):.2e}, pp 1 {rel_dist(b16, f32):.2e}; each of pp 2's over "
        f"{TP_BF16_FACTOR} x max(pp 1's, {MODEL_LOSS_REL_TOL}): {' '.join(f'{r:.2f}' for r in ratios)} (<= 1) "
        f"{'ok' if max(ratios) <= 1.0 else 'FAIL'}; under att_dropout {DROP_RATE}: "
        f"{fmt(runs['gpipe M 2 bf16 att_dropout'][0])} [{card}]")
    if max(ratios) > 1.0:
        bad.append(f"gpipe M 2 bf16 lies past its bar from float32 pp 1: {ratios}")
    for name, (_, wall, (sec, last), launches) in runs.items():
        ranks, dtype, flags = PP_RUNS[name]
        att = {k: v for k, v in launches.items() if k.startswith("flash_attn") and v}
        how = "one process" if ranks == 1 else "two ranks on one card, hops and collectives over gloo via the host"
        say(f"[7q time] {name}: sec/iter {sec:.4f} (as logged: smoothed over the {PP_STEPS} steps, the first "
            f"included), step {PP_STEPS} {last:.4f} s ({how}; beside the other runs of its wave), wall {wall:.1f} s; "
            f"launches over its ranks {att}, fused_adamw {launches['fused_adamw']} [{card}]")
    if bad:
        fail(f"7q: {bad}")
    return {k: runs["gpipe M 2 bf16"][3][k] + runs["gpipe M 2 bf16 att_dropout"][3][k] for k in _build.LAUNCHES}


# --- phase 7n: the MoE ViT in groups through the train CLI on the one card ---
# bench.py's b16_moe (bench.py:296-298: D 768, 12 heads, patch 16 at 224,
# N 196, 8 experts, top-1, capacity factor 1.25, einsum) through the train
# CLI under torchrun, the ranks on the one card over gloo (TP_CLI_MAIN, as
# 7p and 7q run), batch 8, 3 steps, long warmup: sp 2 (ring and Ulysses:
# the capacity over the whole sequence from one all-reduce of choice
# counts a block), tp 2 (the whole MoE on every tp rank) and tp 2 x ep 2
# (the experts replicated over tp, sharded over the ep group of one tp
# index), each against one process. The batches are the fake data path's
# with every row its own (seeded_fake_item), so a row handed to the wrong
# rank or a sample's counts taken for another's moves the numbers.
# float32: each of the 3 losses and 3 grad norms within MOE_GROUP_TOL of
# the one process's (the CPU tests hold the same arithmetic to vitax's at
# capacity factor 0.5; here the bar catches a token kept or dropped
# against the whole sequence's order: moe_group_drops shows the first step
# drops tokens and that a rank-local capacity would route others; at the
# CPU tests' tiny width a rank-local capacity moved the grad norm 1.4e-3
# and the loss 1.7e-5, so the bar is 1e-5, not phase 5's 3e-4). bf16 (the
# default dtype) runs each mesh and one process on the wgmma kernels (the
# ring's with-lse entries at local 98 and global offset 98 among them):
# each of a mesh's 6 numbers within TP_BF16_FACTOR times the bf16 one
# process's distance from the float32 one process (at least
# MODEL_LOSS_REL_TOL), as 7p and 7q hold theirs, and each rank's launches
# as the schedule says (moe_group_predicted). Depth 4 of b16_moe's 12, cut for
# memory and time: at depth 12 a rank holds 5-9 GB and the 21 processes
# need about 140 GB of the card (two tp runs' 6 ranks at once peaked at
# 40.1 GB of an H100 80GB HBM3), four waves of their own at 32-36 s each;
# at depth 4 (a rank 1.7-3.4 GB reserved) they take one wave of their own
# and share 7q's bf16 wave (MOE_GROUP_WAVES; on that card 7q's float32
# wave alone filled 70.4 GB, its bf16 wave 41.9, 7p's 52.2).
MOE_GROUP_DEPTH = 4
MOE_GROUP_CLI = ["--fake_data", "--image_size", "224", "--patch_size", "16", "--embed_dim", "768", "--num_heads", "12",
                 "--moe_experts", "8", "--batch_size", "8", "--max_steps", "3", "--warmup_steps", "100",
                 "--log_step_interval", "1", "--num_workers", "2", "--num_blocks", str(MOE_GROUP_DEPTH)]
MOE_GROUP_STEPS = 3
MOE_GROUP_CF = 1.25
MOE_GROUP_MESHES = {"sp 2 ring": (2, ["--sp_size", "2"]),
                    "sp 2 ulysses": (2, ["--sp_size", "2", "--sp_impl", "ulysses"]),
                    "tp 2": (2, ["--tp_size", "2"]),
                    "tp 2 x ep 2": (4, ["--tp_size", "2", "--ep_size", "2"])}
MOE_GROUP_RUNS = {"one process float32": (1, "float32", []), "one process bf16": (1, "bfloat16", []),
                  **{f"{m} float32": (r, "float32", f) for m, (r, f) in MOE_GROUP_MESHES.items()},
                  **{f"{m} bf16": (r, "bfloat16", f) for m, (r, f) in MOE_GROUP_MESHES.items()}}
MOE_GROUP_TOL = 1e-5
# the 7n runs of each wave of phase_groups: none beside 7p's wave (ten
# processes, 52.2 GB) or 7q's float32 one (70.4 GB); the bf16 tp runs
# (6 ranks, about 16 GB) beside 7q's bf16 wave; a fourth wave of the
# float32 runs and the other bf16 runs (16 processes, about 51 GB)
MOE_GROUP_WAVES = ((), (), ("tp 2 bf16", "tp 2 x ep 2 bf16"),
                   (*(n for n in MOE_GROUP_RUNS if n.endswith("float32")), "one process bf16", "sp 2 ring bf16",
                    "sp 2 ulysses bf16"))


def seeded_fake_item(self, idx: int):
    """7n's FakeImageNetDataset.__getitem__ (TP_CLI_MAIN under
    SMOKE_SEEDED_FAKE, and moe_group_drops): index idx's image standard
    normal from a generator seeded with (SEED, idx), its label idx % 1000,
    where the fake data path gives every row zeros and label 0."""
    rng = np.random.default_rng((SEED, int(idx)))
    return rng.standard_normal((self.image_size, self.image_size, 3), dtype=np.float32), int(idx) % 1000


def moe_group_dir(root: str, name: str) -> str:
    return os.path.join(root, "moe_" + name.replace(" ", "_"))


def moe_group_cmds(root: str, main_py: str, env: dict, names) -> list:
    """Phase 7n's runs `names` (of MOE_GROUP_RUNS) as run_cli commands:
    torchrun of TP_CLI_MAIN with every rank on cuda:0, or one process, on
    seeded_fake_item's batches."""
    cmds, env = [], dict(env, SMOKE_SEEDED_FAKE="1")
    for name in names:
        ranks, dtype, flags = MOE_GROUP_RUNS[name]
        d = moe_group_dir(root, name)
        os.makedirs(d)
        launcher = ([sys.executable] if ranks == 1 else
                    [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(ranks)])
        extra = ["--device", "cuda:0"] if ranks > 1 else []
        cmds.append((name, [*launcher, main_py, d, *MOE_GROUP_CLI, "--moe_capacity_factor", str(MOE_GROUP_CF),
                            "--dtype", dtype, *flags, *extra, "--metrics_dir", d], env))
    return cmds


def moe_group_predicted(name: str) -> dict:
    """The launches a rank of a 7n bf16 run must count over its steps under
    none_saveable: each block's attention forward twice a step (the
    forward and its recompute) and its backward once, on the wgmma kernels;
    the ring's S block products a call; one fused_adamw a step."""
    calls = 2 if "ring" in name else 1
    fwd, bwd = 2 * calls * MOE_GROUP_DEPTH * MOE_GROUP_STEPS, calls * MOE_GROUP_DEPTH * MOE_GROUP_STEPS
    return {"flash_attn_fwd": fwd, "flash_attn_fwd_wgmma": fwd, "flash_attn_bwd": bwd, "flash_attn_bwd_wgmma": bwd,
            "fused_adamw": MOE_GROUP_STEPS}


def moe_group_drops(torch, card) -> None:
    """The first step's forward of 7n's cell (the seeded init every run
    starts from, float32, the first batch of seeded_fake_item's rows) in
    this process: the share of first choices past an expert's capacity
    over the whole sequence, and how many tokens a capacity and slot order
    taken over each sp-2 rank's token slice would keep or drop otherwise.
    Each block's route() of each sp-2 slice, given the lower slice's and
    the whole sequence's per-sample counts (what sequence_counts gathers),
    must equal the slice of the whole route: experts, gates and kept flags.
    Fails if they differ, or if nothing drops: the sp runs' check would
    then prove nothing."""
    from vitax_torch.config import Config, build_parser, config_fields_from_namespace
    from vitax_torch.data.fake import TRAIN_SPLIT_LEN, FakeImageNetDataset
    from vitax_torch.data.loader import ShardedSampler
    from vitax_torch.models.moe import capacity, route
    from vitax_torch.models.vit import build_model
    ns = build_parser().parse_args([*MOE_GROUP_CLI, "--moe_capacity_factor", str(MOE_GROUP_CF),
                                    "--dtype", "float32"])
    cfg = Config(**config_fields_from_namespace(ns)).validate()
    model = build_model(cfg, "cuda")
    ds = FakeImageNetDataset(cfg.image_size, TRAIN_SPLIT_LEN)
    rows = ShardedSampler(TRAIN_SPLIT_LEN, cfg.batch_size, shuffle=True, seed=cfg.seed).epoch_indices(0)[0]
    images = torch.from_numpy(np.stack([seeded_fake_item(ds, i)[0] for i in rows])).cuda(0)
    e, n, h = cfg.moe_experts, cfg.num_patches, cfg.num_patches // 2
    c, c_local = capacity(e, n, MOE_GROUP_CF), capacity(e, h, MOE_GROUP_CF)
    stats = []

    def hook(m, args, logits):
        probs = torch.softmax(logits, dim=-1)
        whole = route(probs, 1, c)[0]
        halves = [probs[:, i * h:(i + 1) * h] for i in (0, 1)]
        local = torch.cat([route(p, 1, c_local)[0].keep for p in halves], dim=1)
        counts = torch.stack([torch.stack([ch.onehot.sum(dim=1) for ch in route(p, 1, c)]) for p in halves])
        same = all(torch.equal(getattr(whole, f)[:, i * h:(i + 1) * h], getattr(ch, f))
                   for i, p in enumerate(halves)
                   for ch in route(p, 1, c, lambda k, i=i: (counts[:i].sum(dim=0), counts.sum(dim=0)))
                   for f in ("expert", "gate", "keep"))
        stats.append(((~whole.keep).sum().item(), (whole.keep != local).sum().item(), whole.keep.numel(), same))
    hooks = [block.moe.router.register_forward_hook(hook) for block in model.blocks]
    try:
        with torch.no_grad():
            model(images)
    finally:
        for hk in hooks:
            hk.remove()
    del model, images
    gc.collect()
    torch.cuda.empty_cache()
    dropped, differ, tokens = (sum(x[i] for x in stats) for i in range(3))
    same = all(x[3] for x in stats)
    say(f"[7n drops] b16_moe at depth {cfg.num_blocks}, capacity factor {MOE_GROUP_CF} (C {c} slots an expert of "
        f"{n} tokens), the first step's forward of the seeded init on its first batch ({cfg.batch_size} seeded "
        f"rows): {dropped} of {tokens} first choices dropped ({dropped / tokens:.2%}), blocks "
        f"{[x[0] for x in stats]}; a capacity over each sp-2 rank's {h} tokens (C {c_local}) would keep or drop "
        f"{differ} tokens otherwise; each sp-2 slice's route with the cross-slice counts equals the whole "
        f"route's slice: {'ok' if same else 'FAIL'} [{card}]")
    if not same:
        fail("7n: an sp-2 slice's route with the cross-slice counts differs from the whole route's slice")
    if dropped == 0:
        fail(f"7n: nothing drops at capacity factor {MOE_GROUP_CF}; the sp check would prove nothing: lower "
             f"MOE_GROUP_CF")


def phase_moe_groups(root: str, card: str, results: dict, peaks: dict) -> dict:
    """Phase 7n: the MOE_GROUP_RUNS (`results`: run_cli's; `peaks`: the card
    memory of each run's wave): exit 0, the log lines of the mesh and the
    MoE, each step's loss and grad norm from rank 0's JSONL, float32 runs
    against one process within MOE_GROUP_TOL, bf16 runs finite with each
    rank's launches as moe_group_predicted says, each mesh's within
    TP_BF16_FACTOR of one bf16 process's distance from one float32
    process; each run's wall and its ranks' peak memory. Returns the bf16
    runs' launches, summed over their ranks."""
    from vitax_torch.models.moe import capacity
    from vitax_torch.ops import _build
    runs, bad = {}, []
    flag = dict(zip(MOE_GROUP_CLI[1::2], MOE_GROUP_CLI[2::2]))          # after --fake_data, flag-value pairs
    c = capacity(int(flag["--moe_experts"]), (int(flag["--image_size"]) // int(flag["--patch_size"])) ** 2,
                 MOE_GROUP_CF)
    for name, (r, wall) in results.items():
        ranks, dtype, flags = MOE_GROUP_RUNS[name]
        if r.returncode != 0 or "training begins" not in r.stdout:
            fail(f"[7n] {name} exited {r.returncode}:\n{proc_tail(r)}")
        want_log = (f"capacity {c} slots over the whole sequence across sp 2" if "sp" in name else
                    "the whole MoE on every tp rank (experts replicated over tp 2)" if "tp" in name else
                    "moe: 8 experts")
        if want_log not in r.stdout or ("ep 2" in name and "4 experts a rank over ep 2" not in r.stdout):
            fail(f"[7n] the {name} run does not log its MoE layout ({want_log!r}):\n{r.stdout[-3000:]}")
        d = moe_group_dir(root, name)
        steps, _ = read_jsonl(os.path.join(d, "metrics.jsonl"))
        launches, mem = {k: 0 for k in _build.LAUNCHES}, []
        for rank in range(ranks):
            with open(os.path.join(d, f"launches{rank}.json")) as f:
                mine = json.load(f)
            with open(os.path.join(d, f"memory{rank}.json")) as f:
                mem.append(json.load(f)["max_memory_reserved"] / 1e9)
            if dtype == "bfloat16":
                got, want = {k: v for k, v in mine.items() if v}, moe_group_predicted(name)
                if got != want:
                    bad.append(f"{name} rank {rank}: launches {got} (predicted {want})")
            for k, v in mine.items():
                launches[k] += v
        values = [s["loss"] for s in steps] + [s["grad_norm"] for s in steps]
        if len(steps) != MOE_GROUP_STEPS or not all(np.isfinite(values)):
            fail(f"[7n] {name}: {len(steps)} logged steps of {MOE_GROUP_STEPS}, losses and norms {values}")
        runs[name] = (values, wall, launches, mem, steps[-1]["sec_per_iter"])
    if bad:
        fail(f"7n: launches off the schedule's: {bad}")

    def rel_dist(a, b):
        return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))

    def fmt(v):
        return f"losses {' '.join(f'{x:.6f}' for x in v[:3])}, grad norms {' '.join(f'{x:.6f}' for x in v[3:])}"
    ref, b16 = runs["one process float32"][0], runs["one process bf16"][0]
    for mesh in MOE_GROUP_MESHES:
        got = runs[f"{mesh} float32"][0]
        e = rel_dist(got, ref)
        say(f"[7n cli] b16_moe (depth {MOE_GROUP_DEPTH}) {mesh} float32 ({MOE_GROUP_RUNS[mesh + ' float32'][0]} "
            f"ranks on one card over gloo): {fmt(got)}; one process: {fmt(ref)}; rel diff max {e:.2e} "
            f"(<= {MOE_GROUP_TOL}) {'ok' if e <= MOE_GROUP_TOL else 'FAIL'} [{card}]")
        if e > MOE_GROUP_TOL:
            bad.append(f"{mesh} float32: {got} against one process's {ref}")
        got = runs[f"{mesh} bf16"][0]
        ratios = [rel_dist([t2], [w]) / (TP_BF16_FACTOR * max(rel_dist([t1], [w]), MODEL_LOSS_REL_TOL))
                  for t2, t1, w in zip(got, b16, ref)]
        say(f"[7n cli] {mesh} bf16: {fmt(got)}; one process bf16 {fmt(b16)}; rel distance from float32 one "
            f"process, max over the six: {mesh} {rel_dist(got, ref):.2e}, one process {rel_dist(b16, ref):.2e}; "
            f"each of {mesh}'s over {TP_BF16_FACTOR} x max(one process's, {MODEL_LOSS_REL_TOL}): "
            f"{' '.join(f'{r:.2f}' for r in ratios)} (<= 1) {'ok' if max(ratios) <= 1.0 else 'FAIL'} [{card}]")
        if max(ratios) > 1.0:
            bad.append(f"{mesh} bf16 lies past its bar from float32 one process: {ratios}")
    for name, (values, wall, launches, mem, sec) in runs.items():
        att = {k: v for k, v in launches.items() if k.startswith("flash_attn") and v}
        say(f"[7n time] {name}: {fmt(values)}; sec/iter {sec:.4f} (as logged: smoothed over the {MOE_GROUP_STEPS} "
            f"steps, the first included), wall {wall:.1f} s (beside the rest of its wave, whose card peak was "
            f"{peaks[name]:.1f} GB); each rank's max_memory_reserved {' '.join(f'{m:.2f}' for m in mem)} GB; "
            f"launches over its ranks {att}, fused_adamw {launches['fused_adamw']} [{card}]")
    if bad:
        fail(f"7n: {bad}")
    return {k: sum(runs[n][2][k] for n in runs if MOE_GROUP_RUNS[n][1] == "bfloat16") for k in _build.LAUNCHES}


def phase_groups(torch, card, root: str) -> tuple:
    """Phases 7p, 7q and 7n in four waves of processes on the card (each
    wave's runs at once): the tp Block's torchrun and 7p's four CLI runs
    (whose tp-1 runs are 7q's pp-1 runs), then 7q's pp-2 runs in PP_WAVES,
    then 7n's last runs, its runs placed by MOE_GROUP_WAVES, after
    moe_group_drops; each wave's card peak sampled. Returns (the tp Blocks' launches, the bf16
    tp-2 run's, the bf16 pp-2 runs', the bf16 7n runs')."""
    gc.collect()
    torch.cuda.empty_cache()
    moe_group_drops(torch, card)
    main_py = os.path.join(root, "tp_cli_main.py")
    with open(main_py, "w") as f:
        f.write(TP_CLI_MAIN)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    waves = [[tp_block_cmd(root, env), *tp_cli_cmds(root, main_py, env)]]
    waves += [pp_cmds(root, main_py, env, names) for names in PP_WAVES] + [[]]
    results, walls, peaks, moe_peaks = {}, [], [], {}
    for cmds, moe in zip(waves, MOE_GROUP_WAVES):
        memory = CardMemory(torch).start()
        t0 = time.perf_counter()
        try:
            results.update(run_cli([*cmds, *moe_group_cmds(root, main_py, env, moe)], 600))
        finally:
            peaks.append(memory.stop())
        walls.append(time.perf_counter() - t0)
        moe_peaks.update({name: peaks[-1] for name in moe})
    names = [f"the tp Block's torchrun of {TP_RANKS} ranks, the tp CLI's 4 runs", *(", ".join(w) for w in PP_WAVES)]
    say("[7p, 7q, 7n] " + "; ".join(
        f"wave {i + 1} (" + "; ".join(filter(None, [n, ", ".join(f"7n {m}" for m in moe)]))
        + f") {w:.1f} s, the card at most {p:.1f} GB"
        for i, (n, moe, w, p) in enumerate(zip([*names, ""], MOE_GROUP_WAVES, walls, peaks))) + f" [{card}]")
    moe_results = {k: results.pop(k) for k in list(results) if k in MOE_GROUP_RUNS}
    tp_launches = phase_tp(card, root, results.pop("tp block"))
    cli_launches = tp_cli(root, card, {k: v for k, v in results.items() if isinstance(k, tuple)})
    pp_launches = phase_pp(root, card, results)
    moe_launches = phase_moe_groups(root, card, moe_results, moe_peaks)
    return tp_launches, cli_launches, pp_launches, moe_launches


def kernels_line(errs, timing, serve_launches, quant_launches, train_launches, drop_launches, long_launches,
                 data_launches, ring_launches):
    """The `kernels` JSON entries: every kernel with its launches on the main
    paths of this run (phases 7a's ranks and replicas, 7t, 7i, 7s, 7c, 7e's drills, 7x, 7m, 7f, 7q's and
    7n's bf16 runs in `data_launches`,
    7r's ring runs, 7p's tp Blocks and its bf16 tp-2 CLI run in `ring_launches`), its check's
    max |d| and its timing."""
    fwd_src, bwd_src = "vitax_torch/csrc/flash_attn_fwd.cu", "vitax_torch/csrc/flash_attn_bwd.cu"
    kernels = [
        {"name": "flash_attn_fwd", "route": "cuda", "source": fwd_src,
         "replaces": "vitax/ops/attention.py:275",
         "launches": (serve_launches["flash_attn_fwd"] + quant_launches["flash_attn_fwd"]
                      + train_launches["flash_attn_fwd"] + drop_launches["flash_attn_fwd"]
                      + data_launches["flash_attn_fwd"] + ring_launches["flash_attn_fwd"]),
         "max_abs_err": errs[(SERVE_SHAPE, "bfloat16", "wgmma")], **timing["flash_attn_fwd"]},
        # the forward's general (mma.sync) kernel, for operands TMA does not
        # take; no main-path launch takes it (its count over every main path),
        # phase 3 holds it at every shape, phase 4 times it in turns
        {"name": "flash_attn_fwd_general", "route": "cuda", "source": fwd_src,
         "replaces": "vitax/ops/attention.py:275",
         "launches": sum(ls["flash_attn_fwd_general"] for ls in (serve_launches, quant_launches, train_launches,
                                                                  drop_launches, long_launches, data_launches,
                                                                  ring_launches)),
         "max_abs_err": errs[(SERVE_SHAPE, "bfloat16", "general")], **timing["flash_attn_fwd_general"]},
        {"name": "flash_attn_bwd", "route": "cuda", "source": "vitax_torch/csrc/flash_attn_bwd.cu",
         "replaces": "vitax/ops/attention.py:302",
         "launches": (train_launches["flash_attn_bwd"] + data_launches["flash_attn_bwd"]
                      + ring_launches["flash_attn_bwd"]),
         "max_abs_err": errs["flash_attn_bwd"], **timing["flash_attn_bwd"]},
        # the backward's general (mma.sync) kernels, for operands TMA does not
        # take; no main-path call takes them (their count over every main
        # path), phases 3 and 3L hold them, phases 4 and 4L time them in turns
        {"name": "flash_attn_bwd_general", "route": "cuda", "source": bwd_src,
         "replaces": "vitax/ops/attention.py:302",
         "launches": sum(ls["flash_attn_bwd_general"] for ls in (serve_launches, quant_launches, train_launches,
                                                                  drop_launches, long_launches, data_launches,
                                                                  ring_launches)),
         "max_abs_err": errs["flash_attn_bwd_general"], **timing["flash_attn_bwd_general"]},
        {"name": "fused_adamw", "route": "cuda", "source": "vitax_torch/csrc/fused_adamw.cu",
         "replaces": "vitax/ops/fused_optimizer.py:112",
         "launches": (train_launches["fused_adamw"] + drop_launches["fused_adamw"] + long_launches["fused_adamw"]
                      + data_launches["fused_adamw"]),
         "max_abs_err": max(errs["fused_adamw"], errs["fused_adamw_table"]), **timing["fused_adamw"]},
        {"name": "dequant_matmul", "route": "cuda", "source": "vitax_torch/csrc/dequant_matmul.cu",
         "replaces": "vitax/ops/dequant_matmul.py:92",
         "launches": quant_launches["dequant_matmul"] + data_launches["dequant_matmul"],
         "max_abs_err": errs["dequant_matmul"], **timing["dequant_matmul"]},
        # C's general (mma.sync) kernel, for shapes TMA does not take; no
        # main-path site launches it (its count is phase 6q's), phase 3
        # holds it at the ragged shapes and at proj, phase 4 times it
        {"name": "dequant_matmul_general", "route": "cuda", "source": "vitax_torch/csrc/dequant_matmul.cu",
         "replaces": "vitax/ops/dequant_matmul.py:92",
         "launches": quant_launches["dequant_matmul_general"] + data_launches["dequant_matmul_general"],
         "max_abs_err": errs["dequant_matmul_general"], **timing["dequant_matmul_general"]},
        {"name": "flash_attn_fwd_drop", "route": "cuda", "source": fwd_src,
         "replaces": "vitax/ops/attention.py:625",
         "launches": (drop_launches["flash_attn_fwd_drop"] + data_launches["flash_attn_fwd_drop"]
                      + ring_launches["flash_attn_fwd_drop"]),
         "max_abs_err": errs["flash_attn_fwd_drop"], **timing["flash_attn_fwd_drop"]},
        {"name": "flash_attn_bwd_drop", "route": "cuda", "source": bwd_src,
         "replaces": "vitax/ops/attention.py:659",
         "launches": (drop_launches["flash_attn_bwd_drop"] + data_launches["flash_attn_bwd_drop"]
                      + ring_launches["flash_attn_bwd_drop"]),
         "max_abs_err": errs["flash_attn_bwd_drop"], **timing["flash_attn_bwd_drop"]},
    ]
    # The BH entry points run the same kernels on (B*H, N, 1, Dh) views; no
    # main path calls them (launches 0), phase 3 holds them and phase 4 times them.
    for name, src, line in (("flash_bh_fwd", fwd_src, 139), ("flash_bh_bwd", bwd_src, 178),
                            ("flash_bh_fwd_drop", fwd_src, 491), ("flash_bh_bwd_drop", bwd_src, 513)):
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": f"vitax/ops/attention.py:{line}",
                        "launches": 0, "max_abs_err": errs[name], **timing[name]})
    # The streaming path (phase 7L) launches A1's and A2's kernels through
    # vitax_torch/ops/flash_blocked.py; each backward call (the entry at
    # blocked_bwd_padded, beside SDPA's whole backward) runs both A5
    # counterparts, listed apart with no library call. Launches count both
    # rates, phase 7L's and phase 7r's; the times are N 4096, rate 0.
    fwd_launches = sum(ls["flash_attn_fwd_stream"] + ls["flash_attn_fwd_stream_drop"]
                       for ls in (long_launches, ring_launches))
    bwd_launches = sum(ls["flash_attn_bwd_stream"] + ls["flash_attn_bwd_stream_drop"]
                       for ls in (long_launches, ring_launches))
    for name, src, line, launches in (("flash_attn_fwd_stream", fwd_src, 63, fwd_launches),
                                      ("flash_attn_bwd_stream", bwd_src, 244, bwd_launches),
                                      ("flash_attn_bwd_stream_dkdv", bwd_src, 152, bwd_launches),
                                      ("flash_attn_bwd_stream_dq", bwd_src, 205, bwd_launches),
                                      ("flash_attn_bwd_stream_general", bwd_src, 244,
                                       long_launches["flash_attn_bwd_general"]
                                       + ring_launches["flash_attn_bwd_general"])):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": f"vitax/ops/flash_blocked.py:{line}", "launches": launches,
                        "max_abs_err": errs[name], **timing[name]})
    return kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    try:
        import vitax_torch  # noqa: F401
    except ImportError as e:
        fail(f"the vitax_torch package is not beside chip_smoke.py ({e})")
    marks = [("start", time.perf_counter())]

    def mark(name: str) -> None:          # the seconds of each phase, printed at the end
        marks.append((name, time.perf_counter()))

    card = phase_env(torch)
    phase_build()
    mark("1-2")
    errs = phase_kernel_check(torch)
    errs.update(check_streaming(torch))
    mark("3, 3L")
    timing = phase_kernel_timing(torch, card)
    timing.update(time_streaming(torch, card))
    mark("4, 4L")
    phase_model_check(torch)
    mark("5")
    serve_launches, engine_f32 = phase_main_path(torch, card)
    mark("6")
    quant_launches, q8_states, q8_traffic = phase_quant_serve(torch, card, engine_f32)
    mark("6q")
    export = phase_fleet(torch, card, engine_f32, q8_states)
    del engine_f32
    gc.collect()                           # free the 40 GB engine before the fleet and the train path
    torch.cuda.empty_cache()
    beside = Beside(torch, export)
    try:
        run_fleet(torch, card, export, q8_traffic, beside.start)
        mark("6f")
        arb_launches = phase_arbiter(torch, card, beside)
        mark("7a")
    except BaseException:
        beside.kill()
        if beside.torchrun is not None:
            shutil.rmtree(beside.torchrun["root"], ignore_errors=True)
        raise
    finally:
        shutil.rmtree(export["work"], ignore_errors=True)
    del export
    train_launches, (errs["fused_adamw_table"], timing["fused_adamw"]), loss0, fake, ref7 = phase_train(torch, card)
    mark("7")
    tele_launches = phase_train_telemetry(torch, card, timing["fused_adamw"]["ms"], beside.torchrun)
    mark("7t")
    drop_launches = phase_train_dropout(torch, card, loss0)
    mark("7d")
    long_launches = phase_train_long(torch, card)
    mark("7L")
    ring_launches = phase_ring(torch, card)
    mark("7r")
    with tempfile.TemporaryDirectory(prefix="vitax_torch_tp_") as root:
        tp_launches, cli_launches, pp_launches, moe_group_launches = phase_groups(torch, card, root)
        mark("7p, 7q, 7n")
    # 7r's runs, 7p's sharded Blocks and its bf16 tp-2 CLI run
    ring_launches = {k: ring_launches[k] + tp_launches[k] + cli_launches[k] for k in ring_launches}
    with tempfile.TemporaryDirectory(prefix="vitax_torch_smoke_") as root:
        write_tree(os.path.join(root, "tree"))
        tree_launches, use_native = phase_train_tree(torch, card, root, fake)
        stream_launches = phase_train_stream(torch, card, root, use_native)
        time_loaders(torch, root, card, use_native)
        mark("7i, 7s")
        ckpt_launches = phase_checkpoint(torch, card, root)
        mark("7c")
        fault_launches = phase_faults(torch, card, root)
        mark("7e")
        transfer = phase_transfer(torch, card, root, ref7)
        mark("7x")
        moe_launches = phase_train_moe(torch, card, root)
        mark("7m")
        fsdp_launches = phase_train_fsdp(torch, card, root, ref7)
        mark("7f")
    data_launches = {k: tree_launches[k] + stream_launches[k] + ckpt_launches[k] + fsdp_launches[k]
                     + tele_launches[k] + transfer[k] + moe_launches[k] + pp_launches[k] + fault_launches[k]
                     + arb_launches[k] + moe_group_launches[k] for k in tree_launches}
    kernels = kernels_line(errs, timing, serve_launches, quant_launches, train_launches, drop_launches,
                           long_launches, data_launches, ring_launches)
    say("[time] " + ", ".join(f"{name} {t1 - t0:.1f}s" for (_, t0), (name, t1) in zip(marks, marks[1:]))
        + f"; all {marks[-1][1] - marks[0][1]:.1f}s")
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def main_lost_rank() -> int:
    """`--lost-rank`: the kernels built, then drill (f) alone at DRILL_CELL."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    card = phase_env(torch)
    phase_build()
    with tempfile.TemporaryDirectory(prefix="vitax_torch_lost_") as root:
        lost_rank_only(torch, card, root)
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-block-rank"]:     # phase 7p's ranks, started by phase_groups under torchrun
        sys.exit(tp_block_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--lost-rank"]:          # drill (f) alone at the 10B width (depth 1)
        sys.exit(main_lost_rank())
    sys.exit(main())
