#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (vitax_torch), run from the
repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

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
     idle; the dequant matmul weight-only with int8 and fp8 weights, and
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
  7. train main path: train() on the 10B-width model cut to depth 8, batch
     32, fake data, 12 steps and a 2-batch eval, with the launch counts of
     the run checked against the steps, sec/iter, images/s, MFU and peak
     memory; then a profile of one steady step, and the fused optimizer
     on the trained state's own leaf table: one launch held element by
     element against the plain version, then timed;
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
  8. a `kernels` JSON line, then the last line
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
# INT32 operations/s: 64 INT32 lanes an SM (Hopper architecture white
# paper) x 132 SMs x the 1.98 GHz boost clock, the clock at which the
# float32 peak above is 67 TFLOP/s. The dropout hash spends about 19 of
# them on each score element (two fmix32 of 8, the k-term multiply-add,
# the xor with the seed and the compare; flash_common.cuh).
INT32_OPS_PER_S = 64 * 132 * 1.98e9
HASH_OPS_PER_ELEMENT = 19

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
                dlse = torch.from_numpy(rng.standard_normal((b, h, n)).astype(np.float32)).cuda()
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
    dlse = torch.from_numpy(rng.standard_normal((b, h, n)).astype(np.float32)).cuda()
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
        fused_adamw_cuda(p, g, mu, nu, scal, hp)
        clip_adamw_(ref[0], g, ref[1], ref[2], scal, hp)
        d, bad = adamw_diff(torch, (p, mu, nu), ref)
        ok = bad == 0 and all(bool(torch.isfinite(a).all()) for a in p)
        say(f"[3 check] fused_adamw {len(p)} leaves ({sum(x.numel() for x in p):,} params), clip "
            f"{'triggered' if scal[0].item() < 1 else 'idle'} (scale {scal[0].item():.4g}): max|d| {d:.3e}, "
            f"{bad} elements outside rtol {ADAMW_RTOL} / atol {ADAMW_ATOL} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("fused_adamw disagrees with its plain version")
        worst = max(worst, d)
        del p, g, mu, nu, ref
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
    out = device_ms(fn, patterns, calls)
    for piece, ms in out.items():
        if not ms > 0:
            fail(f"torch.profiler recorded no device time for the {piece} kernel")
    return out


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
    images = torch.from_numpy(rng.integers(0, 256, (8, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)).cuda()
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
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, 8)).cuda()
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
    return launches, engine


def phase_quant_serve(torch, card, engine_f32):
    """Quantized serving: phase 6's full-width, full-depth 10B model
    quantized on the card to int8 and to fp8, three engines (int8
    weight-only, int8 with int8 activations, fp8 weight-only) over HTTP,
    each with its launch counts, footprint, profile, latency and accuracy
    gate against the full-precision engine. Returns the launches of each
    kernel summed over the three engines' traffic."""
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
        del engine
    del states
    return total


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


def phase_train(torch, card):
    """The train main path: train() in process at the 10B width, depth 8,
    batch 32, fake data; then one profiled steady step and the fused
    optimizer checked and timed on the trained state. Returns (launches,
    (max |d| of B on the state's table, timing of B), the first loss,
    (sec/iter, MFU))."""
    from vitax_torch.config import Config
    from vitax_torch.models.vit import expected_param_count
    from vitax_torch.ops import _build
    from vitax_torch.telemetry.flops import model_flops_per_step, peak_tflops
    from vitax_torch.train.loop import train

    cfg = Config(seed=SEED, **TRAIN).validate()
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
    times = [r["step_seconds"] for r in steps[2:]]          # steps 3 to 12
    sec_per_iter = float(np.median(times))
    peak = peak_tflops(torch.cuda.get_device_name(0))
    mfu = (model_flops_per_step(cfg) / sec_per_iter / (peak * 1e12)) if peak else None
    say(f"[7 train] 10B width, depth {cfg.num_blocks} ({n_params:,} params, {16 * n_params / 1e9:.1f} GB "
        f"of f32 params, grads and AdamW moments), batch {cfg.batch_size}, bf16 compute, grad_ckpt "
        f"{cfg.grad_ckpt}: {cfg.max_steps} steps + eval in {wall:.1f}s")
    say(f"[7 train] losses " + " ".join(f"{x:.4f}" for x in losses) + f"; grad_norm first "
        f"{steps[0]['grad_norm']:.4f} last {steps[-1]['grad_norm']:.4f}; eval top1 {evals[0]['top1']:.4f}")
    say(f"[7 train] sec/iter median of steps 3-12 {sec_per_iter:.4f} s (min {min(times):.4f}, max "
        f"{max(times):.4f}); {cfg.batch_size / sec_per_iter:.2f} images/s; MFU "
        + (f"{mfu * 100:.2f}% of {peak:.0f} TFLOP/s bf16" if mfu is not None else "not measured (no peak for this card)")
        + f" ({model_flops_per_step(cfg) / 1e12:.2f} TFLOP a step); max_memory_allocated {peak_gb:.2f} GB; "
        f"launches {launches} [{card}]")

    from vitax_torch.train.state import build_optimizer
    from vitax_torch.train.step import make_train_step
    optimizer, _ = build_optimizer(cfg, 100)
    train_step = make_train_step(cfg, optimizer, "cuda")
    batch = {"image": torch.zeros((cfg.batch_size, cfg.image_size, cfg.image_size, 3), device="cuda"),
             "label": torch.zeros(cfg.batch_size, dtype=torch.int64, device="cuda")}
    _build.reset_launches()
    profile_device(torch, lambda: train_step(state, batch), f"one train step (batch {cfg.batch_size}, "
                   f"depth {cfg.num_blocks})", card, "7", top=14)
    per_step = {k: v // 2 for k, v in _build.LAUNCHES.items()}       # a warm step, then the profiled one
    want_step = step_launches(cfg)
    if per_step != want_step or any(v % 2 for v in _build.LAUNCHES.values()):
        fail(f"two steady train steps launched {dict(_build.LAUNCHES)}; expected {want_step} a step")
    say(f"[7 train] launches per steady step {per_step}")
    del train_step, batch
    timing = time_fused_adamw(torch, state, card)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    ref = {"sec": sec_per_iter, "mfu": mfu, "peak_gb": peak_gb, "losses": losses,
           "norms": [r["grad_norm"] for r in steps]}
    return launches, timing, losses[0], (sec_per_iter, mfu), ref


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


def steps_in_turns(torch, train_step, state, loader):
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


def phase_checkpoint(torch, card, root: str):
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
        mesh = build_mesh(cfg, torch.device("cuda"))
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
        cmesh = build_mesh(ccfg, torch.device("cuda"))
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


def kernels_line(errs, timing, serve_launches, quant_launches, train_launches, drop_launches, long_launches,
                 data_launches):
    """The `kernels` JSON entries: every kernel with its launches on the main
    paths of this run (phases 7i, 7s, 7c and 7f in `data_launches`), its
    check's max |d| and its timing."""
    fwd_src, bwd_src = "vitax_torch/csrc/flash_attn_fwd.cu", "vitax_torch/csrc/flash_attn_bwd.cu"
    kernels = [
        {"name": "flash_attn_fwd", "route": "cuda", "source": fwd_src,
         "replaces": "vitax/ops/attention.py:275",
         "launches": (serve_launches["flash_attn_fwd"] + quant_launches["flash_attn_fwd"]
                      + train_launches["flash_attn_fwd"] + drop_launches["flash_attn_fwd"]
                      + data_launches["flash_attn_fwd"]),
         "max_abs_err": errs[(SERVE_SHAPE, "bfloat16", "wgmma")], **timing["flash_attn_fwd"]},
        # the forward's general (mma.sync) kernel, for operands TMA does not
        # take; no main-path launch takes it (its count over every main path),
        # phase 3 holds it at every shape, phase 4 times it in turns
        {"name": "flash_attn_fwd_general", "route": "cuda", "source": fwd_src,
         "replaces": "vitax/ops/attention.py:275",
         "launches": sum(ls["flash_attn_fwd_general"] for ls in (serve_launches, quant_launches, train_launches,
                                                                  drop_launches, long_launches, data_launches)),
         "max_abs_err": errs[(SERVE_SHAPE, "bfloat16", "general")], **timing["flash_attn_fwd_general"]},
        {"name": "flash_attn_bwd", "route": "cuda", "source": "vitax_torch/csrc/flash_attn_bwd.cu",
         "replaces": "vitax/ops/attention.py:302",
         "launches": train_launches["flash_attn_bwd"] + data_launches["flash_attn_bwd"],
         "max_abs_err": errs["flash_attn_bwd"], **timing["flash_attn_bwd"]},
        # the backward's general (mma.sync) kernels, for operands TMA does not
        # take; no main-path call takes them (their count over every main
        # path), phases 3 and 3L hold them, phases 4 and 4L time them in turns
        {"name": "flash_attn_bwd_general", "route": "cuda", "source": bwd_src,
         "replaces": "vitax/ops/attention.py:302",
         "launches": sum(ls["flash_attn_bwd_general"] for ls in (serve_launches, quant_launches, train_launches,
                                                                  drop_launches, long_launches, data_launches)),
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
         "launches": drop_launches["flash_attn_fwd_drop"] + data_launches["flash_attn_fwd_drop"],
         "max_abs_err": errs["flash_attn_fwd_drop"], **timing["flash_attn_fwd_drop"]},
        {"name": "flash_attn_bwd_drop", "route": "cuda", "source": bwd_src,
         "replaces": "vitax/ops/attention.py:659",
         "launches": drop_launches["flash_attn_bwd_drop"] + data_launches["flash_attn_bwd_drop"],
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
    # rates; the times are N 4096, rate 0.
    fwd_launches = long_launches["flash_attn_fwd_stream"] + long_launches["flash_attn_fwd_stream_drop"]
    bwd_launches = long_launches["flash_attn_bwd_stream"] + long_launches["flash_attn_bwd_stream_drop"]
    for name, src, line, launches in (("flash_attn_fwd_stream", fwd_src, 63, fwd_launches),
                                      ("flash_attn_bwd_stream", bwd_src, 244, bwd_launches),
                                      ("flash_attn_bwd_stream_dkdv", bwd_src, 152, bwd_launches),
                                      ("flash_attn_bwd_stream_dq", bwd_src, 205, bwd_launches),
                                      ("flash_attn_bwd_stream_general", bwd_src, 244,
                                       long_launches["flash_attn_bwd_general"])):
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
    card = phase_env(torch)
    phase_build()
    errs = phase_kernel_check(torch)
    errs.update(check_streaming(torch))
    timing = phase_kernel_timing(torch, card)
    timing.update(time_streaming(torch, card))
    phase_model_check(torch)
    serve_launches, engine_f32 = phase_main_path(torch, card)
    quant_launches = phase_quant_serve(torch, card, engine_f32)
    del engine_f32
    gc.collect()                           # free the 40 GB engine before the train path
    torch.cuda.empty_cache()
    train_launches, (errs["fused_adamw_table"], timing["fused_adamw"]), loss0, fake, ref7 = phase_train(torch, card)
    drop_launches = phase_train_dropout(torch, card, loss0)
    long_launches = phase_train_long(torch, card)
    with tempfile.TemporaryDirectory(prefix="vitax_torch_smoke_") as root:
        write_tree(os.path.join(root, "tree"))
        tree_launches, use_native = phase_train_tree(torch, card, root, fake)
        stream_launches = phase_train_stream(torch, card, root, use_native)
        time_loaders(torch, root, card, use_native)
        ckpt_launches = phase_checkpoint(torch, card, root)
        fsdp_launches = phase_train_fsdp(torch, card, root, ref7)
    data_launches = {k: tree_launches[k] + stream_launches[k] + ckpt_launches[k] + fsdp_launches[k]
                     for k in tree_launches}
    kernels = kernels_line(errs, timing, serve_launches, quant_launches, train_launches, drop_launches,
                           long_launches, data_launches)
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
