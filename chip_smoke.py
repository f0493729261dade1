#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (vitax_torch), run from the
repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each printing one line (or a few), any failure exits non-zero:
  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: every kernel under vitax_torch/csrc/ with nvcc (sm_90a), all
     started together, with seconds and the ptxas register / spill report;
  3. kernel check: each kernel against its plain PyTorch version on the
     card, at the shapes the serve and train paths give it plus small
     ragged ones (the attention backward with a nonzero dlse and a bitwise
     repeat; the fused optimizer over leaves of assorted sizes, with the
     clip triggered and idle; the dequant matmul weight-only with int8 and
     fp8 weights, and act mode bitwise);
  4. kernel timing (CUDA events) of the attention kernels and the dequant
     matmul at their main-path shapes, beside the plain version, PyTorch's
     own library call and the least time the card could take;
  5. model check: the 10B-width ViT at depth 2 with the kernels against the
     dense path on the same weights: logits (no grad), then the loss and
     every parameter's gradient (bf16, batch 8); then its weights
     quantized, with the dequant matmul against its plain versions;
  6. serve main path: a full-width, full-depth 10B InferenceEngine (seeded
     init on the card) behind the HTTP server, answering 32 /predict
     requests from 8 threads and one /predict_batch of 8 images, with every
     kernel's launch count read around exactly that traffic, then a
     profile of one bucket-8 forward;
  6q. quantized serving: that model quantized on the card to int8 and to
     fp8, three engines (int8 weight-only, int8 with int8 activations, fp8
     weight-only) each answering the same traffic over HTTP, with
     dequant_matmul's launches checked at 129 per engine batch, the
     footprint, a profile of one bucket-8 forward, latency, and an accuracy
     gate against the full-precision engine on 64 seeded images;
  7. train main path: train() on the 10B-width model cut to depth 8, batch
     32, fake data, 12 steps and a 2-batch eval, with the launch counts of
     the run checked against the steps, sec/iter, images/s, MFU and peak
     memory; then a profile of one steady step, and the fused optimizer
     on the trained state's own leaf table: one launch held element by
     element against the plain version, then timed;
  8. a `kernels` JSON line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

It imports nothing of JAX or of the JAX package. Without a card, or
without the vitax_torch package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import base64
import gc
import json
import os
import subprocess
import sys
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

SERVE_SHAPE = (8, 256, 32, 160)          # (B, N, H, Dh) of the 10B model at bucket 8
TRAIN_SHAPE = (32, 256, 32, 160)         # ... at the train path's batch 32
CHECK_SHAPES = (SERVE_SHAPE, (4, 256, 16, 64), (2, 50, 2, 16), (2, 197, 4, 64))
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
DEQUANT_CHECK_SHAPES = ((5, 33, 17), (130, 257, 96), (1, 8, 4), (200, 520, 300))
# Weight-only: max |d| <= tol * max |ref| against the f32 plain version. bf16
# x: the tensor cores sum exact bf16 products in another order (and truncate
# inside an mma), f32 x: FMAs in another order. The worst readings at these
# shapes on an H100 80GB HBM3 at 700 W were 2.10e-5 (bf16, K 20480) and
# 2.76e-6 (f32, K 5120) of max |ref| (PERF.md), so the bars are about 3x and
# 3.6x those. Act mode must be bitwise equal. A check whose scales are
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


def phase_build():
    from vitax_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name, log in logs.items():
        ptxas = [ln.strip() for ln in log["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        say(f"[2 build] {name}: {log['seconds']:.1f}s nvcc ({'cached' if log['cached'] else 'built'})")
        for ln in ptxas:
            say(f"[2 build]   {ln}")
    say(f"[2 build] all kernels in {time.perf_counter() - t0:.1f}s")


def phase_kernel_check(torch):
    from vitax_torch.ops.attention import attention_fwd_with_lse, flash_attn_fwd_cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    with torch.inference_mode():
        for shape in CHECK_SHAPES:
            for dtype in ("bfloat16", "float32"):
                q, k, v = qkv_views(torch, shape, dtype, SEED)
                scale = shape[-1] ** -0.5
                o, lse = flash_attn_fwd_cuda(q, k, v, scale)
                o_ref, lse_ref = attention_fwd_with_lse(q, k, v, scale)
                torch.cuda.synchronize()
                d_o = (o.float() - o_ref.float()).abs().max().item()
                d_lse = (lse - lse_ref).abs().max().item()
                finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(lse).all())
                tol_o, tol_lse = TOL[dtype]
                ok = finite and d_o <= tol_o and d_lse <= tol_lse
                say(f"[3 check] flash_attn_fwd {shape} {dtype}: max|do| {d_o:.3e} (<= {tol_o}) "
                    f"max|dlse| {d_lse:.3e} (<= {tol_lse}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"flash_attn_fwd disagrees with its plain version at {shape} {dtype}")
                errs[(shape, dtype)] = d_o
    errs["flash_attn_bwd"] = check_attention_backward(torch)
    errs["fused_adamw"] = check_fused_adamw(torch)
    errs["dequant_matmul"] = check_dequant_matmul(torch)
    return errs


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


def check_dequant_matmul(torch) -> float:
    """Kernel C against its plain versions: weight-only with int8 and fp8
    weights and bf16 x at the five main-path (K, F) pairs (M 2048, and the
    head at M 1 and 8), plus f32 x at ragged small shapes; act mode (int8 x
    int8) bitwise at all of them. Each check also measures how far a broken
    kernel would land (scales dropped; sx forced to 1) and fails unless
    that is beyond the bar. Returns max |d| of weight-only at the main-path
    shapes."""
    from vitax_torch.ops.dequant_matmul import _matmul_plain, dequant_matmul_cuda, quantize_activations
    shapes = [(2048, k, f) for _, k, f, n in DEQUANT_SITES if n > 1] + [(1, 5120, 1000), (8, 5120, 1000)]
    shapes += list(DEQUANT_CHECK_SHAPES)
    worst = 0.0
    with torch.inference_mode():
        for i, (m, k, f) in enumerate(shapes):
            on_path = m in (2048, 8) and (k, f) in {(kk, ff) for _, kk, ff, _ in DEQUANT_SITES}
            for dtype in ("int8", "float8_e4m3"):
                x, q, s = dequant_operands(torch, m, k, f, dtype, SEED + i)
                for xdt in (("bfloat16",) if m == 2048 else ("bfloat16", "float32")):
                    xx = x.to(getattr(torch, xdt))
                    got = dequant_matmul_cuda(xx, q, s)
                    want = _matmul_plain(xx, q, s, None)
                    dropped = _matmul_plain(xx, q, torch.ones_like(s), None)
                    torch.cuda.synchronize()
                    ref = want.abs().max().item()
                    d = (got - want).abs().max().item()
                    d_broken = (got - dropped).abs().max().item()
                    bar = DEQUANT_TOL[xdt] * ref
                    ok = bool(torch.isfinite(got).all()) and d <= bar and d_broken > bar
                    say(f"[3 check] dequant_matmul {m}x{k}x{f} {dtype} w, {xdt} x: max|d| {d:.3e} "
                        f"(<= {bar:.3e}, max|ref| {ref:.3e}, ratio {d / ref:.2e}); scales dropped: "
                        f"{d_broken:.3e} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        fail(f"dequant_matmul disagrees with its plain version at {m}x{k}x{f} {dtype} {xdt}")
                    if on_path and xdt == "bfloat16":
                        worst = max(worst, d)
                if dtype == "int8":
                    xq, sx = quantize_activations(x.to(torch.bfloat16))
                    got = dequant_matmul_cuda(xq, q, s, sx)
                    want = _matmul_plain(xq, q, s, sx)
                    forced = _matmul_plain(xq, q, s, torch.ones_like(sx))
                    torch.cuda.synchronize()
                    equal = torch.equal(got, want)
                    d_broken = (got - forced).abs().max().item()
                    ok = equal and d_broken > DEQUANT_TOL["bfloat16"] * want.abs().max().item()
                    say(f"[3 check] dequant_matmul {m}x{k}x{f} act int8 x int8: bitwise equal {equal}; "
                        f"sx forced to 1: max|d| {d_broken:.3e} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        fail(f"dequant_matmul act mode is not bitwise equal to its plain version at {m}x{k}x{f}")
                del x, q, s
    torch.cuda.empty_cache()
    return worst


def check_attention_backward(torch) -> float:
    """The backward kernel against its plain version, bf16 and f32, with a
    nonzero dlse, at the train shape and the ragged shapes; each call twice,
    bitwise equal. Returns max |d| at the train shape in bf16."""
    from vitax_torch.ops.attention import attention_bwd_with_lse, flash_attn_bwd_cuda, flash_attn_fwd_cuda
    worst = 0.0
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
                got = flash_attn_bwd_cuda(q, k, v, o, lse, do, dlse, scale)
                again = flash_attn_bwd_cuda(q, k, v, o, lse, do, dlse, scale)
                want = attention_bwd_with_lse(q, k, v, o, lse, do, dlse, scale)
                no_dlse = attention_bwd_with_lse(q, k, v, o, lse, do, None, scale)
                torch.cuda.synchronize()
                errs = [(a.float() - w.float()).abs().max().item() for a, w in zip(got, want)]
                refs = [w.float().abs().max().item() for w in want]
                bars = [BWD_TOL[dtype] * r for r in refs]
                dlse_term = [(w.float() - w0.float()).abs().max().item() for w, w0 in zip(want[:2], no_dlse[:2])]
                repeat = all(torch.equal(a, a2) for a, a2 in zip(got, again))
                finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
                visible = all(t > b for t, b in zip(dlse_term, bars[:2]))
                ok = finite and repeat and visible and all(e <= b for e, b in zip(errs, bars))
                say(f"[3 check] flash_attn_bwd {shape} {dtype}: "
                    + ", ".join(f"{nm} max|d| {e:.3e} (<= {b:.3e}, max|ref| {r:.3e}, ratio {e / r:.2e})"
                                for nm, e, b, r in zip(("dq", "dk", "dv"), errs, bars, refs))
                    + f"; dlse term moves dq {dlse_term[0]:.3e} dk {dlse_term[1]:.3e}; bitwise repeat "
                    f"{repeat} {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"flash_attn_bwd disagrees with its plain version at {shape} {dtype}")
                d = max(errs)
                if shape == TRAIN_SHAPE and dtype == "bfloat16":
                    worst = d
    return worst


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


def phase_kernel_timing(torch, card):
    import torch.nn.functional as F
    from vitax_torch.ops.attention import attention_fwd_with_lse, flash_attn_fwd_cuda
    q, k, v = qkv_views(torch, SERVE_SHAPE, "bfloat16", SEED)
    scale = SERVE_SHAPE[-1] ** -0.5
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    with torch.inference_mode():
        kernel_ms = time_ms(torch, lambda: flash_attn_fwd_cuda(q, k, v, scale), iters=100)
        plain_ms = time_ms(torch, lambda: attention_fwd_with_lse(q, k, v, scale), iters=20)
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), iters=100)
        kernel_ms2 = time_ms(torch, lambda: flash_attn_fwd_cuda(q, k, v, scale), iters=100)
    bound_ms, bound_by, nbytes, flops = attention_bound_ms(SERVE_SHAPE, "bfloat16")
    say(f"[4 time] flash_attn_fwd {SERVE_SHAPE} bf16: kernel {kernel_ms:.4f} / {kernel_ms2:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) [{card}]")
    timing = {"flash_attn_fwd": {"ms": min(kernel_ms, kernel_ms2), "plain_ms": plain_ms,
                                 "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}}
    timing["flash_attn_bwd"] = time_attention_train_shape(torch, card)
    timing["dequant_matmul"] = time_dequant_matmul(torch, card)
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
    """Kernel C at each main-path site (M 2048; the head at M 8), CUDA
    events: weight-only with int8 and fp8 weights (bf16 x) and act mode,
    beside the plain versions, the bound and the library yardsticks
    (weight-only: F.linear on a weight dequantized to bf16 beforehand, which
    reads 2 bytes a weight where the kernel reads 1; act: torch._int_mm and
    the same epilogue). Returns the weight-only int8 timing summed over the
    129 launches of one bucket-8 forward, the `kernels` line's entry."""
    import torch.nn.functional as F
    from vitax_torch.ops.dequant_matmul import _matmul_plain, dequant_matmul_cuda, quantize_activations
    sums = {key: 0.0 for key in ("wo", "wo2", "fp8", "act", "plain", "plain_act", "lib", "lib_act", "bound",
                                 "bound_act")}
    fwd_bytes = fwd_ops = 0
    with torch.inference_mode():
        for i, (site, k, f, n) in enumerate(DEQUANT_SITES):
            m = 2048 if n > 1 else 8
            x, q, s = dequant_operands(torch, m, k, f, "int8", SEED + 40 + i)
            xb = x.to(torch.bfloat16)
            _, q8, s8 = dequant_operands(torch, m, k, f, "float8_e4m3", SEED + 40 + i)
            wd = (q.float() * s[:, None]).to(torch.bfloat16)
            iters = 20 if n > 1 else 200
            wo = time_ms(torch, lambda: dequant_matmul_cuda(xb, q, s), iters=iters)
            fp8 = time_ms(torch, lambda: dequant_matmul_cuda(xb, q8, s8), iters=iters)
            plain = time_ms(torch, lambda: _matmul_plain(xb, q, s, None), iters=max(3, iters // 10))
            lib = time_ms(torch, lambda: F.linear(xb, wd), iters=iters)
            wo2 = time_ms(torch, lambda: dequant_matmul_cuda(xb, q, s), iters=iters)
            b_ms, b_by, nbytes, ops = dequant_bound_ms(m, k, f, act=False)
            line = (f"[4 time] dequant_matmul {site} {m}x{k}x{f}: weight-only int8 {wo:.4f} / {wo2:.4f} ms, "
                    f"fp8 {fp8:.4f} ms, plain {plain:.4f} ms, F.linear bf16 {lib:.4f} ms, bound {b_ms:.4f} ms "
                    f"({b_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP)")
            for key, v in (("wo", wo), ("wo2", wo2), ("fp8", fp8), ("plain", plain), ("lib", lib), ("bound", b_ms)):
                sums[key] += n * v
            fwd_bytes, fwd_ops = fwd_bytes + n * nbytes, fwd_ops + n * ops
            if n > 1:                                   # the head never act-quantizes
                xq, sx = quantize_activations(xb)
                act = time_ms(torch, lambda: dequant_matmul_cuda(xq, q, s, sx), iters=iters)
                plain_act = time_ms(torch, lambda: _matmul_plain(xq, q, s, sx), iters=3)
                lib_act = time_ms(torch, lambda: (torch._int_mm(xq, q.t()).float() * sx) * s, iters=iters)
                a_ms, a_by, _, _ = dequant_bound_ms(m, k, f, act=True)
                line += (f"; act {act:.4f} ms, plain {plain_act:.4f} ms, _int_mm + epilogue {lib_act:.4f} ms, "
                         f"bound {a_ms:.4f} ms ({a_by})")
                for key, v in (("act", act), ("plain_act", plain_act), ("lib_act", lib_act), ("bound_act", a_ms)):
                    sums[key] += n * v
            else:                                       # so the act forward runs it weight-only
                for key, v in (("act", wo), ("plain_act", plain), ("lib_act", lib), ("bound_act", b_ms)):
                    sums[key] += n * v
            say(line + f" [{card}]")
            del x, q, s, xb, q8, s8, wd
    torch.cuda.empty_cache()
    say(f"[4 time] dequant_matmul, one bucket-8 forward's {sum(n for *_, n in DEQUANT_SITES)} launches: "
        f"weight-only int8 {sums['wo']:.3f} / {sums['wo2']:.3f} ms, fp8 {sums['fp8']:.3f} ms, plain "
        f"{sums['plain']:.3f} ms, F.linear bf16 {sums['lib']:.3f} ms, bound {sums['bound']:.3f} ms; act (head "
        f"weight-only) {sums['act']:.3f} ms, plain {sums['plain_act']:.3f} ms, _int_mm {sums['lib_act']:.3f} ms, "
        f"bound {sums['bound_act']:.3f} ms [{card}]")
    # the forward's 129 calls as one piece of work: its bytes and its operations
    t_bytes, t_ops = fwd_bytes / HBM_BYTES_PER_S * 1e3, fwd_ops / PEAK_FLOPS["bfloat16"] * 1e3
    return {"ms": min(sums["wo"], sums["wo2"]), "plain_ms": sums["plain"], "library_ms": sums["lib"],
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_attention_train_shape(torch, card):
    """The forward and the backward kernel at the train shape (bf16, dlse
    None as the train path calls it). library_ms of the backward is
    PyTorch's flash-attention backward op on the outputs of its own flash
    forward (torch.ops.aten._scaled_dot_product_flash_attention_backward)."""
    import torch.nn.functional as F
    from vitax_torch.ops.attention import (attention_bwd_with_lse, attention_fwd_with_lse,
                                           flash_attn_bwd_cuda, flash_attn_fwd_cuda)
    q, k, v = qkv_views(torch, TRAIN_SHAPE, "bfloat16", SEED + 3)
    scale = TRAIN_SHAPE[-1] ** -0.5
    rng = np.random.default_rng(SEED + 4)
    do = torch.from_numpy(rng.standard_normal(TRAIN_SHAPE).astype(np.float32)).to("cuda", torch.bfloat16)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: flash_attn_fwd_cuda(q, k, v, scale), iters=50)
        fwd_plain_ms = time_ms(torch, lambda: attention_fwd_with_lse(q, k, v, scale), iters=10)
        fwd_lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), iters=50)
        o, lse = flash_attn_fwd_cuda(q, k, v, scale)
        sdpa = torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, False, False, scale=scale)

        def library_bwd():
            return torch.ops.aten._scaled_dot_product_flash_attention_backward(
                dot, qt, kt, vt, sdpa[0], sdpa[1], sdpa[2], sdpa[3], sdpa[4], sdpa[5], 0.0, False,
                sdpa[6], sdpa[7], scale=scale)

        bwd_ms = time_ms(torch, lambda: flash_attn_bwd_cuda(q, k, v, o, lse, do, None, scale), iters=50)
        plain_ms = time_ms(torch, lambda: attention_bwd_with_lse(q, k, v, o, lse, do, None, scale), iters=10)
        library_ms = time_ms(torch, library_bwd, iters=50)
        bwd_ms2 = time_ms(torch, lambda: flash_attn_bwd_cuda(q, k, v, o, lse, do, None, scale), iters=50)
    fb_ms, fb_by, fb_bytes, fb_flops = attention_bound_ms(TRAIN_SHAPE, "bfloat16")
    say(f"[4 time] flash_attn_fwd {TRAIN_SHAPE} bf16: kernel {fwd_ms:.4f} ms, plain {fwd_plain_ms:.4f} ms, "
        f"sdpa {fwd_lib_ms:.4f} ms, bound {fb_ms:.4f} ms ({fb_by}: {fb_bytes / 1e6:.1f} MB, "
        f"{fb_flops / 1e9:.2f} GFLOP) [{card}]")
    bound_ms, bound_by, nbytes, flops = attention_bwd_bound_ms(TRAIN_SHAPE, "bfloat16")
    say(f"[4 time] flash_attn_bwd {TRAIN_SHAPE} bf16: kernel {bwd_ms:.4f} / {bwd_ms2:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa flash backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) [{card}]")
    return {"ms": min(bwd_ms, bwd_ms2), "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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
    if _build.LAUNCHES["flash_attn_bwd"] - before["flash_attn_bwd"] != cfg.num_blocks:
        fail("the model's backward did not go through flash_attn_bwd once per block")
    groups = {}
    for name, g_k in grads[0].items():
        g_d = grads[1][name]
        key = "blocks." + name.split(".", 2)[2] if name.startswith("blocks.") else name
        r = ((g_k - g_d).abs().max() / g_d.abs().max().clamp_min(1e-30)).item()
        finite = bool(torch.isfinite(g_k).all())
        groups[key] = max(groups.get(key, 0.0), r if finite else float("inf"))
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    worst = max(groups.values())
    ok = loss_rel <= MODEL_LOSS_REL_TOL and worst <= MODEL_GRAD_REL_TOL
    say(f"[5 model] loss kernels {losses[0]:.6f} dense {losses[1]:.6f} (rel {loss_rel:.2e} <= {MODEL_LOSS_REL_TOL}); "
        f"grads max|dg|/max|g| per leaf group (<= {MODEL_GRAD_REL_TOL}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(groups.items())) + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("model gradients with the kernels disagree with the dense model's")
    del dense, x, grads
    check_quant_model(torch, model, images)
    del model
    torch.cuda.empty_cache()


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


KERNEL_GROUPS = (("flash_attn_fwd", r"flash_attn_fwd"), ("flash_attn_bwd", r"bwd_dkdv|bwd_dq|delta_kernel"),
                 ("fused_adamw", r"fused_adamw"), ("dequant_matmul", r"dequant_matmul"),
                 ("gemm", r"gemm|xmma|nvjet|cutlass|sm90_"))


def profile_device(torch, fn, label: str, card: str, phase: str, top: int = 8) -> None:
    """Where one call of `fn` spends device time (torch.profiler): wall,
    device busy and idle, time by kernel group, the top kernels."""
    import re
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if not kernels or busy_ms <= 0:
        fail(f"torch.profiler recorded no device time for {label}")
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for name, ms, _ in kernels:
        key = next((g for g, pat in KERNEL_GROUPS if re.search(pat, name)), "other")
        groups[key] += ms
    say(f"[{phase} profile] {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"(idle {max(0.0, 1 - busy_ms / wall_ms) * 100:.1f}%); "
        + ", ".join(f"{k} {v:.2f} ms ({v / busy_ms * 100:.1f}%)" for k, v in groups.items() if v > 0)
        + f" [{card}]")
    for name, ms, count in sorted(kernels, key=lambda k: -k[1])[:top]:
        say(f"[{phase} profile]   {ms:8.3f} ms  x{count:<4d} {name[:110]}")


def profile_forward(torch, engine, cfg, card):
    """Where one bucket-8 forward's device time goes, after the main path's
    counts were read."""
    x = np.zeros((8, cfg.image_size, cfg.image_size, 3), np.uint8)
    profile_device(torch, lambda: engine.predict(x), "bucket-8 forward", card, "6")


def serve_over_http(torch, engine, cfg, label: str):
    """Put `engine` behind the HTTP server and send it the main path's
    traffic: 32 /predict requests from 8 threads, then one /predict_batch of
    8 images, with every kernel's launch count read around exactly that
    traffic. Checks the answers and the server's counts; returns (launches,
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
    launches, metrics, batches, lat, wall = serve_over_http(torch, engine, cfg, "6 main")
    say(f"[6 main] {traffic_line(metrics, batches, lat, wall)}; "
        f"flash_attn_fwd launches {launches['flash_attn_fwd']}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")
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
        if metrics["weights_dtype"] != dtype or metrics["act_quant"] != act or metrics["fused_dequant"] is not True:
            fail(f"{label}: /metrics reports {metrics['weights_dtype']}, {metrics['act_quant']}, "
                 f"{metrics['fused_dequant']}")
        total = {name: total.get(name, 0) + v for name, v in launches.items()}
        say(f"[{label}] {traffic_line(metrics, batches, lat, wall)}; dequant_matmul launches "
            f"{launches['dequant_matmul']} ({per_forward} per batch), flash_attn_fwd {launches['flash_attn_fwd']}; "
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


def phase_train(torch, card):
    """The train main path: train() in process at the 10B width, depth 8,
    batch 32, fake data; then one profiled steady step and the fused
    optimizer checked and timed on the trained state. Returns (launches,
    (max |d| of B on the state's table, timing of B))."""
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
    # per optimizer step: a forward and a recompute per block, a backward per
    # block, one optimizer launch; the eval adds a forward per block per batch
    want = {"flash_attn_fwd": cfg.max_steps * 2 * cfg.num_blocks + cfg.eval_max_batches * cfg.num_blocks,
            "flash_attn_bwd": cfg.max_steps * cfg.num_blocks, "fused_adamw": cfg.max_steps, "dequant_matmul": 0}
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
    want_step = {"flash_attn_fwd": 2 * cfg.num_blocks, "flash_attn_bwd": cfg.num_blocks, "fused_adamw": 1,
                 "dequant_matmul": 0}
    if per_step != want_step or any(v % 2 for v in _build.LAUNCHES.values()):
        fail(f"two steady train steps launched {dict(_build.LAUNCHES)}; expected {want_step} a step")
    say(f"[7 train] launches per steady step {per_step}")
    del train_step, batch
    timing = time_fused_adamw(torch, state, card)
    del state
    torch.cuda.empty_cache()
    return launches, timing


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
    timing = phase_kernel_timing(torch, card)
    phase_model_check(torch)
    serve_launches, engine_f32 = phase_main_path(torch, card)
    quant_launches = phase_quant_serve(torch, card, engine_f32)
    del engine_f32
    gc.collect()                           # free the 40 GB engine before the train path
    torch.cuda.empty_cache()
    train_launches, (errs["fused_adamw_table"], timing["fused_adamw"]) = phase_train(torch, card)
    kernels = [
        {"name": "flash_attn_fwd", "route": "cuda", "source": "vitax_torch/csrc/flash_attn_fwd.cu",
         "replaces": "vitax/ops/attention.py:275",
         "launches": (serve_launches["flash_attn_fwd"] + quant_launches["flash_attn_fwd"]
                      + train_launches["flash_attn_fwd"]),
         "max_abs_err": errs[(SERVE_SHAPE, "bfloat16")], **timing["flash_attn_fwd"]},
        {"name": "flash_attn_bwd", "route": "cuda", "source": "vitax_torch/csrc/flash_attn_bwd.cu",
         "replaces": "vitax/ops/attention.py:302", "launches": train_launches["flash_attn_bwd"],
         "max_abs_err": errs["flash_attn_bwd"], **timing["flash_attn_bwd"]},
        {"name": "fused_adamw", "route": "cuda", "source": "vitax_torch/csrc/fused_adamw.cu",
         "replaces": "vitax/ops/fused_optimizer.py:112", "launches": train_launches["fused_adamw"],
         "max_abs_err": max(errs["fused_adamw"], errs["fused_adamw_table"]), **timing["fused_adamw"]},
        {"name": "dequant_matmul", "route": "cuda", "source": "vitax_torch/csrc/dequant_matmul.cu",
         "replaces": "vitax/ops/dequant_matmul.py:92", "launches": quant_launches["dequant_matmul"],
         "max_abs_err": errs["dequant_matmul"], **timing["dequant_matmul"]},
    ]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
