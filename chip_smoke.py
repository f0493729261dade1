#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (vitax_torch), run from the
repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each printing one line (or a few), any failure exits non-zero:
  1. environment: torch / CUDA versions, the card's name and power limit;
  2. build: every kernel under vitax_torch/csrc/ with nvcc (sm_90a), with
     its seconds and ptxas register / shared-memory report;
  3. kernel check: each kernel against its plain PyTorch version on the
     card, at the shapes the serve path gives it plus small ragged ones;
  4. kernel timing at the 10B serve shape (CUDA events), beside the least
     time the card could take and PyTorch's own library call;
  5. model check: the 10B-width ViT at depth 2, kernel vs dense attention
     on the same weights;
  6. the main path: a full-width, full-depth 10B InferenceEngine (seeded
     init on the card) behind the HTTP server, answering 32 /predict
     requests from 8 threads and one /predict_batch of 8 images, with every
     kernel's launch count read around exactly that traffic;
  7. a `kernels` JSON line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

It imports nothing of JAX or of the JAX package. Without a card, or
without the vitax_torch package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import base64
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
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

SERVE_SHAPE = (8, 256, 32, 160)          # (B, N, H, Dh) of the 10B model at bucket 8
CHECK_SHAPES = (SERVE_SHAPE, (4, 256, 16, 64), (2, 50, 2, 16), (2, 197, 4, 64))
TOL = {"bfloat16": (1.6e-2, 1e-3), "float32": (1e-5, 1e-5)}   # max |do|, max |dlse|
MODEL_REL_TOL = 2e-2
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
    return errs


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
    return {"ms": min(kernel_ms, kernel_ms2), "plain_ms": plain_ms, "library_ms": library_ms,
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
    del model, dense, x, got, want
    torch.cuda.empty_cache()


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


def profile_forward(torch, engine, cfg, card):
    """Where one bucket-8 forward's device time goes (torch.profiler), after
    the main path's counts were read."""
    import re
    from torch.profiler import ProfilerActivity, profile
    x = np.zeros((8, cfg.image_size, cfg.image_size, 3), np.uint8)
    engine.predict(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    if not kernels or busy_ms <= 0:
        fail("torch.profiler recorded no device time for the bucket-8 forward")
    groups = {"flash_attn_fwd": 0.0, "gemm": 0.0, "other": 0.0}
    for name, ms, _ in kernels:
        key = ("flash_attn_fwd" if "flash_attn_fwd" in name
               else "gemm" if re.search(r"gemm|xmma|nvjet|cutlass|sm90_", name) else "other")
        groups[key] += ms
    say(f"[6 profile] bucket-8 forward: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"(idle {max(0.0, 1 - busy_ms / wall_ms) * 100:.1f}%); "
        + ", ".join(f"{k} {v:.2f} ms ({v / busy_ms * 100:.1f}%)" for k, v in groups.items()) + f" [{card}]")
    for name, ms, count in sorted(kernels, key=lambda k: -k[1])[:6]:
        say(f"[6 profile]   {ms:8.3f} ms  x{count:<4d} {name[:110]}")


def phase_main_path(torch, card):
    from vitax_torch.config import Config
    from vitax_torch.models.vit import build_model, count_params
    from vitax_torch.ops import _build
    from vitax_torch.ops.attention import make_attention_impl
    from vitax_torch.serve import InferenceEngine, start_server, stop_server

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
            fail(f"requests failed: {errors[:4]}")
        health = http(url + "/healthz")
        metrics = http(url + "/metrics")
    finally:
        stop_server(httpd, ctx)

    for ans in answers:
        check_answer(ans, cfg.serve_topk, cfg.num_classes)
    items = batch_reply["results"]
    if len(items) != 8 or any(it["status"] != 200 for it in items):
        fail(f"/predict_batch items failed: {items}")
    batch_answers = [json.loads(it["body"]) for it in items]
    for ans in batch_answers:
        check_answer(ans, cfg.serve_topk, cfg.num_classes)
    if not health["ready"]:
        fail(f"/healthz not ready: {health}")
    if metrics["requests_total"] != 40 or metrics["errors_total"] != 0:
        fail(f"/metrics counts {metrics['requests_total']} requests, {metrics['errors_total']} errors; "
             f"expected 40 and 0")
    batches = metrics["batches_flushed"]
    per_forward = cfg.num_blocks
    if launches["flash_attn_fwd"] != per_forward * batches:
        fail(f"flash_attn_fwd launched {launches['flash_attn_fwd']} times for {batches} engine batches; "
             f"expected {per_forward} per batch")
    lat = np.sort(np.asarray(latencies))
    say(f"[6 main] 40 requests in {wall:.3f}s = {40 / wall:.2f} images/s; /predict latency p50 "
        f"{np.percentile(lat, 50) * 1e3:.1f} ms p95 {np.percentile(lat, 95) * 1e3:.1f} ms (client), "
        f"server p50 {metrics['latency_s_p50'] * 1e3:.1f} ms p95 {metrics['latency_s_p95'] * 1e3:.1f} ms; "
        f"{batches} engine batches, occupancy {metrics['batch_occupancy_mean']}; "
        f"flash_attn_fwd launches {launches['flash_attn_fwd']}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]")
    profile_forward(torch, engine, cfg, card)
    del engine, model
    torch.cuda.empty_cache()
    return launches


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
    launches = phase_main_path(torch, card)
    kernels = [{
        "name": "flash_attn_fwd", "route": "cuda", "source": "vitax_torch/csrc/flash_attn_fwd.cu",
        "replaces": "vitax/ops/attention.py:275", "launches": launches["flash_attn_fwd"],
        "max_abs_err": errs[(SERVE_SHAPE, "bfloat16")], **timing,
    }]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
