"""Long-context ladder of the port: ms per train step at the ViT-L width
past 2048 tokens, and the longest sequence that trains.

The counterpart of tools/long_context_ladder.py, with its shape and
method: ViT-L width (D 1024, 16 heads, Dh 64, patch 14), 4 blocks, batch
2, bf16, per-block remat with none_saveable, N set by the image side
(side = 14 sqrt(N)); each row in a fresh subprocess, so an
out-of-memory row cannot poison the rest; seeded random images and labels;
3 warm steps, then --steps timed steps ending in a device sync.

Arms: the dense path (--no_flash_attention) at --dense_n (4096), the
streaming kernels at --ns (4096 and 9216), then the frontier --frontier,
which stops at the first row that runs out of memory or whose step takes
more than --max_step_s; the last line says which stopped it.

There is no (block_q, block_k) sweep: on the card the streaming entries
run the kernels' own tiles (block_q and block_k tile only the plain
versions), and the JAX ladder's winning blocks are a TPU result.

Each row is one JSON line on stdout: {"n", "dense", "device",
"ms_per_step", "peak_gb", "loss", "timed_steps", "error"}. A file is
written only with --out (appended to). --device cpu with small
--embed_dim, --num_heads, --num_blocks and --patch_size runs the same code
on the CPU.

    python -m vitax_torch.tools.long_context_ladder [--steps 10] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RESULT = "LADDER_ROW "
WARM_STEPS = 3
BATCH = 2
ROW_TIMEOUT_S = 900


def run_row(spec: dict) -> dict:
    """Train-step time of one configuration, in this process."""
    import numpy as np
    import torch

    from vitax_torch.config import Config
    from vitax_torch.models.vit import build_model
    from vitax_torch.ops.attention import make_attention_impl
    from vitax_torch.platform import resolve_device
    from vitax_torch.train.state import build_optimizer, make_train_state
    from vitax_torch.train.step import make_train_step

    device = resolve_device(spec["device"])
    side = spec["patch_size"] * math.isqrt(spec["n"])
    cfg = Config(image_size=side, patch_size=spec["patch_size"], embed_dim=spec["embed_dim"],
                 num_heads=spec["num_heads"], num_blocks=spec["num_blocks"], num_classes=1000, batch_size=BATCH,
                 warmup_steps=0, grad_ckpt=True, remat_policy="none_saveable",
                 use_flash_attention=not spec["dense"]).validate()
    if cfg.num_patches != spec["n"]:
        raise ValueError(f"N {spec['n']} is not a square: side {side} gives {cfg.num_patches} tokens")

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = build_model(cfg, device, attention_impl=make_attention_impl(cfg, device)).train()
    optimizer, _ = build_optimizer(cfg, max_iteration=100)
    state = make_train_state(model)
    step = make_train_step(cfg, optimizer, device)
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(rng.normal(size=(cfg.batch_size, side, side, 3)).astype(np.float32)).to(device),
             "label": torch.from_numpy(rng.integers(0, 1000, size=cfg.batch_size)).to(device)}

    def peak_gb() -> Optional[float]:
        return torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None

    for _ in range(WARM_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        warm_s = time.perf_counter() - t0
    if warm_s > spec["max_step_s"]:       # the last warm step already says the row is too slow
        return {"ms_per_step": warm_s * 1e3, "peak_gb": peak_gb(), "loss": None, "timed_steps": 0}
    sync()
    t0 = time.perf_counter()
    for _ in range(spec["steps"]):
        state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    sync()
    dt = time.perf_counter() - t0
    if not math.isfinite(loss):
        raise FloatingPointError(f"loss {loss}")
    return {"ms_per_step": dt / spec["steps"] * 1e3, "peak_gb": peak_gb(), "loss": loss,
            "timed_steps": spec["steps"]}


def _worker(spec: dict) -> int:
    """Subprocess body: one row, printed after RESULT; an out-of-memory
    error is a row too (its error names it)."""
    import torch
    try:
        out = run_row(spec)
        out["error"] = None
    except torch.cuda.OutOfMemoryError as e:
        out = {"ms_per_step": None, "error": f"OOM: {str(e).splitlines()[0][:300]}"}
    print(RESULT + json.dumps(out), flush=True)
    return 0


def measure(spec: dict) -> dict:
    """One row in a fresh subprocess."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    cmd = [sys.executable, "-m", "vitax_torch.tools.long_context_ladder", "--row", json.dumps(spec)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=ROW_TIMEOUT_S, env=env)
    except subprocess.TimeoutExpired:
        return {"ms_per_step": None, "error": f"timeout after {ROW_TIMEOUT_S} s"}
    for line in r.stdout.splitlines():
        if line.startswith(RESULT):
            return json.loads(line[len(RESULT):])
    return {"ms_per_step": None, "error": f"rc {r.returncode}: " + (r.stderr or "")[-400:].replace("\n", " ")}


def stopped_by(row: dict, max_step_s: float) -> Optional[str]:
    """Why the frontier stops at this row: "oom", "max_step_s", "error",
    or None to go on."""
    if row["error"]:
        return "oom" if row["error"].startswith("OOM") else "error"
    return "max_step_s" if row["ms_per_step"] > max_step_s * 1e3 else None


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--ns", type=int, nargs="*", default=[4096, 9216])
    ap.add_argument("--dense_n", type=int, default=4096, help="N of the dense arm (0: no dense arm)")
    ap.add_argument("--frontier", type=int, nargs="*", default=[16384, 25600, 36864, 65536])
    ap.add_argument("--max_step_s", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--embed_dim", type=int, default=1024)
    ap.add_argument("--num_heads", type=int, default=16)
    ap.add_argument("--num_blocks", type=int, default=4)
    ap.add_argument("--patch_size", type=int, default=14)
    ap.add_argument("--out", default="", help="append the rows to this JSONL file (default: stdout only)")
    ap.add_argument("--row", default="", help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.row:
        return _worker(json.loads(args.row))
    if args.device.startswith("cuda"):
        from vitax_torch.ops import _build
        _build.build_all()                  # once, so no row's first step pays for nvcc

    def record(n: int, dense: bool) -> dict:
        spec = dict(n=n, dense=dense, steps=args.steps, device=args.device, embed_dim=args.embed_dim,
                    num_heads=args.num_heads, num_blocks=args.num_blocks, patch_size=args.patch_size,
                    max_step_s=args.max_step_s)
        row = {"n": n, "dense": dense, "device": args.device, **measure(spec)}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        return row

    if args.dense_n:
        record(args.dense_n, dense=True)
    for n in args.ns:
        record(n, dense=False)
    stop, largest = None, None
    for n in args.frontier:
        row = record(n, dense=False)
        stop = stopped_by(row, args.max_step_s)
        if stop:
            break
        largest = n
    print(json.dumps({"frontier": args.frontier, "largest_n_within_limits": largest, "stopped_by": stop,
                      "max_step_s": args.max_step_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
