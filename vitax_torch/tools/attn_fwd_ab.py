"""The attention forward's wgmma kernel against variants of its source, on one card, in turns.

    python -m vitax_torch.tools.attn_fwd_ab VARIANT.cu [VARIANT.cu ...] [--iters 20]

Builds vitax_torch/csrc/flash_attn_fwd.cu (the tree's) and each VARIANT.cu
(a copy of it with one change, same C entry point, in the same directory
layout so its headers resolve: put it beside a copy of csrc/'s headers) with
the same nvcc flags. At the main path's bf16 shapes (the 10B serve and
train shapes, N 256, Dh 160; the long-context shape at N 4096 and 9216, Dh
64) and at rate 0 and 0.1 it holds every library's wgmma kernel against the
plain version (chip_smoke.py's bar, TOL), then times them with CUDA events
in turns (each variant, the tree, the tree, each variant in reverse order)
and keeps the better of each side's two readings. Prints a line a shape and
rate, with the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import numpy as np
import torch

from vitax_torch.ops import _build
from vitax_torch.ops.attention import KERNEL, Dropout, attention_fwd_with_lse, flash_attn_fwd_cuda

SHAPES = ((8, 256, 32, 160), (32, 256, 32, 160), (2, 4096, 16, 64), (2, 9216, 16, 64))
TOL_O = 1.6e-2                  # chip_smoke.py TOL["bfloat16"]: max |do|, max |dlse|
TOL_LSE = 1e-3


def wgmma_entry(ln: str):
    """`name<DH, DROP>` of the wgmma kernel instantiation whose mangled
    name a ptxas or cuobjdump line holds, else None."""
    m = re.search(r"\d([a-z][a-z_]*wgmma_kernel)ILi(\d+)ELb(\d)E", ln)     # length, then the name
    return f"{m.group(1)}<{m.group(2)}, {'true' if m.group(3) == '1' else 'false'}>" if m else None


def wgmma_report(name: str, ptxas: str) -> None:
    """Registers and spills of each wgmma instantiation in an nvcc -Xptxas -v
    report, and ptxas's warnings about them."""
    entry = None
    for ln in ptxas.splitlines():
        if "Compiling entry function" in ln:
            entry = wgmma_entry(ln)
        elif entry and ("spill" in ln or "Used" in ln):
            print(f"{name}: {entry}: {ln.split(':', 1)[-1].strip()}", flush=True)
        elif "C75" in ln:
            print(f"{name}: {ln.strip()[:200]}", flush=True)


def time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(fn, patterns, calls: int) -> dict:
    """Device ms per launch of the kernels whose names match each of
    `patterns` ({piece: regex}), from torch.profiler over `calls` calls of
    `fn`: the recorded time over the recorded launches, which need not be
    all of them; nan for a piece with no recorded device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for piece, pat in patterns.items():
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and re.search(pat, e.key)]
        total_ms, count = sum(e.self_device_time_total for e in events) / 1e3, sum(e.count for e in events)
        out[piece] = total_ms / count if count and total_ms > 0 else float("nan")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+", help="variants of vitax_torch/csrc/flash_attn_fwd.cu")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_fwd_ab: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    libs = {"tree": _build.load(KERNEL)}
    wgmma_report("tree", _build._build_log[KERNEL]["ptxas"])
    names = [os.path.basename(p) for p in args.variants]
    for i, (name, path) in enumerate(zip(names, args.variants)):
        libs[name] = _build.load_variant(path, f"flash_attn_fwd_variant{i}")
        wgmma_report(name, libs[name].ptxas)
    order = names + ["tree", "tree"] + names[::-1]
    with torch.inference_mode():
        for shape in SHAPES:
            arr = np.random.default_rng(0).standard_normal((shape[0], shape[1], 3, *shape[2:])).astype(np.float32)
            qkv = torch.from_numpy(arr).to("cuda", torch.bfloat16)
            q, k, v = qkv.unbind(2)
            scale = shape[-1] ** -0.5
            for rate in (0.0, 0.1):
                drop = Dropout(2024, rate) if rate else None
                o_ref, lse_ref = attention_fwd_with_lse(q, k, v, scale, drop) if shape[1] <= 4096 else (None, None)
                best = {}
                for side in order:
                    _build._libs[KERNEL] = libs[side]
                    if o_ref is not None:
                        o, lse = flash_attn_fwd_cuda(q, k, v, scale, drop, kernel="wgmma")
                        torch.cuda.synchronize()
                        d_o = (o.float() - o_ref.float()).abs().max().item()
                        d_lse = (lse - lse_ref).abs().max().item()
                        if not (d_o <= TOL_O and d_lse <= TOL_LSE):
                            raise SystemExit(f"attn_fwd_ab: {side} disagrees with the plain version at {shape} rate "
                                             f"{rate}: max|do| {d_o:.3e}, max|dlse| {d_lse:.3e}")
                    t = time_ms(lambda: flash_attn_fwd_cuda(q, k, v, scale, drop, kernel="wgmma"), args.iters)
                    best[side] = min(best.get(side, t), t)
                print(f"{shape} rate {rate}: " + ", ".join(f"{side} {best[side]:.4f}" for side in ["tree", *names])
                      + f" ms{' (checked)' if o_ref is not None else ''} [{card}]", flush=True)
                del o_ref, lse_ref
            del qkv, q, k, v
            torch.cuda.empty_cache()
    _build._libs[KERNEL] = libs["tree"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
