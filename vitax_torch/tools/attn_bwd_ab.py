"""The attention backward's wgmma kernels against variants of their source, on one card, in turns.

    python -m vitax_torch.tools.attn_bwd_ab [VARIANT.cu ...] [--iters 20]

Builds vitax_torch/csrc/flash_attn_bwd.cu (the tree's) and each VARIANT.cu
(a copy of it with one change, same C entry point, beside copies of
csrc/'s headers so they resolve) with the same nvcc flags, and prints each
build's registers and spills of the wgmma kernels and, from the SASS
(cuobjdump), each wgmma kernel's HGMMA and atomic instructions. Then it
holds every
library's wgmma kernels, and the tree's general kernels, against the plain
version (chip_smoke.py's bar, max |d| <= TOL max |ref| for each of dq, dk,
dv, with a nonzero dlse, and a bitwise repeat) at ragged shapes (N 1, 63,
129, 257, 2049; Dh 64, 128 and 160; rate 0 and 0.1 with offsets past 2048)
and at the main path's bf16 shapes (the 10B train shape, N 256, Dh 160;
ViT-L at N 4096 and 9216, Dh 64, checked up to 4096). At the main-path
shapes and rate 0 and 0.1 it times the calls with CUDA events in turns
(the general kernels, each variant, the tree, the tree, each variant in
reverse order, the general kernels), keeps the better of each side's
readings, and splits the tree's call into its dK/dV, dQ and delta kernels
with torch.profiler. Prints a line a shape and rate, with the card's name
and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from vitax_torch.ops import _build
from vitax_torch.ops.attention import (
    BWD_KERNEL,
    Dropout,
    attention_bwd_with_lse,
    flash_attn_bwd_cuda,
    flash_attn_fwd_cuda,
)
from vitax_torch.tools.attn_fwd_ab import wgmma_entry, profiled_ms, time_ms, wgmma_report

CHECK_SHAPES = ((1, 1, 2, 64), (1, 63, 2, 64), (2, 129, 2, 128), (1, 257, 3, 160), (1, 2049, 2, 64),
                (2, 200, 2, 160))
MAIN_SHAPES = ((32, 256, 32, 160), (2, 4096, 16, 64), (2, 9216, 16, 64))
OFFSETS = (2100, 3000)          # dropout q0 / k0 of the ragged checks: global positions past 2048
TOL = 6e-3                      # chip_smoke.py BWD_TOL["bfloat16"]: max |d| <= TOL max |ref|
CHECK_MAX_N = 4096              # the plain version holds (B, H, N, N) float32 scores
SPLIT = {"dkdv": "bwd_dkdv", "dq": "bwd_dq", "delta": "delta_kernel"}


def sass_report(name: str, lib_path: str) -> None:
    """HGMMA (warpgroup tensor-core) and atomic (ATOM, RED) instructions of
    each backward wgmma kernel in a built library's SASS."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True).stdout
    counts, entry = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            entry = wgmma_entry(ln)
            if entry:
                counts[entry] = [0, 0]
        elif entry:
            counts[entry][0] += "HGMMA" in ln
            counts[entry][1] += bool(re.search(r"\b(ATOMS?|ATOMG|RED)\b", ln))
    for entry, (hgmma, atomics) in counts.items():
        print(f"{name}: {entry}: SASS {hgmma} HGMMA, {atomics} atomic instructions", flush=True)


def operands(shape, seed: int):
    """Strided q, k, v views of one (B, N, 3, H, Dh) bf16 tensor, dO and
    dlse, from numpy draws."""
    b, n, h, dh = shape
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3, h, dh)).astype(np.float32)).to("cuda", torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", torch.bfloat16)
    dlse = torch.from_numpy(rng.standard_normal((b, h, n)).astype(np.float32)).cuda(0)
    return (*qkv.unbind(2), do, dlse)


def check(libs, shape, drop) -> str:
    """Every library's wgmma kernels and the tree's general kernels against
    the plain version. A variant that misses is dropped from `libs`; the
    tree missing raises SystemExit."""
    q, k, v, do, dlse = operands(shape, 1)
    scale = shape[-1] ** -0.5
    o, lse = flash_attn_fwd_cuda(q, k, v, scale, drop)
    want = attention_bwd_with_lse(q, k, v, o, lse, do, dlse, scale, drop)
    refs = [w.float().abs().max().item() for w in want]
    worst = {}
    for side, lib in list(libs.items()):
        for kern in ("wgmma", "general") if side == "tree" else ("wgmma",):
            _build._libs[BWD_KERNEL] = lib
            got = flash_attn_bwd_cuda(q, k, v, o, lse, do, dlse, scale, drop, kernel=kern)
            again = flash_attn_bwd_cuda(q, k, v, o, lse, do, dlse, scale, drop, kernel=kern)
            torch.cuda.synchronize()
            errs = [(a.float() - w.float()).abs().max().item() / max(r, 1e-30) for a, w, r in zip(got, want, refs)]
            repeat = all(torch.equal(a, a2) for a, a2 in zip(got, again))
            finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
            if not (finite and repeat and all(e <= TOL for e in errs)):
                msg = (f"{side} {kern} disagrees with the plain version at {shape} drop {drop}: dq/dk/dv "
                       f"max|d|/max|ref| {errs}, repeat {repeat}, finite {finite}")
                if side == "tree":
                    raise SystemExit(f"attn_bwd_ab: {msg}")
                print(f"attn_bwd_ab: {msg}; dropped", flush=True)
                del libs[side]
                continue
            worst[f"{side} {kern}"] = max(errs)
    _build._libs[BWD_KERNEL] = libs["tree"]
    return ", ".join(f"{side} {e:.2e}" for side, e in worst.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help="variants of vitax_torch/csrc/flash_attn_bwd.cu")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attn_bwd_ab: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    _build.build_all()                      # every source at once (the forward gives o and lse)
    libs = {"tree": _build.load(BWD_KERNEL)}
    wgmma_report("tree", _build._build_log[BWD_KERNEL]["ptxas"])
    sass_report("tree", _build._build_log[BWD_KERNEL]["path"])
    names = [os.path.basename(p) for p in args.variants]
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:       # one nvcc a variant, all at once
        built = pool.map(lambda i: _build.load_variant(args.variants[i], f"flash_attn_bwd_variant{i}"),
                         range(len(names)))
        for i, (name, lib) in enumerate(zip(names, built)):
            libs[name] = lib
            wgmma_report(name, lib.ptxas)
            sass_report(name, os.path.join(_build.BUILD_DIR, f"libflash_attn_bwd_variant{i}.so"))
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        for shape in CHECK_SHAPES + tuple(s for s in MAIN_SHAPES if s[1] <= CHECK_MAX_N):
            for drop in (None, Dropout(2024, 0.1, *(OFFSETS if shape not in MAIN_SHAPES else (0, 0)))):
                print(f"check {shape} rate {0.0 if drop is None else drop.rate}: max|d|/max|ref| "
                      f"{check(libs, shape, drop)} (<= {TOL}), bitwise repeats", flush=True)
        names = [name for name in names if name in libs]
        order = ["general", *names, "tree", "tree", *names[::-1], "general"]
        for shape in MAIN_SHAPES:
            q, k, v, do, _ = operands(shape, 2)
            scale = shape[-1] ** -0.5
            for rate in (0.0, 0.1):
                drop = Dropout(2024, rate) if rate else None
                o, lse = flash_attn_fwd_cuda(q, k, v, scale, drop)
                best = {}
                for side in order:
                    _build._libs[BWD_KERNEL] = libs["tree" if side == "general" else side]
                    kern = "general" if side == "general" else "wgmma"
                    t = time_ms(lambda: flash_attn_bwd_cuda(q, k, v, o, lse, do, None, scale, drop, kernel=kern),
                                args.iters)
                    best[side] = min(best.get(side, t), t)
                _build._libs[BWD_KERNEL] = libs["tree"]
                split = profiled_ms(lambda: flash_attn_bwd_cuda(q, k, v, o, lse, do, None, scale, drop), SPLIT, 3)
                print(f"time {shape} rate {rate}: " + ", ".join(f"{side} {best[side]:.4f}"
                                                               for side in ["general", "tree", *names])
                      + " ms a call; the tree's dK/dV " + f"{split['dkdv']:.4f}, dQ {split['dq']:.4f}, delta "
                      f"{split['delta']:.4f} ms [{card}]", flush=True)
                del o, lse
            del q, k, v, do
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
