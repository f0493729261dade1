"""Kernel C against a variant of its source, on one card, in turns.

    python -m vitax_torch.tools.dequant_ab VARIANT.cu [--m 2048 256] [--iters 20]

Builds vitax_torch/csrc/dequant_matmul.cu (the tree's) and VARIANT.cu (a
copy of it with one change, same C entry point) with the same nvcc flags.
At each block site of the 10B serve model (qkv, proj, fc1, fc2; M rows of
x) and for each mode (weight-only int8 and fp8 with bf16 x, act int8 x
int8) it holds both against the plain version (weight-only within
chip_smoke.py's bar, act bitwise), then times them with CUDA events in
turns (variant, tree, tree, variant), each on the kernel `choose_kernel`
gives the shape, and keeps the better of each side's two readings. Prints
a line a site, then each mode's sum over the 128 block-site launches of a
forward, with the card's name and power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from vitax_torch.ops import _build
from vitax_torch.ops.dequant_matmul import KERNEL, _matmul_plain, dequant_matmul_cuda, quantize_activations

SITES = (("qkv", 5120, 15360), ("proj", 5120, 5120), ("fc1", 5120, 20480), ("fc2", 20480, 5120))
LAUNCHES_PER_SITE = 32
WEIGHT_ONLY_TOL = 6e-5          # chip_smoke.py DEQUANT_TOL["bfloat16"], of max |ref|


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


def operands(m: int, k: int, f: int, dtype: str, seed: int):
    from vitax_torch.checkpoint.consolidate import quantize_tensor
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device="cuda")
    w = torch.randn(f, k, generator=gen, device="cuda") * 0.02
    q, s = quantize_tensor(w, (1,), dtype)
    return x.to(torch.bfloat16), q, s.reshape(-1).contiguous()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variant", help="a variant of vitax_torch/csrc/dequant_matmul.cu")
    ap.add_argument("--m", type=int, nargs="+", default=[2048, 256], help="rows of x (bucket 8: 2048, 1: 256)")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dequant_ab: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    libs = {"tree": _build.load(KERNEL), "variant": _build.load_variant(args.variant, "dequant_matmul_variant")}
    sums = {}
    with torch.inference_mode():
        for m in args.m:
            for i, (site, k, f) in enumerate(SITES):
                xb, q, s = operands(m, k, f, "int8", i)
                _, q8, s8 = operands(m, k, f, "float8_e4m3", i)
                xq, sx = quantize_activations(xb)
                cases = {"wo": ((xb, q, s, None), _matmul_plain(xb, q, s, None)),
                         "fp8": ((xb, q8, s8, None), _matmul_plain(xb, q8, s8, None)),
                         "act": ((xq, q, s, sx), _matmul_plain(xq, q, s, sx))}
                parts = []
                for mode, (ops, want) in cases.items():
                    best = {}
                    for side in ("variant", "tree", "tree", "variant"):
                        _build._libs[KERNEL] = libs[side]
                        got = dequant_matmul_cuda(*ops)
                        torch.cuda.synchronize()
                        d = (got - want).abs().max().item() / want.abs().max().item()
                        if (d != 0.0 if mode == "act" else not d <= WEIGHT_ONLY_TOL):
                            raise SystemExit(f"dequant_ab: {side} disagrees with the plain version at {site} M {m} "
                                             f"{mode}: {d:.3e} of max |ref|")
                        v = time_ms(lambda: dequant_matmul_cuda(*ops), args.iters)
                        best[side] = min(best.get(side, v), v)
                    for side, v in best.items():
                        sums[(m, mode, side)] = sums.get((m, mode, side), 0.0) + LAUNCHES_PER_SITE * v
                    parts.append(f"{mode} variant {best['variant']:.4f} / tree {best['tree']:.4f} ms")
                print(f"M {m} {site} {m}x{k}x{f}: " + "; ".join(parts) + f" [{card}]", flush=True)
            print(f"M {m}, the 128 block-site launches of a forward: "
                  + "; ".join(f"{mode} variant {sums[(m, mode, 'variant')]:.3f} / tree {sums[(m, mode, 'tree')]:.3f} ms"
                              for mode in ("wo", "fp8", "act")) + f" [{card}]", flush=True)
    _build._libs[KERNEL] = libs["tree"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
