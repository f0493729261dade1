"""The dropout hash's instructions an element in the attention kernels'
SASS, by the pipe each issues on: the counts behind the hash term of the
dropout bounds (chip_smoke.py `HASH_OPS_PER_ELEMENT`, the fewest of them).

Each wgmma kernel of csrc/flash_attn_fwd.cu and csrc/flash_attn_bwd.cu is
built twice, DROP false and true (the template flag); the hash and the
mask's use are the only code DROP adds. This tool builds both sources
(ops/_build.py), disassembles them (`cuobjdump -sass`; the instantiations
found by their mangled template arguments, `...kernelILi<DH>ELb<0|1>E`),
and for each kernel and head dim takes the opcode histogram of the DROP
instantiation minus the rate-0 one. An element's keep decision ends in
one compare with the threshold, so the extra ISETPs count the static
elements; the compiled hash multiplies by FMIX_C1 (0x85ebca6b, printed
signed as -0x7a143595) once an element too, a cross-check (fmix32's last
xor-shift by 16 and the next fmix32's first cancel, and the two
multiplies left side by side fold into one by C2 * C1). The difference
over the elements is the instructions an element, split by pipe as
Hopper issues them: IMAD and IMUL on the FMA pipe's heavy half, FADD,
FMUL and FFMA on either half, the other integer, logic and select
instructions (LOP3, SHF, IADD3, ISETP, LEA, FSEL, ...) on the ALU pipe.
The ALU pipe and the heavy half each take 64 lanes a clock an SM, the
FMA pipe 128, and an SM issues 128 lanes a clock (one warp instruction a
sub-partition): the hash's least time an element is the largest of the
ALU count over 64, the IMAD count over 64, the FMA count over 128 and
the total over 128 (`bound_ops`, in units of the 64-lane rate).

Run on the card (nvcc and cuobjdump; about a minute with the build):
    python -m vitax_torch.tools.hash_sass [--json]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
from typing import Dict, List

FMIX_C1 = 0x85EBCA6B
# SASS prints a 32-bit immediate either way: 0x85ebca6b, or signed, -0x7a143595
C1_FORMS = (f"{FMIX_C1:#x}", f"-{(1 << 32) - FMIX_C1:#x}")
KERNELS = {"flash_attn_fwd": ("flash_attn_fwd_wgmma_kernel",),
           "flash_attn_bwd": ("bwd_dkdv_wgmma_kernel", "bwd_dq_wgmma_kernel")}
FMA_INT = ("IMAD", "IMUL")                        # integer ops on the FMA pipe's heavy half
FLOAT = ("FADD", "FMUL", "FFMA", "HFMA2", "HADD2", "HMUL2")    # on either half of the FMA pipe
CONTROL = ("BRA", "BAR", "EXIT", "NOP", "YIELD", "WARPSYNC", "BSYNC", "BSSY", "RET", "CALL")
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*(.*?);")


def tool(name: str) -> str:
    """A CUDA toolkit binary: $PATH, then /usr/local/cuda/bin."""
    found = shutil.which(name) or os.path.join("/usr/local/cuda/bin", name)
    if not os.path.exists(found):
        raise RuntimeError(f"{name} not found (the CUDA toolkit's bin/): run this on the card's machine")
    return found


def functions(sass: str) -> Dict[str, List[tuple]]:
    """{mangled function name: [(opcode, modifiers, operands), ...]}."""
    out: Dict[str, List[tuple]] = {}
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            out[current] = []
            continue
        m = _INSTR.search(line)
        if m and current is not None:
            out[current].append((m.group(1), m.group(2), m.group(3)))
    return out


def pipe(opcode: str) -> str:
    if opcode in FMA_INT:
        return "fma_int"
    if opcode in FLOAT:
        return "fma_float"
    if opcode in CONTROL or opcode in ("MUFU", "F2F", "I2F", "F2I") or opcode.startswith((
            "LD", "ST", "S2", "CS2", "R2", "UTMA", "SYNCS", "WARPGROUP", "HGMMA",
                                               "UBLKCP", "MEMBAR", "ATOM", "RED", "SHFL", "ULD", "ULDC",
                                               "DEPBAR", "ELECT", "ACQ", "UCGA", "FENCE", "CCTL", "ERRBAR")):
        return "other"
    if opcode.startswith("U"):                      # uniform datapath: once a warp, not a lane's work
        return "uniform"
    return "alu"


def disassemble(path: str) -> Dict[str, List[tuple]]:
    return functions(subprocess.run([tool("cuobjdump"), "-sass", path], capture_output=True, text=True,
                                    check=True).stdout)


def per_element(drop: List[tuple], plain: List[tuple]) -> dict:
    """The DROP instantiation's extra instructions over the rate-0 one,
    over its static elements (the extra ISETPs), by opcode and pipe, and
    the pipe-bound count an element (`bound_ops`)."""
    uses = sum(1 for op, _, args in drop if any(re.search(re.escape(f) + r"\b", args.lower()) for f in C1_FORMS))
    diff = collections.Counter(op for op, _, _ in drop)
    diff.subtract(collections.Counter(op for op, _, _ in plain))
    by_op = {op: n for op, n in sorted(diff.items()) if n}
    elements = by_op.get("ISETP", 0)
    by_pipe = collections.Counter()
    for op, n in by_op.items():
        by_pipe[pipe(op)] += n
    per = {p: n / elements if elements else float("nan") for p, n in sorted(by_pipe.items())}
    alu, imad, fma = per.get("alu", 0.0), per.get("fma_int", 0.0), per.get("fma_float", 0.0)
    bound = max(alu, imad, (imad + fma) / 2, (alu + imad + fma) / 2)
    return {"elements": elements, "fmix_c1_uses": uses, "extra_by_opcode": by_op, "per_element": per,
            "bound_ops": bound, "instructions": {"drop": len(drop), "rate0": len(plain)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", action="store_true", help="print one JSON object")
    args = ap.parse_args(argv)
    from vitax_torch.ops import _build
    result, names_seen = {}, []
    for source, names in KERNELS.items():
        funcs = disassemble(_build._compile(source)["path"])
        names_seen += list(funcs)
        for name in names:
            for fn, body in funcs.items():
                m = re.search(re.escape(name) + r"ILi(\d+)ELb1E", fn)
                if not m:
                    continue
                rate0 = funcs.get(fn.replace(m.group(0), f"{name}ILi{m.group(1)}ELb0E"))
                if rate0 is not None:
                    result[f"{name}<{m.group(1)}>"] = per_element(body, rate0)
    if not result:
        print(f"no DROP / rate-0 pair of wgmma kernels found in the SASS; functions: {names_seen}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(result))
    else:
        for k, v in result.items():
            per = ", ".join(f"{p} {n:.2f}" for p, n in v["per_element"].items())
            print(f"{k}: {v['elements']} static elements (extra ISETPs; {v['fmix_c1_uses']} uses of FMIX_C1); "
                  f"instructions an element by pipe: {per}; bound {v['bound_ops']:.2f} ALU-rate instructions an "
                  f"element; DROP adds {v['extra_by_opcode']} ({v['instructions']['drop']} against "
                  f"{v['instructions']['rate0']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
