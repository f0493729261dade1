"""The invariant gate: run the program rules over vitax's arms on the port.

The counterpart of tools/check_invariants.py. Builds each arm's program
through the port's Config (analysis/rules.py BASE_GEOMETRY and arm
overrides, vitax's), takes its evidence (one recorded step, or a warmed
engine), runs every applicable rule, then the VTX200-series thread lint over
vitax_torch/ (and chip_smoke.py beside it). The fsdp arms (all train arms
but dp) run in ONE gloo group of two ranks started once for all of them,
each rank stepping its half of the batch; the dp arm and the serve arms run
in this process. On the card both ranks share it over gloo (one card takes
no two NCCL ranks).

Usage:
    python -m vitax_torch.analysis.check                      # every arm, on the card
    python -m vitax_torch.analysis.check --device cpu --arms zero3_overlap serve
    python -m vitax_torch.analysis.check --device cpu --json  # machine-readable
    python -m vitax_torch.analysis.check --device cpu --arms dp --seeded_violation host_sync   # exits 1

JSON contract (schema 1, vitax's):
    {"schema": 1,
     "arms": {"<arm>": {"ok": bool, "rules_ran": [rule ids],
                        "findings": [{rule, severity, arm, message, details}]}},
     "findings": [...all findings...],
     "errors": {"<arm>": "<traceback tail>"},   # arms that failed to build
     "concurrency": {"ok": bool,                # VTX200-series thread lint
                     "findings": [{code, severity, path, line, message}]},
     "ok": bool}

Exit status: 0 when every requested arm built and produced no ERROR-severity
finding and the thread lint is clean; 1 otherwise. WARN findings are
reported but do not fail the gate. `--seeded_violation host_sync` wraps
every train step so it reads its loss back (`.item()`): VTX-R001 must
catch it, and the gate fails.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 300
VIOLATIONS = ("host_sync",)


def _host_sync(step: Callable) -> Callable:
    """A step that reads its loss back to the host: the seeded VTX-R001
    violation."""
    def step_with_item(state, batch, *args, **kwargs):
        state, metrics = step(state, batch, *args, **kwargs)
        metrics["loss"].item()
        return state, metrics
    return step_with_item


def _wrap(violation: str) -> Optional[Callable]:
    return _host_sync if violation == "host_sync" else None


def _arm_result(arm: str, device: str, mesh=None, violation: str = "") -> dict:
    """{"ok", "rules_ran", "findings"} of one arm, or {"error": tail}."""
    from vitax_torch.analysis import rules as R
    try:
        program = R.build_program(arm, device=device, mesh=mesh, wrap_step=_wrap(violation))
        ran, findings = R.run_rules(program)
    except Exception:  # vtx: ignore[VTX106] the traceback's tail becomes the arm's error in the report
        tb = traceback.format_exc().strip().splitlines()
        return {"error": "\n".join(tb[-3:])}
    return {"ok": not any(f.severity == "ERROR" for f in findings), "rules_ran": ran,
            "findings": [f.to_json() for f in findings]}


def _rank_main(rank: int, root: str, arms: Sequence[str], device: str, violation: str) -> None:
    """One rank of the group: every sharded arm in order; rank 0 writes
    {arm: result} to root/results.json. An arm that fails on a rank ends
    that rank's loop (the other would wait in a collective)."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/store", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    from vitax_torch.analysis import rules as R
    from vitax_torch.parallel.mesh import build_mesh
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    results: Dict[str, dict] = {}
    try:
        with contextlib.redirect_stdout(sys.stderr):
            for arm in arms:
                mesh = build_mesh(R.arm_config(arm), dev)
                results[arm] = _arm_result(arm, device, mesh, violation)
                if "error" in results[arm]:
                    break
    finally:
        if rank == 0:
            with open(os.path.join(root, "results.json"), "w") as f:
                json.dump(results, f)
        dist.destroy_process_group()


def _run_group(arms: Sequence[str], device: str, violation: str) -> Dict[str, dict]:
    """The sharded arms in one spawned gloo group of two ranks."""
    import torch.multiprocessing as mp
    root = tempfile.mkdtemp(prefix="vitax_torch_check_")
    err = ""
    try:
        mp.spawn(_rank_main, args=(root, list(arms), device, violation), nprocs=2, join=True)
    except Exception as e:  # vtx: ignore[VTX106] a rank that died marks its arms as errors below
        err = f"{type(e).__name__}: {str(e).strip().splitlines()[-1] if str(e).strip() else ''}"
    path = os.path.join(root, "results.json")
    results = {}
    if os.path.exists(path):
        with open(path) as f:
            results = json.load(f)
    shutil.rmtree(root, ignore_errors=True)
    for arm in arms:
        results.setdefault(arm, {"error": err or "the rank group ended before this arm"})
    return results


def run(  # vtx: ignore[VTX103] each train arm's evidence is taken on a synchronized card (rules.train_program)
        arms: Sequence[str], as_json: bool, device: str = "cuda", violation: str = "") -> dict:
    from vitax_torch.analysis import rules as R

    report = {"schema": 1, "arms": {}, "findings": [], "errors": {}, "ok": True}
    results: Dict[str, dict] = {}
    t0 = time.time()
    guard = contextlib.redirect_stdout(sys.stderr) if as_json else contextlib.nullcontext()
    with guard:         # library chatter (serve warmup timings) must not precede the JSON document
        for arm in arms:
            if arm not in R.SHARDED_ARMS:
                results[arm] = _arm_result(arm, device, None, violation)
        sharded = [a for a in arms if a in R.SHARDED_ARMS]
        if sharded:
            results.update(_run_group(sharded, device, violation))
    for arm in arms:
        res = results[arm]
        if "error" in res:
            report["errors"][arm] = res["error"]
            report["ok"] = False
            if not as_json:
                print(f"[{arm}] BUILD FAILED:\n{res['error']}", file=sys.stderr)
            continue
        report["arms"][arm] = res
        report["findings"].extend(res["findings"])
        report["ok"] = report["ok"] and res["ok"]
        if not as_json:
            print(f"[{arm}] {'ok' if res['ok'] else 'FAIL'} — rules: "
                  f"{', '.join(res['rules_ran']) if res['rules_ran'] else 'none applicable'}")
            for f in res["findings"]:
                print(f"    {f['rule']} [{f['severity']}] {f['message']}")
    if not as_json:
        print(f"arms: {time.time() - t0:.1f}s on {device}")

    # the host program's thread discipline (analysis/concurrency.py): the
    # same gate, another program
    from vitax_torch.analysis import concurrency as C
    paths = [PKG_DIR]
    smoke = os.path.join(os.path.dirname(PKG_DIR), "chip_smoke.py")
    if os.path.exists(smoke):
        paths.append(smoke)
    cfinds = C.lint_paths(paths)
    conc_ok = not cfinds
    report["concurrency"] = {"ok": conc_ok, "findings": [f.to_json() for f in cfinds]}
    report["ok"] = report["ok"] and conc_ok
    if not as_json:
        print(f"[concurrency] {'ok' if conc_ok else 'FAIL'} — VTX200-series over vitax_torch/ and chip_smoke.py")
        for f in cfinds:
            print(f"    {f.format()}")
    return report


def main(argv: Optional[List[str]] = None) -> int:
    from vitax_torch.analysis import rules as R

    parser = argparse.ArgumentParser(
        prog="python -m vitax_torch.analysis.check", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--arms", nargs="+", choices=list(R.ALL_ARMS), default=list(R.ALL_ARMS),
                        help="arms to verify (default: all)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit the JSON contract on stdout")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the arms run (default: the card)")
    parser.add_argument("--seeded_violation", default="", choices=("",) + VIOLATIONS,
                        help="host_sync: every train step reads its loss back (VTX-R001 must fail the gate)")
    args = parser.parse_args(argv)
    if args.device == "cuda":
        from vitax_torch.platform import resolve_device
        resolve_device("cuda")          # raises with the reason on a host with no card

    report = run(args.arms, args.as_json, args.device, args.seeded_violation)
    if args.as_json:
        print(json.dumps(report, indent=2))
    elif report["ok"]:
        print("check: all arms clean")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
