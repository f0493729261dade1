"""AST lint for vitax_torch/ source: host-sync and portability bug patterns.

The port's copy of vitax/analysis/ast_lint.py. The program rules in
:mod:`vitax_torch.analysis.rules` catch invariant violations in a run of
the eager step; this pass catches the Python idioms that put them there:
an `.item()` inside a block's forward, a `float()` on a tensor in the
step, an argless `.cuda()` that pins library code to whatever device is
current.

Finding codes (Error Prone style: stable ids, CI-greppable). VTX100 and
VTX105-VTX109 keep vitax's meaning and messages, with the port's paths;
VTX101-VTX104 were JAX idioms (device_get and block_until_ready under jit,
concretization of tracers, argless jax.devices()) and carry their torch
meaning here:

  VTX100  ERROR  bare `# vtx: ignore[...]` suppression with no reason text
  VTX101  ERROR  a host sync inside the step-path modules (models/, ops/,
                 parallel/, train/step.py): `.item()`, `.tolist()`,
                 `.cpu()`, `torch.cuda.synchronize()` or an Event's or
                 stream's `.synchronize()` — the host waits for the card
                 in the middle of the step and the launch queue drains
  VTX102  ERROR  `float()` / `int()` on a torch expression in those
                 modules — the same sync, hidden in a conversion
  VTX103  WARN   two+ time.time()/perf_counter() calls bracketing a
                 dispatch-like call with no fence (torch.cuda.synchronize,
                 Event.synchronize / .elapsed_time, .item(), .cpu(),
                 .tolist(), a future's .result()) in the same function —
                 CUDA launches are asynchronous, so this times submission,
                 not execution
  VTX104  ERROR  a device chosen implicitly in library code: an argless
                 `.cuda()` or `torch.device("cuda")` with no index outside
                 vitax_torch/platform.py resolve_device — the current
                 device decides, where the port's entry points take an
                 explicit device
  VTX105  ERROR  mutable default argument (list/dict/set literal or call)
  VTX106  ERROR  broad `except:` / `except Exception:` / `except
                 BaseException:` whose body only passes — swallows every
                 error silently; in a fault-tolerant trainer a swallowed
                 exception becomes an undiagnosable hang or wrong result
                 (narrow excepts like OSError are fine; so is a broad
                 except that logs, re-raises, or otherwise acts)
  VTX107  ERROR  direct `preempt.requested()` / `.escalation_requested()`
                 poll outside the control plane — a host acting on its LOCAL
                 failure flag desynchronizes the group (one rank saves while
                 the others keep stepping -> interleaved collectives ->
                 deadlock); read the AGREED word via
                 vitax_torch/train/control.py ControlPlane.poll instead.
                 The control plane's own two polls are the sanctioned
                 (suppressed) call sites.
  VTX109  ERROR  urllib.request.urlopen / http.client.HTTPConnection /
                 socket.create_connection without an explicit timeout —
                 the stdlib default is block-forever, so one hung peer
                 wedges the calling thread (a health poll, a dispatch, a
                 bench worker) permanently; every network call in the
                 serving/tooling paths must bound its wait
  VTX108  ERROR  `save_state(..., wait=True)` inside a loop body — a
                 synchronous checkpoint write from the step-dispatch region
                 stalls the train loop for the full serialization+write
                 (the exact stall the zero-stall snapshot pipeline exists
                 to remove, vitax_torch/checkpoint/snapshot.py); route the
                 save through SnapshotPipeline.submit, or hoist it out of
                 the loop (the final boundary save may wait — it is not
                 inside one)

No vitax code is left out: each JAX idiom has the torch idiom above as its
counterpart.

Suppression: append `# vtx: ignore[VTX101] <reason>` to the offending line.
Multiple codes: `# vtx: ignore[VTX101,VTX103] <reason>`. A suppression
without a reason is itself an error (VTX100).

Run: `python -m vitax_torch.analysis.ast_lint [paths...] [--json]`
(default path: the vitax_torch/ package directory). Exit 1 on any ERROR
finding.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
import sys
from typing import Iterable, List, Optional, Sequence, Tuple

# The step-path modules: their function bodies run inside the train step or
# the serve forward, where a host sync drains the launch queue.
TRACED_SUBPATHS = (
    os.path.join("vitax_torch", "models") + os.sep,
    os.path.join("vitax_torch", "ops") + os.sep,
    os.path.join("vitax_torch", "parallel") + os.sep,
    os.path.join("vitax_torch", "train", "step.py"),
)
# VTX101: calls that make the host wait for the card
_SYNC_CALLS = ("item", "tolist", "cpu", "synchronize")
# VTX104: the one function that may turn "no device given" into "cuda"
_DEVICE_RESOLVER = (os.path.join("vitax_torch", "platform.py"), "resolve_device")

_SUPPRESS_RE = re.compile(r"#\s*vtx:\s*ignore\[([A-Za-z0-9,\s]*)\]\s*(.*)")
_TIMER_CALLS = {"time", "perf_counter", "monotonic"}
_DISPATCH_NAME_RE = re.compile(
    r"(step|predict|compiled|jitted|forward|apply|_run)", re.IGNORECASE)

# VTX109: blocking network constructors/calls -> the 0-based positional
# index where the stdlib signature accepts `timeout` (a call with more
# positionals than that index passed it positionally)
_NET_TIMEOUT_POS = {
    "urlopen": 2,            # urlopen(url, data=None, timeout=...)
    "create_connection": 1,  # socket.create_connection(addr, timeout=...)
    "HTTPConnection": 2,     # HTTPConnection(host, port=..., timeout=...)
    "HTTPSConnection": 2,
}


@dataclasses.dataclass
class Finding:
    code: str
    severity: str  # "ERROR" | "WARN"
    path: str
    line: int
    message: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.code} [{self.severity}] {self.message}"


def _suppressions(source: str) -> Tuple[dict, List[Finding]]:
    """Map line -> set of suppressed codes; bare suppressions are findings."""
    by_line: dict = {}
    bare: List[Finding] = []
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
        reason = m.group(2).strip()
        if not reason or not codes:
            bare.append(Finding(
                "VTX100", "ERROR", "", lineno,
                "bare `# vtx: ignore[...]` — suppressions must carry a reason"))
        else:
            by_line[lineno] = codes
    return by_line, bare


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target ('' if not a plain chain)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_torch_expr(node: ast.AST) -> bool:
    """Heuristic: does this expression syntactically involve torch (or its
    functional namespace F)?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in ("torch", "F"):
            return True
    return False


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, traced: bool) -> None:
        self.path = path
        self.traced = traced
        self.findings: List[Finding] = []
        # (lineno, kind) events per function for the VTX103 timing check
        self._func_stack: List[List[Tuple[int, str]]] = []
        self._func_names: List[str] = []
        # loop-nesting depth for the VTX108 in-loop synchronous-save check
        self._loop_depth = 0

    def _add(self, code: str, severity: str, node: ast.AST, msg: str) -> None:
        self.findings.append(
            Finding(code, severity, self.path, node.lineno, msg))

    # -- function-scope bookkeeping -----------------------------------------
    def _visit_func(self, node) -> None:
        for default in list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]:
            if isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                    isinstance(default, ast.Call)
                    and _dotted(default.func) in ("list", "dict", "set")):
                self._add("VTX105", "ERROR", default,
                          f"mutable default argument in `{node.name}()`")
        self._func_stack.append([])
        self._func_names.append(node.name)
        self.generic_visit(node)
        self._func_names.pop()
        events = self._func_stack.pop()
        self._check_timing(node, events)

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def _visit_loop(self, node) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = _visit_loop
    visit_AsyncFor = _visit_loop
    visit_While = _visit_loop

    def _check_timing(self, func, events: List[Tuple[int, str]]) -> None:
        timers = [ln for ln, kind in events if kind == "timer"]
        dispatches = [ln for ln, kind in events if kind == "dispatch"]
        fences = [ln for ln, kind in events if kind == "fence"]
        if len(timers) < 2 or not dispatches:
            return
        for d in dispatches:
            before = [t for t in timers if t <= d]
            after = [t for t in timers if t > d]
            if before and after:
                span = (before[-1], after[0])
                if not any(span[0] <= f <= span[1] for f in fences):
                    self._add(
                        "VTX103", "WARN", func,
                        f"`{func.name}()` wraps a dispatch-like call (line {d}) "
                        "in timers with no fence — async dispatch means this "
                        "times submission, not execution")
                    return  # one finding per function is enough

    # -- exception-handler checks -------------------------------------------
    @staticmethod
    def _is_broad_exc(node: Optional[ast.AST]) -> bool:
        """Does this except clause catch everything (bare / Exception /
        BaseException, possibly inside a tuple)?"""
        if node is None:  # bare `except:`
            return True
        if isinstance(node, ast.Tuple):
            return any(_Visitor._is_broad_exc(e) for e in node.elts)
        return (_dotted(node) or "").split(".")[-1] in (
            "Exception", "BaseException")

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        def _noop(stmt: ast.stmt) -> bool:
            # pass, `...`, or a bare string (comment-as-docstring)
            return isinstance(stmt, ast.Pass) or (
                isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Constant)
                and (stmt.value.value is Ellipsis
                     or isinstance(stmt.value.value, str)))

        body_is_noop = all(_noop(stmt) for stmt in node.body)
        if body_is_noop and self._is_broad_exc(node.type):
            caught = _dotted(node.type) if node.type is not None else ""
            label = f"except {caught}" if caught else "bare except"
            self._add("VTX106", "ERROR", node,
                      f"`{label}` with a pass-only body swallows every error "
                      "silently — catch a narrow type, or log/act on it")
        self.generic_visit(node)

    # -- per-call checks ----------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        # `short` must survive chained calls (`jnp.sum(x).block_until_ready()`)
        # where the dotted chain doesn't resolve to a plain name
        if isinstance(node.func, ast.Attribute):
            short = node.func.attr
        elif isinstance(node.func, ast.Name):
            short = node.func.id
        else:
            short = ""

        if self._func_stack:
            events = self._func_stack[-1]
            if name.startswith("time.") and short in _TIMER_CALLS:
                events.append((node.lineno, "timer"))
            elif short in ("synchronize", "elapsed_time", "item", "cpu",
                           "tolist", "result"):
                events.append((node.lineno, "fence"))
            elif _DISPATCH_NAME_RE.search(short or ""):
                events.append((node.lineno, "dispatch"))

        if (name in ("preempt.requested", "vitax_torch.train.preempt.requested")
                or (short == "escalation_requested"
                    and isinstance(node.func, ast.Attribute))):
            self._add("VTX107", "ERROR", node,
                      f"direct `{name or short}()` failure-signal poll — a "
                      "host acting on its local flag desynchronizes the pod; "
                      "read the agreed word via vitax_torch/train/control.py "
                      "ControlPlane.poll instead")

        if short == "save_state" and self._loop_depth > 0 and any(
                kw.arg == "wait" and isinstance(kw.value, ast.Constant)
                and kw.value.value is True for kw in node.keywords):
            self._add("VTX108", "ERROR", node,
                      "`save_state(..., wait=True)` inside a loop body — a "
                      "synchronous checkpoint write stalls the step-dispatch "
                      "region; route it through SnapshotPipeline.submit "
                      "(vitax_torch/checkpoint/snapshot.py) or hoist it out of "
                      "the loop")

        if short in _NET_TIMEOUT_POS:
            has_timeout = (
                any(kw.arg == "timeout" or kw.arg is None  # **kwargs: assume ok
                    for kw in node.keywords)
                or len(node.args) > _NET_TIMEOUT_POS[short])
            if not has_timeout:
                self._add("VTX109", "ERROR", node,
                          f"`{name or short}()` without an explicit timeout "
                          "— the stdlib default blocks forever, so one hung "
                          "peer wedges this thread; pass timeout=")

        if self._implicit_device(node, name, short):
            self._add("VTX104", "ERROR", node,
                      f"`{name or short}(...)` picks the current CUDA device "
                      "implicitly in library code — take an explicit device "
                      "(vitax_torch/platform.py resolve_device) or pass an index")

        if self.traced:
            if short in _SYNC_CALLS and isinstance(node.func, ast.Attribute):
                self._add("VTX101", "ERROR", node,
                          f"`{name or '.' + short}()` in a step-path module — "
                          "a host sync inside the step drains the launch queue")
            elif short in ("float", "int") and name in ("float", "int") \
                    and node.args and _is_torch_expr(node.args[0]):
                self._add("VTX102", "ERROR", node,
                          f"`{short}()` on a torch expression in a step-path "
                          "module — reads the value back to the host (a sync)")
        self.generic_visit(node)


    def _implicit_device(self, node: ast.Call, name: str, short: str) -> bool:
        """VTX104: an argless `.cuda()`, or `torch.device("cuda")` with no
        index, outside the port's device resolver."""
        if self.path.endswith(_DEVICE_RESOLVER[0]) and _DEVICE_RESOLVER[1] in self._func_names:
            return False
        if short == "cuda" and isinstance(node.func, ast.Attribute) \
                and not node.args and not node.keywords:
            return True
        return (name == "torch.device" and len(node.args) == 1 and not node.keywords
                and isinstance(node.args[0], ast.Constant) and node.args[0].value == "cuda")


def lint_source(source: str, path: str) -> List[Finding]:
    """Lint one file's source text; returns surviving findings."""
    traced = any(sub in path for sub in TRACED_SUBPATHS)
    suppressed, bare = _suppressions(source)
    for f in bare:
        f.path = path
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("VTX100", "ERROR", path, e.lineno or 1,
                        f"syntax error: {e.msg}")]
    visitor = _Visitor(path, traced)
    visitor.visit(tree)
    out = list(bare)
    for f in visitor.findings:
        if f.code in suppressed.get(f.line, ()):
            continue
        out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.code))
    return out


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    findings: List[Finding] = []
    for path in paths:
        if os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        findings.extend(_lint_file(os.path.join(dirpath, fn)))
        else:
            findings.extend(_lint_file(path))
    return findings


def _lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m vitax_torch.analysis.ast_lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("paths", nargs="*",
                        help="files or directories (default: the vitax_torch/ package)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit findings as a JSON array")
    args = parser.parse_args(argv)

    paths = args.paths or [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    findings = lint_paths(paths)
    if args.as_json:
        print(json.dumps([f.to_json() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.format())
        if not findings:
            print("ast_lint: clean")
    return 1 if any(f.severity == "ERROR" for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
