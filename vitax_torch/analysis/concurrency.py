"""Static thread-safety & lock-discipline lint for the port's threaded runtime.

The port's copy of vitax/analysis/concurrency.py: the same thread model and
VTX200-VTX203 and VTX205, with VTX204 given its torch meaning. The program
rules (:mod:`vitax_torch.analysis.rules`) and the AST lint
(:mod:`vitax_torch.analysis.ast_lint`, VTX100-109) guard the step; this
pass guards the *host* program. The port has as many modules that spawn
threads or share lock-guarded state as vitax (serve batcher, fleet health
loop, watchdog, loader producers, control plane, snapshot worker, peer
replicator, arbiter) — exactly the bug class tier-1 CPU tests rarely catch
and that surfaces as a hang across ranks.

Per class, the analyzer extracts a thread model: thread entry points
(`threading.Thread(target=...)` / `threading.Timer(...)` with bound
methods, nested defs, or lambdas; plus bound methods passed as `on_*`
callback kwargs), sync-primitive attributes (Lock/RLock/Condition/Event/
Queue), per-method attribute read/write sets with the locks lexically
held (`with self._lock:`), and same-class call edges. Reachability is
split into a *thread side* (closure over calls from entry points) and a
*caller side* (closure from public roots), with lock context propagated
through call sites, then the VTX200-series rules check the model:

  VTX200  ERROR  shared attribute written on one side (thread or caller)
                 and accessed on the other with no common guarding lock
  VTX201  ERROR  `Condition.wait()` not re-checked in a `while` loop —
                 spurious wakeups and missed-predicate races
  VTX202  ERROR  lock-acquisition-order cycle across methods (A held
                 while taking B, elsewhere B held while taking A)
  VTX203  ERROR  blocking call while holding a lock: argless `join()`,
                 `Queue.get/put` without timeout, `Event.wait()` without
                 timeout, `Condition.wait` with a *different* lock still
                 held, or an HTTP request
  VTX204  ERROR  device work reachable from a thread entry point: a
                 `torch.`-rooted call, or `.to(` / `.cuda(` / `.copy_(` on
                 a tensor — only sanctioned threads may touch the device
                 (the serve batcher's worker, the loader's pinned-copy
                 producer, the snapshot pipeline's side-stream copies:
                 suppress with a reason at those sites)
  VTX205  ERROR  leaked thread: started but never joined/cancelled and
                 no stop-event protocol ties it to a shutdown path

Known static limits (by design, stdlib-AST only): module-level globals
are not modeled for VTX200; callables pushed through queues or stored as
callback attributes are invisible to reachability; `.acquire()`/
`.release()` pairs outside `with` contribute lock-order edges but not
guard scopes. Suppress intentional sites with
`# vtx: ignore[VTX20x] <reason>` on the reported line (same machinery
and VTX100 bare-suppression policing as ast_lint, which runs first).

Run: `python -m vitax_torch.analysis.concurrency [paths...] [--json]`
(default path: the vitax_torch/ package directory). Exit 1 on any finding.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from vitax_torch.analysis.ast_lint import Finding, _dotted, _suppressions

_SYNC_KINDS = {
    "threading.Lock": "lock",
    "threading.RLock": "lock",
    "threading.Semaphore": "lock",
    "threading.BoundedSemaphore": "lock",
    "threading.Condition": "condition",
    "threading.Event": "event",
    "queue.Queue": "queue",
    "queue.SimpleQueue": "queue",
    "queue.LifoQueue": "queue",
    "queue.PriorityQueue": "queue",
}
_THREAD_CTORS = {"threading.Thread": "thread", "threading.Timer": "timer"}
# container-method calls on `self.X` that mutate X in place
_MUTATORS = {"append", "extend", "insert", "pop", "popleft", "appendleft",
             "remove", "clear", "add", "discard", "update", "setdefault",
             "sort", "reverse"}
# VTX204: a call rooted at torch (torch.*, torch.cuda.*, F.*), or one of
# these tensor methods, moves or computes on the device
_TORCH_ROOTS = ("torch", "F")
_DEVICE_METHODS = ("to", "cuda", "copy_")
_MAX_CONTEXTS = 8  # lock-context fan-out cap per method (keeps fixpoint tiny)


@dataclasses.dataclass
class _Func:
    """Everything the rules need to know about one function body."""
    name: str
    line: int
    # (attr, is_write, line, guards) for `self.X` touches
    accesses: List[Tuple[str, bool, int, frozenset]] = dataclasses.field(default_factory=list)
    # (callee_method, line, guards) for `self.m(...)` calls
    calls: List[Tuple[str, int, frozenset]] = dataclasses.field(default_factory=list)
    # (pseudo_func, line, guards): nested def/lambda inlined into this side
    # unless it turns out to be a thread entry point
    maybe_calls: List[Tuple[str, int, frozenset]] = dataclasses.field(default_factory=list)
    # (lock_token, line, guards_already_held) for `with`/`.acquire()`
    acquires: List[Tuple[str, int, frozenset]] = dataclasses.field(default_factory=list)
    # (cond_token, line, has_timeout, in_while, guards)
    cond_waits: List[Tuple[str, int, bool, bool, frozenset]] = dataclasses.field(default_factory=list)
    # (kind, desc, line, guards) — kind in join/queue/event_wait/cond_wait/http
    blockers: List[Tuple[str, str, int, frozenset]] = dataclasses.field(default_factory=list)
    device_calls: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    events_set: Set[str] = dataclasses.field(default_factory=set)
    refs: Set[str] = dataclasses.field(default_factory=set)
    # local-thread bookkeeping for the function-scope VTX205 check
    local_threads: List[Tuple[int, Optional[str]]] = dataclasses.field(default_factory=list)
    started_names: Set[str] = dataclasses.field(default_factory=set)
    anon_starts: List[int] = dataclasses.field(default_factory=list)
    escapes: Set[str] = dataclasses.field(default_factory=set)
    has_any_start: bool = False
    has_mgmt_join: bool = False


@dataclasses.dataclass
class _Scope:
    """Thread model for one class (or the module pseudo-scope)."""
    name: str
    line: int
    module_scope: bool = False
    sync: Dict[str, str] = dataclasses.field(default_factory=dict)  # token -> kind
    method_names: Set[str] = dataclasses.field(default_factory=set)
    funcs: Dict[str, _Func] = dataclasses.field(default_factory=dict)
    entries: Set[str] = dataclasses.field(default_factory=set)
    thread_attrs: Dict[str, dict] = dataclasses.field(default_factory=dict)


def _thread_target(call: ast.Call) -> Optional[ast.AST]:
    """The `target=`/`function=` expression of a Thread/Timer constructor."""
    dot = _dotted(call.func)
    kw_name = "target" if dot == "threading.Thread" else "function"
    for kw in call.keywords:
        if kw.arg == kw_name:
            return kw.value
    if len(call.args) >= 2:
        return call.args[1]
    return None


def _self_attr(node: ast.AST, selfname: Optional[str]) -> Optional[str]:
    if (selfname and isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == selfname):
        return node.attr
    return None


class _FuncCollector(ast.NodeVisitor):
    """Collects one _Func; recurses into nested defs as pseudo-methods."""

    def __init__(self, scope: _Scope, func: _Func, selfname: Optional[str],
                 local_syncs: Optional[Dict[str, str]] = None,
                 local_funcs: Optional[Dict[str, str]] = None) -> None:
        self.scope = scope
        self.func = func
        self.selfname = selfname
        self.guards: List[str] = []
        self.while_depth = 0
        self.local_syncs: Dict[str, str] = dict(local_syncs or {})
        self.local_funcs: Dict[str, str] = dict(local_funcs or {})
        self.local_thread_names: Set[str] = set()
        self._bound: Set[int] = set()    # Thread ctor Call ids bound by Assign
        self._claimed: Set[int] = set()  # lambda ids turned into entry pseudos

    # -- helpers ------------------------------------------------------------
    def _sync_ref(self, node: ast.AST) -> Tuple[Optional[str], Optional[str]]:
        attr = _self_attr(node, self.selfname)
        if attr is not None:
            tok = "self." + attr
            return (tok, self.scope.sync.get(tok))
        if isinstance(node, ast.Name) and node.id in self.local_syncs:
            return (node.id, self.local_syncs[node.id])
        return (None, None)

    def _resolve_entry(self, ctor: ast.Call) -> Optional[str]:
        """Register (and return) the entry-point key of a thread ctor."""
        target = _thread_target(ctor)
        if target is None:
            return None
        attr = _self_attr(target, self.selfname)
        if attr is not None and attr in self.scope.method_names:
            self.scope.entries.add(attr)
            return attr
        if isinstance(target, ast.Name) and target.id in self.local_funcs:
            key = self.local_funcs[target.id]
            self.scope.entries.add(key)
            return key
        if isinstance(target, ast.Lambda):
            key = f"{self.func.name}.<lambda:{target.lineno}>"
            self._collect_nested(key, target.lineno, [target.body])
            self.scope.entries.add(key)
            self._claimed.add(id(target))
            return key
        return None

    def _collect_nested(self, key: str, line: int, body: List[ast.AST]) -> _Func:
        sub = _Func(name=key, line=line)
        self.scope.funcs[key] = sub
        col = _FuncCollector(self.scope, sub, self.selfname,
                             self.local_syncs, self.local_funcs)
        for stmt in body:
            col.visit(stmt)
        return sub

    # -- structure ----------------------------------------------------------
    def _visit_nested_def(self, node) -> None:
        key = f"{self.func.name}.{node.name}"
        self.local_funcs[node.name] = key
        self.func.maybe_calls.append((key, node.lineno, frozenset(self.guards)))
        self._collect_nested(key, node.lineno, node.body)

    visit_FunctionDef = _visit_nested_def
    visit_AsyncFunctionDef = _visit_nested_def

    def visit_Lambda(self, node: ast.Lambda) -> None:
        if id(node) in self._claimed:
            return
        self.generic_visit(node)  # inline into the enclosing function

    def visit_While(self, node: ast.While) -> None:
        self.while_depth += 1
        self.generic_visit(node)
        self.while_depth -= 1

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            self.visit(item.context_expr)
            tok, kind = self._sync_ref(item.context_expr)
            if tok is not None and kind in ("lock", "condition"):
                self.func.acquires.append(
                    (tok, node.lineno, frozenset(self.guards)))
                self.guards.append(tok)
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        del self.guards[len(self.guards) - pushed:]

    visit_AsyncWith = visit_With

    # -- accesses -----------------------------------------------------------
    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node, self.selfname)
        if attr is not None:
            write = isinstance(node.ctx, (ast.Store, ast.Del))
            self.func.refs.add("self." + attr)
            self.func.accesses.append(
                (attr, write, node.lineno, frozenset(self.guards)))
        self.generic_visit(node)

    def _bind_thread(self, value: ast.Call, targets: List[ast.AST],
                     line: int) -> None:
        self._bound.add(id(value))
        entry = self._resolve_entry(value)
        kind = _THREAD_CTORS[_dotted(value.func)]
        for t in targets:
            attr = _self_attr(t, self.selfname)
            if attr is not None:
                self.scope.thread_attrs.setdefault(attr, {
                    "kind": kind, "line": line, "entry": entry,
                    "started": False, "joined": False, "cancelled": False})
            elif isinstance(t, ast.Name):
                self.func.local_threads.append((line, t.id))
                self.local_thread_names.add(t.id)

    def visit_Assign(self, node: ast.Assign) -> None:
        if (isinstance(node.value, ast.Call)
                and _dotted(node.value.func) in _THREAD_CTORS):
            self._bind_thread(node.value, node.targets, node.lineno)
        for t in node.targets:
            # `self.X[k] = v` / `self.X[k].y = v`: mutation of X
            base = t
            while isinstance(base, (ast.Subscript, ast.Attribute)) and not (
                    _self_attr(base, self.selfname)):
                base = base.value
            attr = _self_attr(base, self.selfname)
            if attr is not None and base is not t:
                self.func.accesses.append(
                    (attr, True, node.lineno, frozenset(self.guards)))
            # `self._worker = t` where t is a local Thread: track as attr
            if (isinstance(node.value, ast.Name)
                    and node.value.id in self.local_thread_names):
                a2 = _self_attr(t, self.selfname)
                if a2 is not None:
                    self.func.escapes.add(node.value.id)
                    self.scope.thread_attrs.setdefault(a2, {
                        "kind": "thread", "line": node.lineno, "entry": None,
                        "started": False, "joined": False, "cancelled": False})
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if (node.value is not None and isinstance(node.value, ast.Call)
                and _dotted(node.value.func) in _THREAD_CTORS):
            self._bind_thread(node.value, [node.target], node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        base = node.target
        while isinstance(base, (ast.Subscript, ast.Attribute)) and not (
                _self_attr(base, self.selfname)):
            base = base.value
        attr = _self_attr(base, self.selfname)
        if attr is not None and base is not node.target:
            self.func.accesses.append(
                (attr, True, node.lineno, frozenset(self.guards)))
        self.generic_visit(node)

    def visit_Return(self, node: ast.Return) -> None:
        if isinstance(node.value, ast.Name) and \
                node.value.id in self.local_thread_names:
            self.func.escapes.add(node.value.id)
        self.generic_visit(node)

    # -- calls --------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        dot = _dotted(node.func)
        guards = frozenset(self.guards)
        line = node.lineno

        if dot in _THREAD_CTORS and id(node) not in self._bound:
            # unbound ctor (comprehension / chained / passed along)
            self._resolve_entry(node)
            self.func.local_threads.append((line, None))

        if dot and dot.split(".", 1)[0] in _TORCH_ROOTS and "." in dot:
            self.func.device_calls.append((dot, line))
        elif isinstance(node.func, ast.Attribute) and node.func.attr in _DEVICE_METHODS:
            self.func.device_calls.append((dot or "." + node.func.attr, line))
        if "urlopen" in dot or dot.startswith("requests."):
            self.func.blockers.append(("http", dot, line, guards))

        # local sync primitives (module functions, or locals in methods)
        if dot in _SYNC_KINDS:
            pass  # binding handled via Assign below (visit order: Assign first)

        if isinstance(node.func, ast.Attribute):
            short = node.func.attr
            base = node.func.value
            base_attr = _self_attr(base, self.selfname)
            tok, kind = self._sync_ref(base)

            if short == "start":
                if isinstance(base, ast.Call) and \
                        _dotted(base.func) in _THREAD_CTORS:
                    self.func.anon_starts.append(line)
                elif base_attr is not None and \
                        base_attr in self.scope.thread_attrs:
                    self.scope.thread_attrs[base_attr]["started"] = True
                elif isinstance(base, ast.Name) and \
                        base.id in self.local_thread_names:
                    self.func.started_names.add(base.id)
                else:
                    self.func.has_any_start = True
            elif short == "cancel" and base_attr is not None and \
                    base_attr in self.scope.thread_attrs:
                self.scope.thread_attrs[base_attr]["cancelled"] = True
            elif short == "join" and not node.args and \
                    not isinstance(base, ast.Constant):
                # zero-positional-arg join: thread management (str.join and
                # os.path.join always carry positional args)
                if base_attr is not None and \
                        base_attr in self.scope.thread_attrs:
                    self.scope.thread_attrs[base_attr]["joined"] = True
                self.func.has_mgmt_join = True
                if not any(kw.arg == "timeout" for kw in node.keywords):
                    self.func.blockers.append(
                        ("join", _dotted(base) or short, line, guards))
            elif short == "set" and kind == "event":
                self.func.events_set.add(tok)
            elif short == "wait":
                has_to = bool(node.args) or any(
                    kw.arg == "timeout" for kw in node.keywords)
                if kind == "condition":
                    self.func.cond_waits.append(
                        (tok, line, has_to, self.while_depth > 0, guards))
                elif kind == "event" and not has_to:
                    self.func.blockers.append(("event_wait", tok, line, guards))
            elif short in ("get", "put") and kind == "queue":
                nonblock = any(
                    kw.arg in ("timeout", "block") for kw in node.keywords) \
                    or (short == "get" and node.args) \
                    or (short == "put" and len(node.args) > 1)
                if not nonblock:
                    self.func.blockers.append(("queue", tok, line, guards))
            elif short == "acquire" and kind in ("lock", "condition"):
                self.func.acquires.append((tok, line, guards))
            elif short in _MUTATORS and base_attr is not None:
                self.func.accesses.append((base_attr, True, line, guards))

            if base_attr is not None and short not in ("join", "cancel"):
                pass  # attribute read recorded by visit_Attribute below

            if isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == self.selfname:
                self.func.calls.append((short, line, guards))

        # mgmt-by-helper: `join_or_warn(self._worker, ...)` etc.
        short_fn = dot.rsplit(".", 1)[-1] if dot else ""
        if "join" in short_fn or "cancel" in short_fn:
            for a in node.args:
                aa = _self_attr(a, self.selfname)
                if aa is not None and aa in self.scope.thread_attrs:
                    self.scope.thread_attrs[aa]["joined"] = True
                if isinstance(a, ast.Name) and \
                        a.id in self.local_thread_names:
                    self.func.has_mgmt_join = True

        # thread ctor target + `on_*` callback kwargs register entry points
        if dot in _THREAD_CTORS:
            self._resolve_entry(node)
        for kw in node.keywords:
            if kw.arg and kw.arg.startswith("on_"):
                cb = _self_attr(kw.value, self.selfname)
                if cb is not None and cb in self.scope.method_names:
                    self.scope.entries.add(cb)

        # any local thread handle passed to another call escapes tracking
        for a in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(a, ast.Name) and a.id in self.local_thread_names:
                self.func.escapes.add(a.id)

        self.generic_visit(node)


def _collect_class(node: ast.ClassDef) -> _Scope:
    scope = _Scope(name=node.name, line=node.lineno)
    for stmt in node.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope.method_names.add(stmt.name)
    # pass 1: sync + thread attributes (any method, usually __init__)
    for sub in ast.walk(node):
        if not isinstance(sub, (ast.Assign, ast.AnnAssign)):
            continue
        value = sub.value
        if not isinstance(value, ast.Call):
            continue
        dot = _dotted(value.func)
        targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
        for t in targets:
            attr = _self_attr(t, "self")
            if attr is None:
                continue
            if dot in _SYNC_KINDS:
                scope.sync["self." + attr] = _SYNC_KINDS[dot]
    # pass 2: per-method collection
    for stmt in node.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        args = stmt.args.posonlyargs + stmt.args.args
        selfname = args[0].arg if args else None
        func = _Func(name=stmt.name, line=stmt.lineno)
        scope.funcs[stmt.name] = func
        col = _FuncCollector(scope, func, selfname)
        for s in stmt.body:
            col.visit(s)
    return scope


def _collect_module(tree: ast.Module) -> _Scope:
    """Module pseudo-scope: top-level functions, local locks/threads only."""
    scope = _Scope(name="<module>", line=1, module_scope=True)
    for stmt in tree.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        func = _Func(name=stmt.name, line=stmt.lineno)
        scope.funcs[stmt.name] = func
        col = _FuncCollector(scope, func, selfname=None)
        # seed local sync vars assigned at function top level
        for s in stmt.body:
            if isinstance(s, ast.Assign) and isinstance(s.value, ast.Call):
                kind = _SYNC_KINDS.get(_dotted(s.value.func))
                if kind:
                    for t in s.targets:
                        if isinstance(t, ast.Name):
                            col.local_syncs[t.id] = kind
        for s in stmt.body:
            col.visit(s)
    return scope

# --------------------------------------------------------------------------
# analysis
# --------------------------------------------------------------------------

def _call_edges(scope: _Scope) -> Dict[str, List[Tuple[str, frozenset]]]:
    edges: Dict[str, List[Tuple[str, frozenset]]] = {}
    for fname, f in scope.funcs.items():
        out: List[Tuple[str, frozenset]] = []
        for callee, _line, g in f.calls:
            if callee in scope.funcs:
                out.append((callee, g))
        for pseudo, _line, g in f.maybe_calls:
            # nested defs/lambdas inline into the enclosing side unless
            # they are thread entry points in their own right
            if pseudo in scope.funcs and pseudo not in scope.entries:
                out.append((pseudo, g))
        edges[fname] = out
    return edges


def _contexts(roots: Iterable[str],
              edges: Dict[str, List[Tuple[str, frozenset]]]
              ) -> Dict[str, Set[frozenset]]:
    """Fixpoint: per reachable function, the lock sets held at entry."""
    ctx: Dict[str, Set[frozenset]] = {}
    work: List[Tuple[str, frozenset]] = []
    for r in roots:
        if r in edges or r in ctx or True:
            ctx.setdefault(r, set()).add(frozenset())
            work.append((r, frozenset()))
    while work:
        m, c = work.pop()
        for callee, g in edges.get(m, ()):
            nc = c | g
            got = ctx.setdefault(callee, set())
            if nc not in got and len(got) < _MAX_CONTEXTS:
                got.add(nc)
                work.append((callee, nc))
    return ctx


def _caller_roots(scope: _Scope,
                  edges: Dict[str, List[Tuple[str, frozenset]]]) -> Set[str]:
    incoming: Set[str] = set()
    for outs in edges.values():
        incoming.update(callee for callee, _g in outs)
    roots = set()
    for fname in scope.funcs:
        if fname in scope.entries or fname == "__init__":
            continue
        if "." in fname:  # pseudo (nested def/lambda): never an external root
            continue
        if fname not in incoming:
            roots.add(fname)
    return roots


def _side_accesses(scope: _Scope, ctxs: Dict[str, Set[frozenset]]
                   ) -> Dict[str, List[Tuple[str, int, bool, frozenset]]]:
    """attr -> [(func, line, is_write, effective_guards)] on one side."""
    out: Dict[str, List[Tuple[str, int, bool, frozenset]]] = {}
    for fname, f in scope.funcs.items():
        if fname == "__init__" or fname.startswith("__init__."):
            continue  # happens-before any thread start
        cs = ctxs.get(fname)
        if not cs:
            continue
        for attr, write, line, g in f.accesses:
            recs = out.setdefault(attr, [])
            for c in cs:
                recs.append((fname, line, write, c | g))
    return out


def _check_vtx200(scope: _Scope, path: str,
                  tctx: Dict[str, Set[frozenset]],
                  cctx: Dict[str, Set[frozenset]]) -> List[Finding]:
    if scope.module_scope or not scope.entries:
        return []
    t_acc = _side_accesses(scope, tctx)
    c_acc = _side_accesses(scope, cctx)
    findings: List[Finding] = []
    skip = {tok.split(".", 1)[1] for tok in scope.sync}
    skip |= set(scope.thread_attrs)  # handles are start/join protocol state
    skip |= scope.method_names
    for attr in sorted(set(t_acc) | set(c_acc)):
        if attr in skip:
            continue
        hit = None
        for wside, aside, wname, aname in (
                (t_acc, c_acc, "thread", "caller"),
                (c_acc, t_acc, "caller", "thread")):
            for fw, lw, w, gw in wside.get(attr, ()):
                if not w:
                    continue
                for fa, la, _aw, ga in aside.get(attr, ()):
                    if (fw, lw) == (fa, la):
                        continue
                    if not (gw & ga):
                        hit = (fw, lw, wname, fa, la, aname)
                        break
                if hit:
                    break
            if hit:
                break
        if hit:
            fw, lw, wname, fa, la, aname = hit
            findings.append(Finding(
                "VTX200", "ERROR", path, lw,
                f"`{scope.name}.{attr}` written on the {wname} path "
                f"(`{fw}`, line {lw}) and accessed on the {aname} path "
                f"(`{fa}`, line {la}) with no common lock — guard both "
                "sides with one lock"))
    return findings


def _check_vtx201(scope: _Scope, path: str) -> List[Finding]:
    findings = []
    for f in scope.funcs.values():
        for tok, line, _has_to, in_while, _g in f.cond_waits:
            if not in_while:
                findings.append(Finding(
                    "VTX201", "ERROR", path, line,
                    f"`{tok}.wait()` outside a `while` predicate loop in "
                    f"`{scope.name}.{f.name}` — condition waits can wake "
                    "spuriously; re-check the predicate in a while loop"))
    return findings


def _check_vtx202(scope: _Scope, path: str,
                  allctx: Dict[str, Set[frozenset]]) -> List[Finding]:
    edges: Dict[str, Dict[str, int]] = {}
    for fname, f in scope.funcs.items():
        cs = allctx.get(fname) or {frozenset()}
        for tok, line, g in f.acquires:
            for c in cs:
                for held in (c | g):
                    if held != tok:
                        edges.setdefault(held, {}).setdefault(tok, line)
    findings, seen = [], set()
    # DFS cycle detection over the small per-class lock graph
    def dfs(n: str, stack: List[str], on: Set[str]) -> None:
        on.add(n)
        stack.append(n)
        for m in edges.get(n, {}):
            if m in on:
                cyc = stack[stack.index(m):]
                key = frozenset(cyc)
                if key not in seen:
                    seen.add(key)
                    line = edges[n][m]
                    order = " -> ".join(cyc + [m])
                    findings.append(Finding(
                        "VTX202", "ERROR", path, line,
                        f"lock-order cycle in `{scope.name}`: {order} — "
                        "two threads taking these locks in opposite order "
                        "deadlock; pick one global order"))
            elif m in edges:
                dfs(m, stack, on)
        stack.pop()
        on.discard(n)
    for n in sorted(edges):
        dfs(n, [], set())
    return findings


def _check_vtx203(scope: _Scope, path: str,
                  allctx: Dict[str, Set[frozenset]]) -> List[Finding]:
    findings = []
    for fname, f in scope.funcs.items():
        cs = allctx.get(fname) or {frozenset()}
        done: Set[int] = set()
        blockers = list(f.blockers) + [
            ("cond_wait", tok, line, g) for tok, line, _t, _w, g
            in f.cond_waits]
        for kind, desc, line, g in blockers:
            if line in done:
                continue
            for c in cs:
                held = set(c | g)
                if kind == "cond_wait":
                    held.discard(desc)  # Condition.wait releases its own lock
                if held:
                    what = {"join": f"`{desc}.join()` with no timeout",
                            "queue": f"blocking `{desc}.get/put()`",
                            "event_wait": f"`{desc}.wait()` with no timeout",
                            "cond_wait": f"`{desc}.wait()`",
                            "http": f"HTTP request `{desc}`"}[kind]
                    findings.append(Finding(
                        "VTX203", "ERROR", path, line,
                        f"{what} in `{scope.name}.{fname}` while holding "
                        f"{sorted(held)} — blocks every other thread needing "
                        "that lock; release it first or bound the wait"))
                    done.add(line)
                    break
    return findings


def _check_vtx204(scope: _Scope, path: str,
                  tctx: Dict[str, Set[frozenset]]) -> List[Finding]:
    findings = []
    for fname in sorted(tctx):
        f = scope.funcs.get(fname)
        if f is None:
            continue
        for dot, line in f.device_calls:
            findings.append(Finding(
                "VTX204", "ERROR", path, line,
                f"device work `{dot}` on the thread path "
                f"`{scope.name}.{fname}` — only sanctioned threads may "
                "touch the device (races the main thread's launches on the "
                "current stream); move it to the step's thread or suppress "
                "with a reason"))
    return findings


def _check_vtx205(scope: _Scope, path: str) -> List[Finding]:
    findings = []
    events_set_anywhere: Set[str] = set()
    for f in scope.funcs.values():
        events_set_anywhere |= f.events_set
    for attr, info in sorted(scope.thread_attrs.items()):
        if not info["started"] or info["joined"] or info["cancelled"]:
            continue
        entry = info["entry"]
        stop_evented = False
        if entry is not None and entry in scope.funcs:
            refs = scope.funcs[entry].refs
            stop_evented = any(e in refs for e in events_set_anywhere)
        if not stop_evented:
            kind = "timer" if info["kind"] == "timer" else "thread"
            fix = ("`.cancel()` it on the shutdown path" if kind == "timer"
                   else "join it (or set a stop event its loop checks) on a "
                        "stop/close/drain path")
            findings.append(Finding(
                "VTX205", "ERROR", path, info["line"],
                f"{kind} `self.{attr}` in `{scope.name}` is started but "
                f"never reclaimed — {fix}, or it leaks past shutdown"))
    for f in scope.funcs.values():
        started_locals = [(line, name) for line, name in f.local_threads
                          if name is None or name in f.started_names]
        if f.has_any_start:
            started_locals += [(line, name) for line, name in f.local_threads
                               if name is not None
                               and name not in f.started_names]
        for line, name in started_locals:
            if f.has_mgmt_join or (name is not None and name in f.escapes):
                continue
            label = f"`{name}`" if name else "anonymous thread"
            findings.append(Finding(
                "VTX205", "ERROR", path, line,
                f"{label} started in `{scope.name}.{f.name}` with no join "
                "on any path and no hand-off — the thread leaks past the "
                "function; join it or store it somewhere a shutdown path "
                "reclaims"))
        for line in f.anon_starts:
            if f.has_mgmt_join:
                continue
            findings.append(Finding(
                "VTX205", "ERROR", path, line,
                f"`threading.Thread(...).start()` in `{scope.name}."
                f"{f.name}` drops the handle — nothing can ever join or "
                "stop this thread"))
    return findings


def _analyze(scope: _Scope, path: str) -> List[Finding]:
    edges = _call_edges(scope)
    tctx = _contexts(scope.entries, edges)
    cctx = _contexts(_caller_roots(scope, edges), edges)
    allctx: Dict[str, Set[frozenset]] = {}
    for src in (tctx, cctx):
        for k, v in src.items():
            allctx.setdefault(k, set()).update(v)
    findings = []
    findings += _check_vtx200(scope, path, tctx, cctx)
    findings += _check_vtx201(scope, path)
    findings += _check_vtx202(scope, path, allctx)
    findings += _check_vtx203(scope, path, allctx)
    findings += _check_vtx204(scope, path, tctx)
    findings += _check_vtx205(scope, path)
    return findings


# --------------------------------------------------------------------------
# driver (mirrors ast_lint: suppressions, paths, --json, exit code)
# --------------------------------------------------------------------------

def lint_source(source: str, path: str) -> List[Finding]:
    """Lint one file's source text; returns surviving findings.

    Bare-suppression policing (VTX100) is ast_lint's job — this pass only
    honors the same `# vtx: ignore[...]` comments, so running both passes
    over one tree never double-reports."""
    suppressed, _bare = _suppressions(source)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return []  # ast_lint reports syntax errors; don't double up
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            findings.extend(_analyze(_collect_class(node), path))
    findings.extend(_analyze(_collect_module(tree), path))
    out = []
    for f in findings:
        if f.code in suppressed.get(f.line, ()):
            continue
        out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.code))
    return out


def _lint_file(path: str) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


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


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m vitax_torch.analysis.concurrency", description=__doc__,
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
            print("concurrency: clean")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
