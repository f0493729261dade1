"""Deterministic fault injection (vitax/faults.py): drills for the
failure-reaction layer on a schedule.

A JSON fault plan (--fault_plan, or the VITAX_FAULT_PLAN environment
variable) names a hook site, a 1-based call index at that site and an
action:

    {"site": "step", "at": 6, "action": "crash", "exit_code": 13}

or a list of such specs, optionally wrapped as {"faults": [...]}.

Training sites (each one host-side hook point):
  step        once per dispatched optimizer step, index = the run's step
              count from 1 (train/loop.py)
  ckpt_write  once per checkpoint write attempt, inside the save's retry
              loop, so `times` > 1 drills the retry (checkpoint/io.py)
  loader      once per produced host batch, on the producer thread
              (data/loader.py)
  stream_read once per shard-file open attempt (data/stream/format.py)
  barrier_timeout
              once per control-word agreement (train/control.py
              ControlPlane.poll): a `hang` here starves the agreement as a
              peer that died between cadences does
  peer_restore
              once per peer-shard load of a peer restore, index = the
              shard's source process (checkpoint/peer.py PeerStore.load)

Serve sites (vitax's chaos layer for its serving fleet):
  engine_predict  once per engine batch, before any work
                  (serve/engine.py InferenceEngine.predict)
  batcher_flush   once per flushed batch, on the batcher's worker: a
                  failure fails that batch's futures, the worker lives on
                  (serve/batcher.py)
  replica_health  once per replica probe, in the manager's sweep order, so
                  with N replicas index k*N + i targets replica i
                  (serve/fleet/replica.py)
  router_dispatch once per dispatch attempt, single or composed
                  (serve/fleet/router.py)

Actions:
  crash     os._exit(exit_code): no atexit, no drains (default code 13)
  hang      time.sleep(seconds) on the hooked thread (default 3600)
  oserror   raise OSError at the hook
  stall     alias of hang (a starved consumer at the loader site)
  sigterm   os.kill(os.getpid(), SIGTERM): a self-delivered preemption
  peer_loss os.kill(os.getpid(), SIGKILL): an abrupt death that the
            surviving processes see as a heartbeat that stops

A spec with "process": K fires on process K only (-1, the default, on
every process). The process index is torchrun's RANK where set, else the
index recorded when the plan was installed on the loop thread, so a
producer thread never calls torch.distributed to decide.

A spec fires when the site's call index (an explicit `index=` from the
hook, else a per-site counter) lies in [at, at + times). With no plan the
hooks are one module-global `is None` check, and the step launches the
same kernels with a plan armed or not (every hook is on the host).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

SITES = ("step", "ckpt_write", "loader", "stream_read", "barrier_timeout", "peer_restore",
         # serve-path sites (vitax's chaos layer for its serving fleet)
         "engine_predict", "batcher_flush", "replica_health", "router_dispatch")
ACTIONS = ("crash", "hang", "oserror", "stall", "sigterm", "peer_loss")

DEFAULT_CRASH_EXIT_CODE = 13
DEFAULT_HANG_SECONDS = 3600.0

ENV_VAR = "VITAX_FAULT_PLAN"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire `action` at call indices [at, at + times)."""

    site: str
    action: str
    at: int = 1
    times: int = 1
    exit_code: int = DEFAULT_CRASH_EXIT_CODE
    seconds: float = DEFAULT_HANG_SECONDS
    process: int = -1  # fire only on this process index; -1 = every process

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"fault_plan: unknown site {self.site!r} (expected one of {SITES})")
        if self.action not in ACTIONS:
            raise ValueError(f"fault_plan: unknown action {self.action!r} (expected one of {ACTIONS})")
        if self.at < 1:
            raise ValueError(f"fault_plan: `at` is a 1-based call index, got {self.at}")
        if self.times < 1:
            raise ValueError(f"fault_plan: `times` must be >= 1, got {self.times}")
        if self.seconds < 0:
            raise ValueError(f"fault_plan: `seconds` must be >= 0, got {self.seconds}")
        if self.process < -1:
            raise ValueError(f"fault_plan: `process` must be a process index >= 0, or -1 for all processes, "
                             f"got {self.process}")

    @staticmethod
    def from_dict(d: dict) -> "FaultSpec":
        known = {f.name for f in dataclasses.fields(FaultSpec)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"fault_plan: unknown keys {sorted(extra)} (expected a subset of {sorted(known)})")
        if "site" not in d or "action" not in d:
            raise ValueError("fault_plan: every spec needs `site` and `action`")
        return FaultSpec(**d)

    def describe(self) -> str:
        arg = {"crash": f"exit_code={self.exit_code}", "hang": f"seconds={self.seconds:g}",
               "stall": f"seconds={self.seconds:g}"}.get(self.action, "")
        window = f"at={self.at}" if self.times == 1 else f"at={self.at}..{self.at + self.times - 1}"
        who = f"@p{self.process}" if self.process >= 0 else ""
        return f"{self.site}:{self.action}{who}({window}{', ' + arg if arg else ''})"


class FaultPlan:
    """A parsed plan and its per-site call counters (thread-safe: the loader
    site fires on the producer thread, `step` on the loop thread)."""

    def __init__(self, specs: List[FaultSpec]):
        self.specs = list(specs)
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()

    def describe(self) -> str:
        return ", ".join(s.describe() for s in self.specs) or "(empty)"

    def fire(self, site: str, index: Optional[int] = None) -> None:
        """Run any fault scheduled for this call of `site`. The per-site
        counter advances on every call, with or without an explicit index."""
        with self._lock:
            self._counters[site] = self._counters.get(site, 0) + 1
            idx = self._counters[site] if index is None else index
        for spec in self.specs:
            if spec.site == site and spec.at <= idx < spec.at + spec.times:
                if spec.process >= 0 and spec.process != _process_index():
                    continue
                _act(spec, idx)


def _process_index() -> int:
    """This process's index for `process`-designated specs: torchrun's
    RANK where set, else the one install_from_config recorded, else 0."""
    env = os.environ.get("RANK", "")
    return int(env) if env.isdigit() else _PROCESS


def _act(spec: FaultSpec, index: int) -> None:
    payload = {"site": spec.site, "action": spec.action, "index": index}
    reporter = _REPORTER
    if reporter is not None:
        try:
            reporter(payload)   # JSONL sinks flush per record: the event outlives the crash's os._exit
        except Exception as e:  # noqa: BLE001 - reporting must not mask the drill
            print(f"vitax_torch.faults: reporter failed ({type(e).__name__}: {e})", file=sys.stderr, flush=True)
    print(f"vitax_torch.faults: injecting {spec.describe()} (call {index})", file=sys.stderr, flush=True)
    if spec.action == "crash":
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(spec.exit_code)
    elif spec.action in ("hang", "stall"):
        time.sleep(spec.seconds)
    elif spec.action == "oserror":
        raise OSError(f"injected fault: {spec.describe()} (call {index})")
    elif spec.action == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
    elif spec.action == "peer_loss":
        # no handlers, no atexit, no last collectives: the survivors see a
        # heartbeat that stops (train/control.py PeerLiveness)
        sys.stdout.flush()
        sys.stderr.flush()
        os.kill(os.getpid(), signal.SIGKILL)


# --- the module-level registry the hooks read --------------------------------

_PLAN: Optional[FaultPlan] = None
_REPORTER: Optional[Callable[[dict], None]] = None
_PROCESS = 0


def parse_plan(plan_json: str) -> FaultPlan:
    """Parse and validate a plan string; ValueError on any problem, so
    config.validate() fails a bad plan at startup, not at step N."""
    try:
        data = json.loads(plan_json)
    except json.JSONDecodeError as e:
        raise ValueError(f"fault_plan: not valid JSON ({e})") from e
    if isinstance(data, dict) and "faults" in data:
        data = data["faults"]
    if isinstance(data, dict):
        data = [data]
    if not isinstance(data, list):
        raise ValueError("fault_plan: expected a spec object, a list of them, or {\"faults\": [...]}")
    specs = [FaultSpec.from_dict(d) for d in data]
    if not specs:
        raise ValueError("fault_plan: empty plan — drop the flag instead")
    return FaultPlan(specs)


def install(plan_json: str) -> FaultPlan:
    """Arm a plan (replacing any previous one); returns it."""
    global _PLAN
    _PLAN = parse_plan(plan_json)
    return _PLAN


def install_from_config(cfg, process_index: int = 0) -> Optional[FaultPlan]:
    """Arm the plan of --fault_plan, else of VITAX_FAULT_PLAN, else none.
    Called once per train() on the loop thread, so every supervised
    restart re-arms the same plan; `process_index` is this process's rank
    for specs with a "process" when RANK is not in the environment."""
    global _PROCESS
    _PROCESS = int(process_index)
    plan_json = getattr(cfg, "fault_plan", "") or os.environ.get(ENV_VAR, "")
    if not plan_json:
        uninstall()
        return None
    return install(plan_json)


def uninstall() -> None:
    """Disarm (idempotent): the hooks go back to the no-op path."""
    global _PLAN, _REPORTER
    _PLAN = None
    _REPORTER = None


def active() -> bool:
    return _PLAN is not None


def set_reporter(reporter: Optional[Callable[[dict], None]]) -> None:
    """Wire fired faults to telemetry (the loop passes
    `lambda p: recorder.event("fault", **p)`); None clears."""
    global _REPORTER
    _REPORTER = reporter


def fire(site: str, index: Optional[int] = None) -> None:
    """The hook the subsystems call: one global read with no plan armed."""
    if _PLAN is None:
        return
    _PLAN.fire(site, index)
