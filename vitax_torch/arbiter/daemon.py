"""The arbiter daemon: ledger + policy + both tenants' contracts
(vitax/arbiter/daemon.py).

`Arbiter.tick()` is the whole control loop: fold the fleet's pressure
signals with any `request_capacity` escalations, ask the policy for a
verdict, and execute it through seams —

  train side   `TrainDirector`: the training job's processes, one per
               train-owned host (default child `python -m
               vitax_torch.train`). A borrow drains them through the
               agreed-preemption path (SIGTERM ->
               vitax_torch/train/preempt.py -> joint committed
               checkpoint -> exit 0) and relaunches at N - k with the
               bring-up env rebuilt (supervise.topology_env: RANK,
               WORLD_SIZE, MASTER_ADDR, MASTER_PORT ...); elastic resume
               + peer replication make that a seconds-long handoff. A
               return re-expands the same way.
  serve side   `provision(host) -> url` / `release(host, url)` speak the
               placement agent's POST /provision / POST /release, and
               `fleet_adopt(url)` / `fleet_release(url)` the router's
               POST /fleet/adopt / POST /fleet/release, so the running
               fleet routes to (and later drains) the borrowed replica.

Every seam is injectable (clock, spawn, transport, the four callables)
so the full borrow/return state machine unit-tests socketless, exactly
like the autoscaler. Failures roll
back: a borrow that dies between the train shrink and the fleet adopt
restores the ledger and re-expands training, then surfaces as a
borrow_failed event — the ledger never claims a state the pod is not in.

Threading (VTX200 discipline): one ticker thread plus the HTTP server's
handler threads. `_lock` guards the borrowed map, counters and policy
state; the slow tenant calls (drain, provision, transport) all run
OUTSIDE it, so /ledger and /metrics stay responsive mid-borrow.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence

from vitax_torch.arbiter.ledger import HostLedger
from vitax_torch.arbiter.policy import POLICIES, ArbiterPolicy

DEFAULT_INTERVAL_S = 1.0
DEFAULT_TRAIN_GRACE_S = 120.0
DEFAULT_TRANSPORT_TIMEOUT_S = 30.0
EVENT_KIND = "arbiter"


def free_port() -> int:
    """An OS-assigned free TCP port (coordinator relaunches need a fresh
    one: the old coordinator socket may linger in TIME_WAIT)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_http_json(url: str, payload: Optional[dict],
                      timeout: float) -> dict:
    data = (json.dumps(payload).encode("utf-8")
            if payload is not None else None)
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.load(resp)


def default_train_argv(argv: Sequence[str]) -> List[str]:
    """The training command: `argv` as given, or `python -m
    vitax_torch.train argv` when it is empty or starts with a flag."""
    argv = list(argv)
    if not argv or argv[0].startswith("-"):
        return [sys.executable, "-m", "vitax_torch.train", *argv]
    return argv


class JsonlRecorder:
    """Schema-1 JSONL event sink with no torch/telemetry import — the
    arbiter is a control-plane process like the supervisor, and stays as
    light (vitax_torch/supervise.py keeps the same literal for the same
    reason). Thread-safe: handler threads and the ticker both emit."""

    SCHEMA_VERSION = 1  # telemetry/record.py's SCHEMA_VERSION

    def __init__(self, metrics_dir: str):
        self.path = os.path.join(metrics_dir, "metrics.jsonl")
        os.makedirs(metrics_dir, exist_ok=True)
        self._lock = threading.Lock()

    def event(self, kind: str, **payload) -> None:
        record = {"schema": self.SCHEMA_VERSION, "time": time.time(),
                  "kind": kind, "rank": 0, **payload}
        line = json.dumps(record, sort_keys=True) + "\n"
        try:
            with self._lock:
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line)
        except OSError as e:
            print(f"[vitax_torch.arbiter] cannot write {kind} event ({e})",
                  file=sys.stderr, flush=True)

    def close(self) -> None:
        pass


class TrainDirector:
    """The training job's processes, resized by draining and relaunching.

    There is deliberately no in-place membership change: the train job's
    topology flips through the contract the stack already trusts —
    SIGTERM every process (the control plane's agreed preemption commits
    one joint checkpoint and every rank exits 0), then spawn the new
    count with supervise.topology_env and let elastic resume + the peer
    stores bring the smaller (or larger) pod back in seconds. A child
    argv that starts with a flag runs as `python -m vitax_torch.train
    <argv>`. `spawn` and `sleep` are injectable so resize logic
    unit-tests on fakes."""

    def __init__(self, child_argv: Sequence[str],
                 term_grace_s: float = DEFAULT_TRAIN_GRACE_S,
                 env: Optional[dict] = None, log_dir: str = "",
                 spawn: Optional[Callable] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 port_fn: Callable[[], int] = free_port):
        from vitax_torch.supervise import ensure_auto_resume
        self.child_argv = ensure_auto_resume(default_train_argv(child_argv))
        self.term_grace_s = term_grace_s
        self.base_env = dict(os.environ if env is None else env)
        self.log_dir = log_dir
        self._spawn = spawn or self._default_spawn
        self._sleep = sleep
        self._port_fn = port_fn
        self._lock = threading.Lock()
        # guarded by _lock:
        self._procs: List[object] = []
        self._generation = 0
        self.resizes_total = 0
        # wall-clock of the newest generation's launch (operator
        # observability only — the arbiter's booting-rank gate keeps its
        # own per-resize stamp in its own clock domain, Arbiter._gen_start_t)
        self.last_start_t: Optional[float] = None

    def _default_spawn(self, argv: Sequence[str], env: dict, tag: str):
        out = None
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            out = open(os.path.join(self.log_dir, f"train_{tag}.log"), "ab")
        try:
            return subprocess.Popen(list(argv), env=env, stdout=out,
                                    stderr=subprocess.STDOUT if out else None)
        finally:
            if out is not None:
                out.close()  # the child holds its own fd from here

    @property
    def process_count(self) -> int:
        with self._lock:
            return len(self._procs)

    def alive(self) -> int:
        with self._lock:
            procs = list(self._procs)
        return sum(1 for p in procs if p.poll() is None)

    def healthy(self) -> bool:
        """Every launched process still running (a crashed rank means the
        pod is mid-recovery — not a moment to drain it)."""
        with self._lock:
            n = len(self._procs)
        return n == 0 or self.alive() == n

    def start(self, n: int) -> None:
        from vitax_torch.supervise import topology_env
        assert n >= 1, n
        with self._lock:
            assert not self._procs, "training already running"
            generation = self._generation
            self._generation += 1
        port = self._port_fn() if n > 1 else 0
        procs = []
        for pid in range(n):
            env = topology_env(self.base_env, n, pid, port)
            procs.append(self._spawn(self.child_argv, env,
                                     f"g{generation}_p{pid}"))
        with self._lock:
            self._procs = procs
            self.last_start_t = time.time()

    def drain(self) -> List[Optional[int]]:
        """SIGTERM every process FIRST (the preemption fold needs all
        ranks alive to agree and reach the joint save barrier), then wait
        each out through the grace window (supervise.terminate_children).
        Each gets one SIGTERM: vitax's drain sends a second through
        terminate_child, which kills a rank that already saved and put
        back the default disposition on its way out (exit -15, a dirty
        drain)."""
        from vitax_torch.supervise import terminate_children
        with self._lock:
            procs, self._procs = self._procs, []
        return terminate_children(procs, self.term_grace_s, sleep=self._sleep)

    def resize(self, n: int) -> dict:
        """Drain to a joint checkpoint, relaunch at `n`. Raises if any
        rank failed to exit cleanly — the caller must not hand off a host
        whose training state never committed. A dirty drain still
        relaunches at the ORIGINAL count first (the last committed
        checkpoint is intact): the director must never be left with zero
        training processes, or every later resize computes from 0."""
        was = self.process_count
        codes = self.drain()
        bad = [c for c in codes if c != 0]
        if bad:
            if was >= 1:
                self.start(was)
            raise RuntimeError(
                f"train drain failed: exit codes {codes} (expected all 0); "
                f"relaunched at {was}")
        self.start(n)
        with self._lock:
            self.resizes_total += 1
        return {"from_processes": was, "to_processes": n,
                "exit_codes": codes}

    def stop(self) -> List[Optional[int]]:
        return self.drain()


class Arbiter:
    """Ledger + policy + executor; see module docstring."""

    def __init__(self, ledger: HostLedger, policy: ArbiterPolicy,
                 train: Optional[TrainDirector] = None,
                 provision: Optional[Callable[[str], str]] = None,
                 release: Optional[Callable[[str, str], None]] = None,
                 fleet_adopt: Optional[Callable[[str], None]] = None,
                 fleet_release: Optional[Callable[[str], None]] = None,
                 signals_fn: Optional[Callable[[], dict]] = None,
                 recorder=None, interval_s: float = DEFAULT_INTERVAL_S,
                 clock: Callable[[], float] = time.monotonic,
                 allow_admin: bool = False,
                 telemetry_stale_s: float = 30.0):
        self.ledger = ledger
        self.policy = policy
        self.train = train
        self._provision = provision
        self._release = release
        self._fleet_adopt = fleet_adopt
        self._fleet_release = fleet_release
        self._signals_fn = signals_fn
        self.recorder = recorder
        self.interval_s = interval_s
        self._clock = clock
        self.allow_admin = allow_admin
        self.telemetry_stale_s = telemetry_stale_s
        self._lock = threading.Lock()
        # guarded by _lock:
        self._borrowed: Dict[str, Optional[str]] = {}  # host -> replica url
        self._train_telemetry: Optional[dict] = None   # last POST /telemetry
        # _clock() stamp of the newest train generation launched by an
        # ARBITER resize (None until the first borrow/return). Stamped in
        # _resize_train so it shares a clock domain with observed_at; the
        # director's last_start_t is wall-clock and must never be compared
        # against arbiter timestamps (the default _clock is monotonic).
        self._gen_start_t: Optional[float] = None
        self._escalations = 0
        self._last_deny_reason: Optional[str] = None
        self.borrows_total = 0
        self.returns_total = 0
        self.denies_total = 0
        self.requests_total = 0
        self.last_event: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- escalation intake (HTTP handler threads) ------------------------------

    def request_capacity(self, reason: str = "") -> dict:
        """A maxed-out autoscaler asking for more chips. Recorded as
        pressure for the next tick; the answer is always asynchronous
        (the borrow itself takes seconds of train drain)."""
        with self._lock:
            self._escalations += 1
            self.requests_total += 1
        self._event(event="request", reason=reason or "escalation",
                    ledger_version=self.ledger.version)
        return {"accepted": True, "status": "pending"}

    def observe_train(self, payload: dict) -> dict:
        """Train-side heartbeat (rank 0's ArbiterReporter, POST
        /telemetry): step/epoch/process_count. A heartbeat newer than
        `telemetry_stale_s` is direct evidence the pod is progressing —
        stronger than the director's process-alive check, which cannot
        see a wedged-but-running rank."""
        record = {k: payload[k] for k in ("step", "epoch", "process_count")
                  if k in payload}
        record["observed_at"] = self._clock()
        with self._lock:
            self._train_telemetry = record
        return {"ok": True}

    def set_policy(self, name: str) -> dict:
        if name not in POLICIES:
            raise ValueError(f"unknown policy {name!r} (one of {POLICIES})")
        with self._lock:
            self.policy.set_policy(name)
        self._event(event="policy_change", policy=name,
                    ledger_version=self.ledger.version)
        return {"policy": name}

    # -- decision loop ---------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One evaluation; returns the executed action ("borrow" /
        "return") or None. The background loop calls this every
        `interval_s`; tests drive it directly with an injected now."""
        now = self._clock() if now is None else now
        sig = dict(self._signals_fn() if self._signals_fn else {})
        with self._lock:
            tel = self._train_telemetry
            gen_t = self._gen_start_t
        if tel is not None:
            fresh = now - tel["observed_at"] <= self.telemetry_stale_s
            # a heartbeat only vouches for the generation that posted it:
            # after a resize, the new ranks must report a step of their
            # own before any further drain — a booting rank has no
            # preemption handler installed and would die dirty
            this_gen = gen_t is None or tel["observed_at"] >= gen_t
            if fresh and this_gen:
                sig.setdefault("train_progressing", True)
            elif gen_t is not None:
                sig.setdefault("train_progressing", False)
        if self.train is not None:
            sig.setdefault("train_progressing", self.train.healthy())
        counts = self.ledger.counts()
        repeat = False
        with self._lock:
            sig["escalations"] = sig.get("escalations", 0) + self._escalations
            self._escalations = 0
            decision = self.policy.tick(sig, counts,
                                        len(self._borrowed), now)
            if decision.deny:
                repeat = decision.reason == self._last_deny_reason
                self._last_deny_reason = decision.reason
                if not repeat:
                    self.denies_total += 1
            else:
                self._last_deny_reason = None
        if decision.deny and not repeat:
            extra = {}
            if decision.reason == "train_stalled" and tel is not None:
                # the inputs behind the verdict, so a starved fleet's log
                # says WHY the train job read as stalled
                extra["telemetry_age_s"] = round(now - tel["observed_at"], 3)
                if gen_t is not None:
                    extra["generation_lag_s"] = round(
                        gen_t - tel["observed_at"], 3)
            self._event(event="deny", reason=decision.reason,
                        ledger_version=self.ledger.version, **extra)
            return None
        if decision.action == "borrow":
            return self._do_borrow(decision.reason, now)
        if decision.action == "return":
            return self._do_return(decision.reason, now)
        return None

    def _resize_train(self, n: int) -> None:
        """Every arbiter-driven resize goes through here so the new
        generation is stamped with the arbiter's OWN clock. The stamp is
        in a finally: a dirty drain raises AFTER self-healing by
        relaunching at the old count, which is a new generation too."""
        try:
            self.train.resize(n)
        finally:
            with self._lock:
                self._gen_start_t = self._clock()

    def _do_borrow(self, reason: str, now: float) -> Optional[str]:
        train_hosts = self.ledger.hosts_owned("train")
        if not train_hosts:
            return None
        host = train_hosts[-1]  # newest train lease: peel from one end
        self._event(event="borrow_start", host=host, reason=reason,
                    ledger_version=self.ledger.version)
        t0 = self._clock()
        shrunk = False
        url: Optional[str] = None
        try:
            if self.train is not None:
                self._resize_train(self.train.process_count - 1)
                shrunk = True
            lease = self.ledger.assign(host, "serve")
            if self._provision is not None:
                url = self._provision(host)
            if url and self._fleet_adopt is not None:
                self._fleet_adopt(url)
        except Exception as e:  # noqa: BLE001 - a failed borrow must roll back, not crash the loop
            self._rollback_borrow(host, url, shrunk)
            with self._lock:
                self.policy.action_taken(now)
            self._event(event="borrow_failed", host=host, reason=reason,
                        detail=f"{type(e).__name__}: {e}",
                        ledger_version=self.ledger.version)
            return None
        with self._lock:
            self._borrowed[host] = url
            self.borrows_total += 1
            self.policy.action_taken(now)
            self.last_event = {"event": "borrow", "host": host,
                               "reason": reason, "url": url,
                               "ledger_version": lease["version"],
                               "duration_s": round(self._clock() - t0, 3)}
        self._event(**self.last_event)
        return "borrow"

    def _rollback_borrow(self, host: str, url: Optional[str],
                         shrunk: bool) -> None:
        """Best-effort unwind so the ledger never claims a state the pod
        is not in; each step is independently fail-soft."""
        try:
            if url and self._release is not None:
                self._release(host, url)
        except Exception:  # vtx: ignore[VTX106] unwind is best-effort by design
            pass
        try:
            if self.ledger.owner_of(host) == "serve":
                self.ledger.assign(host, "train")
        except Exception:  # vtx: ignore[VTX106] unwind is best-effort by design
            pass
        try:
            if shrunk and self.train is not None:
                self._resize_train(self.train.process_count + 1)
        except Exception as e:  # noqa: BLE001 - training down after a failed borrow is the loudest case
            self._event(event="rollback_failed", host=host,
                        detail=f"{type(e).__name__}: {e}")

    def _do_return(self, reason: str, now: float) -> Optional[str]:
        with self._lock:
            if not self._borrowed:
                return None
            host, url = next(reversed(self._borrowed.items()))
        self._event(event="return_start", host=host, reason=reason,
                    ledger_version=self.ledger.version)
        t0 = self._clock()
        try:
            if url and self._fleet_release is not None:
                self._fleet_release(url)   # router: retire -> drain to zero
            if url and self._release is not None:
                self._release(host, url)   # agent: SIGTERM-drain the process
            lease = self.ledger.assign(host, "train")
            if self.train is not None:
                self._resize_train(self.train.process_count + 1)
        except Exception as e:  # noqa: BLE001 - a failed return keeps the loan; next tick retries
            with self._lock:
                self.policy.action_taken(now)
            self._event(event="return_failed", host=host, reason=reason,
                        detail=f"{type(e).__name__}: {e}",
                        ledger_version=self.ledger.version)
            return None
        with self._lock:
            self._borrowed.pop(host, None)
            self.returns_total += 1
            self.policy.action_taken(now)
            self.last_event = {"event": "return", "host": host,
                               "reason": reason, "url": url,
                               "ledger_version": lease["version"],
                               "duration_s": round(self._clock() - t0, 3)}
        self._event(**self.last_event)
        return "return"

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        assert self._thread is None, "arbiter loop already running"
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="vitax-torch-arbiter")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 - the loop must survive
                print(f"[vitax_torch.arbiter] tick failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # a tick mid-borrow blocks on the train drain; bound the join
            # by the grace window it could be waiting out
            grace = (self.train.term_grace_s if self.train is not None
                     else DEFAULT_TRAIN_GRACE_S)
            self._thread.join(timeout=grace + self.interval_s * 4 + 5.0)
            self._thread = None

    # -- observability ---------------------------------------------------------

    def metrics(self) -> dict:
        with self._lock:
            out = {"borrows_total": self.borrows_total,
                   "returns_total": self.returns_total,
                   "denies_total": self.denies_total,
                   "requests_total": self.requests_total,
                   "borrowed": dict(self._borrowed),
                   "last_event": self.last_event,
                   "train_telemetry": self._train_telemetry,
                   "policy": self.policy.snapshot()}
        out["ledger"] = self.ledger.snapshot()
        if self.train is not None:
            out["train_processes"] = self.train.process_count
            out["train_alive"] = self.train.alive()
        return out

    def _event(self, **payload) -> None:
        if self.recorder is not None:
            try:
                self.recorder.event(EVENT_KIND, **payload)
            except Exception:  # vtx: ignore[VTX106] telemetry must not kill arbitration
                pass


class FleetSignals:
    """Pull-based pressure signals from the fleet router's GET /metrics,
    shaped for ArbiterPolicy: shed rate between pulls plus the same
    predicted-wait formula the autoscaler scales on (depth * EWMA service
    over discounted capacity vs the admission deadline). Fail-soft: an
    unreachable fleet reads as zero pressure, never as an error."""

    def __init__(self, fleet_url: str,
                 timeout_s: float = 5.0,
                 http_json: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.fleet_url = fleet_url.rstrip("/")
        self.timeout_s = timeout_s
        self._http_json = http_json or default_http_json
        self._clock = clock
        self._last_shed: Optional[int] = None
        self._last_time: Optional[float] = None

    def __call__(self) -> dict:
        try:
            snap = self._http_json(self.fleet_url + "/metrics", None,
                                   self.timeout_s)
        except Exception:  # noqa: BLE001 - an unreachable fleet is zero pressure, not a crash
            return {}
        now = self._clock()
        adm = snap.get("admission") or {}
        fleet = snap.get("fleet") or {}
        shed_total = int(adm.get("shed_total", 0))
        rate = 0.0
        if self._last_shed is not None and now > self._last_time:
            rate = max(shed_total - self._last_shed, 0) \
                / (now - self._last_time)
        self._last_shed, self._last_time = shed_total, now
        overshoot = False
        ewma = adm.get("ewma_service_s")
        deadline = (adm.get("deadline_ms") or 0.0) / 1000.0
        if ewma and deadline > 0:
            frac = adm.get("warming_capacity_frac", 0.5)
            capacity = (fleet.get("ready", 0)
                        + frac * fleet.get("warming", 0))
            predicted = fleet.get("in_flight", 0) * ewma \
                / max(capacity, 1e-9)
            overshoot = predicted >= deadline
        return {"shed_rate_per_s": rate,
                "predicted_wait_overshoot": overshoot}


# -- HTTP surface --------------------------------------------------------------

def _make_handler(arbiter: Arbiter):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: A003
            pass

        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
            if self.path == "/ledger":
                self._reply(200, arbiter.ledger.snapshot())
            elif self.path == "/metrics":
                self._reply(200, arbiter.metrics())
            elif self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
            except ValueError as e:
                self._reply(400, {"error": f"bad JSON body: {e}"})
                return
            if self.path == "/request":
                self._reply(200, arbiter.request_capacity(
                    str(payload.get("reason", ""))))
            elif self.path == "/telemetry":
                self._reply(200, arbiter.observe_train(payload))
            elif self.path == "/policy":
                # gated hard, chaos-endpoint style: flipping the pod's
                # arbitration mode is an operator action, not a default
                if not arbiter.allow_admin:
                    self._reply(403, {"error": "policy endpoint disabled "
                                      "(start with --arbiter_allow_admin)"})
                    return
                try:
                    self._reply(200, arbiter.set_policy(
                        str(payload.get("policy", ""))))
                except ValueError as e:
                    self._reply(400, {"error": str(e)})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

    return Handler


def start_arbiter(arbiter: Arbiter, port: int = 0):
    """Bind the arbiter API (background threads) and start the decision
    loop. Returns the httpd; server_address[1] is the bound port."""
    httpd = ThreadingHTTPServer(("0.0.0.0", port), _make_handler(arbiter))
    httpd.daemon_threads = True
    thread = threading.Thread(  # vtx: ignore[VTX205] stop_arbiter's httpd.shutdown() ends serve_forever
        target=httpd.serve_forever, daemon=True, name="vitax-torch-arbiter-http")
    thread.start()
    arbiter.start()
    return httpd


def stop_arbiter(httpd, arbiter: Arbiter) -> None:
    httpd.shutdown()
    httpd.server_close()
    arbiter.stop()
