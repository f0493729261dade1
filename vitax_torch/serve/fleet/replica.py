"""ReplicaManager: spawn or adopt N serve replicas and rotate them on
their health (vitax/serve/fleet/replica.py).

Each replica is one `python -m vitax_torch.serve` engine on its own port.
- **spawn or adopt**: `manage()` starts a replica process and owns it
  (restart with capped exponential backoff after a death, SIGTERM drain on
  stop, both through vitax_torch/supervise.py's `backoff_delay` and
  `terminate_child`); `adopt()` registers an endpoint started elsewhere,
  health-checked but never restarted.
- **rotation**: only READY replicas take traffic. The health loop polls
  `GET /healthz`: `ready: false` (warming, draining) or `fail_threshold`
  failed polls in a row eject a replica, a live and ready poll re-admits
  it; a restarted process re-enters rotation only once warmed.
- **load**: the router's least-loaded pick reads each replica's in-flight
  count and EWMA latency, kept by `acquire()` / `release()`.

Lifecycle records (kinds replica_spawn, replica_exit, replica_restart,
replica_eject, replica_admit, replica_retire, replica_discard) go to the
Recorder when one is attached. The `replica_health` fault site fires once a
probe in sweep order. `spawn`, `http_get`, `sleep`, `clock` and the
jitter's `rng` are injectable for tests.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence

from vitax_torch import faults
from vitax_torch.supervise import backoff_delay, terminate_child

STARTING = "starting"   # spawned or adopted, live but not warmed yet
READY = "ready"         # in rotation: /healthz answered ready: true
EJECTED = "ejected"     # live but out of rotation (failing or not ready)
DEAD = "dead"           # managed process exited; awaiting backoff and respawn

DEFAULT_HEALTH_INTERVAL_S = 0.5
DEFAULT_HEALTH_TIMEOUT_S = 5.0
DEFAULT_FAIL_THRESHOLD = 2
DEFAULT_BACKOFF_S = 0.5
DEFAULT_BACKOFF_MAX_S = 30.0
DEFAULT_MAX_RESTARTS = 10
DEFAULT_TERM_GRACE_S = 30.0
DEFAULT_EWMA_ALPHA = 0.2
DEFAULT_HEALTH_JITTER = 0.2  # +-20% a sweep on the health interval


def http_get_json(url: str, timeout: float) -> dict:
    """The default health and metrics probe."""
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.load(resp)


class Replica:
    """One serve endpoint and its rotation and load state; the owning
    manager's lock guards every mutable field."""

    def __init__(self, name: str, url: str, argv: Optional[Sequence[str]] = None, proc=None):
        self.name = name
        self.url = url.rstrip("/")
        self.argv = list(argv) if argv is not None else None
        self.proc = proc                 # None for adopted replicas
        self.state = STARTING
        self.retired = False             # scale-in: out of rotation for good
        self.ever_ready = False          # admitted at least once (a later death is not a startup failure)
        self.startup_exit: Optional[int] = None    # exit code of a death before the first admission
        self.in_flight = 0
        self.ewma_latency_s: Optional[float] = None
        self.requests_total = 0
        self.dispatch_failures = 0       # the router's failed dispatches
        self.health_failures = 0         # failed health polls in a row
        self.restarts = 0
        self.exit_code: Optional[int] = None
        self.restart_not_before = 0.0    # the backoff's clock gate
        self.last_health: dict = {}

    @property
    def managed(self) -> bool:
        return self.argv is not None

    def snapshot(self) -> dict:
        return {"url": self.url, "state": self.state, "retired": self.retired, "managed": self.managed,
                "in_flight": self.in_flight,
                "ewma_latency_s": round(self.ewma_latency_s, 6) if self.ewma_latency_s is not None else None,
                "requests_total": self.requests_total, "dispatch_failures": self.dispatch_failures,
                "health_failures": self.health_failures, "restarts": self.restarts, "exit_code": self.exit_code}


class ReplicaManager:
    """The fleet's rotation and lifecycle."""

    def __init__(self, recorder=None, health_interval_s: float = DEFAULT_HEALTH_INTERVAL_S,
                 health_timeout_s: float = DEFAULT_HEALTH_TIMEOUT_S, fail_threshold: int = DEFAULT_FAIL_THRESHOLD,
                 backoff_s: float = DEFAULT_BACKOFF_S, backoff_max_s: float = DEFAULT_BACKOFF_MAX_S,
                 max_restarts: int = DEFAULT_MAX_RESTARTS, term_grace_s: float = DEFAULT_TERM_GRACE_S,
                 ewma_alpha: float = DEFAULT_EWMA_ALPHA, health_jitter: float = DEFAULT_HEALTH_JITTER,
                 spawn: Optional[Callable] = None, http_get: Optional[Callable[[str, float], dict]] = None,
                 sleep: Callable[[float], None] = time.sleep, clock: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None):
        if fail_threshold < 1 or max_restarts < 0 or not 0.0 <= health_jitter < 1.0:
            raise ValueError(f"fail_threshold {fail_threshold} must be >= 1, max_restarts {max_restarts} >= 0 "
                             f"and health_jitter {health_jitter} in [0, 1)")
        self.recorder = recorder
        self.health_interval_s = health_interval_s
        self.health_timeout_s = health_timeout_s
        self.fail_threshold = fail_threshold
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.max_restarts = max_restarts
        self.term_grace_s = term_grace_s
        self.ewma_alpha = ewma_alpha
        self.health_jitter = health_jitter
        self._rng = rng or random.Random()
        self.replicas: List[Replica] = []
        self._name_seq = 0               # monotonic: a discard never recycles a name
        self.restart_total = 0
        self.started = time.time()
        self._lock = threading.Lock()
        self._spawn = spawn or (lambda argv: subprocess.Popen(argv))
        self._http_get = http_get or http_get_json
        self._sleep = sleep
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- registration --------------------------------------------------------

    def _next_name(self, name: Optional[str]) -> str:
        with self._lock:
            name = name or f"replica_{self._name_seq}"
            self._name_seq += 1
        return name

    def manage(self, argv: Sequence[str], url: str, name: Optional[str] = None) -> Replica:
        """Spawn a replica process and own its lifecycle."""
        name = self._next_name(name)
        replica = Replica(name, url, argv=argv, proc=self._spawn(list(argv)))
        with self._lock:
            self.replicas.append(replica)
        self._event("replica_spawn", replica=name, url=url)
        return replica

    def adopt(self, url: str, name: Optional[str] = None) -> Replica:
        """Register a replica started elsewhere: rotated, never restarted."""
        name = self._next_name(name)
        replica = Replica(name, url)
        with self._lock:
            self.replicas.append(replica)
        self._event("replica_spawn", replica=name, url=url, adopted=True)
        return replica

    # -- rotation and load ---------------------------------------------------

    def ready_replicas(self) -> List[Replica]:
        with self._lock:
            return [r for r in self.replicas if r.state == READY and not r.retired]

    def ready_count(self) -> int:
        return len(self.ready_replicas())

    def warming_count(self) -> int:
        """Live replicas still warming (STARTING), not retired: admission
        counts them at its warming fraction."""
        with self._lock:
            return sum(1 for r in self.replicas if r.state == STARTING and not r.retired)

    def active_count(self) -> int:
        """The fleet's size for scaling: every replica not retired."""
        with self._lock:
            return sum(1 for r in self.replicas if not r.retired)

    def total_in_flight(self) -> int:
        with self._lock:
            return sum(r.in_flight for r in self.replicas)

    def in_flight_of(self, replica: Replica) -> int:
        with self._lock:
            return replica.in_flight

    def find(self, name: str) -> Optional[Replica]:
        with self._lock:
            return next((r for r in self.replicas if r.name == name), None)

    def degraded_count(self) -> int:
        """Replicas whose last /healthz said degraded: true (brownout)."""
        with self._lock:
            return sum(1 for r in self.replicas if bool(r.last_health.get("degraded")))

    def degraded_seconds(self) -> float:
        """Each replica's advertised degraded_seconds at its last poll, summed."""
        with self._lock:
            return round(sum(float(r.last_health.get("degraded_seconds") or 0.0) for r in self.replicas), 3)

    def acquire(self, exclude: Sequence[str] = ()) -> Optional[Replica]:
        """Least-loaded pick: the READY replica with the fewest requests in
        flight, ties to the lower EWMA latency; counts one in flight there.
        Pair every acquire with a release()."""
        with self._lock:
            candidates = [r for r in self.replicas if r.state == READY and not r.retired and r.name not in exclude]
            if not candidates:
                return None
            best = min(candidates, key=lambda r: (r.in_flight, r.ewma_latency_s or 0.0))
            best.in_flight += 1
            return best

    def release(self, replica: Replica, latency_s: Optional[float] = None, ok: bool = True,
                counted: bool = True) -> None:
        """Pair of acquire(); `counted=False` undoes it without a success or
        a failure (a picked replica handed back unused)."""
        with self._lock:
            replica.in_flight = max(replica.in_flight - 1, 0)
            if not counted:
                return
            if ok:
                replica.requests_total += 1
                if latency_s is not None:
                    prev = replica.ewma_latency_s
                    replica.ewma_latency_s = (latency_s if prev is None else
                                              self.ewma_alpha * latency_s + (1.0 - self.ewma_alpha) * prev)
            else:
                replica.dispatch_failures += 1

    # -- scale-in ------------------------------------------------------------

    def retire(self, replica: Replica) -> None:
        """Out of rotation for good (scale-in step 1); what it has in
        flight drains. Pair with discard() once in_flight is zero."""
        with self._lock:
            if replica.retired:
                return
            replica.retired = True
            if replica.state == READY:
                replica.state = EJECTED
        self._event("replica_retire", replica=replica.name)

    def discard(self, replica: Replica) -> Optional[int]:
        """Remove a replica (scale-in step 2): a live managed process is
        SIGTERM-drained through terminate_child. Returns its exit code (None
        for an adopted replica)."""
        rc = None
        if replica.proc is not None and replica.proc.poll() is None:
            rc = terminate_child(replica.proc, self.term_grace_s, sleep=self._sleep)
        with self._lock:
            replica.state = DEAD
            replica.retired = True
            if rc is not None:
                replica.exit_code = rc
            if replica in self.replicas:
                self.replicas.remove(replica)
        self._event("replica_discard", replica=replica.name, exit_code=rc)
        return rc

    # -- health loop ----------------------------------------------------------

    def poll_once(self, now: Optional[float] = None) -> None:
        """One health sweep in registration order (the loop calls it every
        interval, tests directly); retired replicas are skipped."""
        now = self._clock() if now is None else now
        with self._lock:
            fleet = [r for r in self.replicas if not r.retired]
        for replica in fleet:
            self._poll_replica(replica, now)

    def _poll_replica(self, r: Replica, now: float) -> None:
        if r.proc is not None:
            rc = r.proc.poll()
            if rc is not None:
                self._handle_dead(r, rc, now)
                return
        try:
            faults.fire("replica_health")      # sweep order: index k*N + i is replica i
            payload = self._http_get(r.url + "/healthz", self.health_timeout_s)
            live = payload.get("status") == "ok"
            ready = bool(payload.get("ready", True))       # no "ready" key: live means routable
        except Exception:  # noqa: BLE001 - any probe failure means not live
            payload, live, ready = {}, False, False
        if live and ready:
            with self._lock:
                previous, r.state = r.state, READY
                r.ever_ready = True
                r.health_failures = 0
                r.last_health = payload
            if previous != READY:
                self._event("replica_admit", replica=r.name, previous_state=previous)
        elif live:
            # warming or draining: out of rotation but alive, not a failure
            with self._lock:
                previous = r.state
                if r.state == READY:
                    r.state = EJECTED
                r.health_failures = 0
                r.last_health = payload
            if previous == READY:
                self._event("replica_eject", replica=r.name, reason="not_ready")
        else:
            with self._lock:
                r.health_failures += 1
                eject = r.state == READY and r.health_failures >= self.fail_threshold
                if eject:
                    r.state = EJECTED
                failures = r.health_failures
            if eject:
                self._event("replica_eject", replica=r.name, reason=f"{failures} consecutive healthz failures")

    def _handle_dead(self, r: Replica, rc: int, now: float) -> None:
        with self._lock:
            first = r.state != DEAD
            if first:
                r.state = DEAD
                r.in_flight = 0
                r.exit_code = rc
                r.health_failures = 0
                r.restart_not_before = now + backoff_delay(r.restarts + 1, self.backoff_s, self.backoff_max_s)
                if not r.ever_ready:
                    r.startup_exit = rc
        if first:
            self._event("replica_exit", replica=r.name, exit_code=rc, restarts=r.restarts)
            return
        if r.restarts >= self.max_restarts or now < r.restart_not_before:
            return
        proc = self._spawn(list(r.argv))
        with self._lock:
            r.proc = proc
            r.state = STARTING       # re-warms; re-admitted through /healthz
            r.restarts += 1
            r.exit_code = None
            self.restart_total += 1
            restart = r.restarts
        self._event("replica_restart", replica=r.name, restart=restart)

    def startup_failures(self) -> Dict[str, int]:
        """{name: exit code} of replicas that died before their first admission."""
        with self._lock:
            return {r.name: r.startup_exit for r in self.replicas if r.startup_exit is not None}

    def start(self) -> None:
        """Launch the background health loop."""
        if self._thread is not None:
            raise RuntimeError("health loop already running")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="vitax-torch-fleet-health")
        self._thread.start()

    def _next_interval(self) -> float:
        """The jittered sleep before the next sweep, uniform in
        health_interval_s * [1 - jitter, 1 + jitter]: managers started
        together do not probe in step."""
        if self.health_jitter <= 0.0:
            return self.health_interval_s
        spread = self.health_jitter * (2.0 * self._rng.random() - 1.0)
        return self.health_interval_s * (1.0 + spread)

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self._next_interval()):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 - the health loop must survive
                print(f"[vitax_torch.fleet] health sweep failed: {type(e).__name__}: {e}", file=sys.stderr,
                      flush=True)

    def stop(self) -> None:
        """Stop the health loop, then SIGTERM-drain every managed replica
        (its drain answers what is in flight and exits 0)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.health_interval_s * 4 + 5.0)
            self._thread = None
        with self._lock:
            fleet = list(self.replicas)
        for r in fleet:
            if r.proc is not None and r.proc.poll() is None:
                rc = terminate_child(r.proc, self.term_grace_s, sleep=self._sleep)
                with self._lock:
                    r.state = DEAD
                    r.exit_code = rc
                self._event("replica_exit", replica=r.name, exit_code=rc, drained=True)

    # -- observability ---------------------------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        """Each replica's rotation and load state, for the router's /metrics."""
        uptime = max(time.time() - self.started, 1e-9)
        with self._lock:
            out = {}
            for r in self.replicas:
                snap = r.snapshot()
                snap["requests_per_sec"] = round(r.requests_total / uptime, 3)
                out[r.name] = snap
            return out

    def _event(self, kind: str, **payload) -> None:
        if self.recorder is not None:
            try:
                self.recorder.event(kind, **payload)
            except Exception:  # vtx: ignore[VTX106] telemetry must not kill the fleet
                pass
